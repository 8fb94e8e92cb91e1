// BLS12-381 kernels of the batch verify, for Hopper (sm_90a).
//
// Built by lighthouse_tpu_torch/ops/cuda_build.py into a plain-C shared
// library and bound with ctypes (lighthouse_tpu_torch/crypto/
// pairing_kernel.py, htc_kernel.py).  Each entry launches on the caller's
// stream and returns cudaGetLastError().  Planes are the JAX package's
// boundary layout: int32 tensors of 16-bit Montgomery limbs, one 32-row
// block per Fq element, one lane per column.
//
// Kernel                   replaces (lighthouse_tpu/crypto/)
// lh_hash_g2_kernel        htc_kernel.py _hash_g2_kernel (pallas_call :285)
// lh_sigma_ladder_kernel + pairing_kernel.py _sigma_kernel (:1001)
//   lh_sigma_fold_kernel
// lh_miller_fold_kernel    pairing_kernel.py _miller_fold_kernel (:938)
// lh_finalize_kernel       pairing_kernel.py _finalize_easy_kernel +
//                          _finalize_hard_kernel (:1165, :1173)
// lh_sigma_combine_kernel  pairing_kernel.py sigma_combine (:1021, XLA glue,
//                          no pallas_call)
// lh_prepare_kernel        pairing_kernel.py _prepare_kernel (:1240)
// lh_product_chunks_kernel pairing_kernel.py _product_chunk_kernel (:877)
// lh_miller_kernel         pairing_kernel.py _miller_kernel (:781)
// lh_product_kernel        pairing_kernel.py _product_kernel (:843)
//
// What bounds them: integer multiply-adds.  Each is a long chain of
// 13-word Montgomery products (fp_mul) per lane with a few kilobytes of
// state, so the rate bound is the Montgomery products the work needs times
// the instructions per product over the INT32 issue rate; the bytes moved
// are tiny.  Where a kernel's critical path is one dependent chain its
// chain bound (the path in products, independent products of a step
// counted once, times the latency of one dependent product) is the larger.
// The reference's formulas run in the reference's order in every design.
//
// sigma_combine runs each partial's chain (about 600-900 products) on one
// thread (ladders rolled, tower functions __noinline__).
//
// Thread groups sharing each tower step (the cooperative phases of
// bls381_field.cuh): each step's independent Montgomery products run as one
// wave on the group's threads, its additions as item phases, then the
// group's barrier.  finalize is one 256-thread group (the block): each step
// of its 983-product chain costs a wave, not 54 products in a row.
// Miller+fold, the Miller loop alone, hash-to-G2, the sigma ladder,
// prepare and product_chunks run one small group per lane pair, message,
// lane, set or output lane (LH_*_G threads; several groups a block, enough
// blocks for every SM at the general path's sizes), so their many
// independent chains fill the card and each chain is a few hundred waves;
// the product butterfly runs a block per residue class mod 128, a group
// per lane of the class:
//   lh_miller_fold_kernel replaces _miller_fold_kernel (pairing_kernel.py
//     :893, pallas_call :938).  Rate bound at 1280 lanes (1025 live) 1.02
//     ms; chain bound 268 products (four waves a doubling step, three an
//     addition step, the fold), about 0.40 ms, which binds at the shared
//     path's 2 live lanes.
//   lh_miller_kernel replaces _miller_kernel (pairing_kernel.py :742,
//     pallas_call :781): Miller+fold's load phase and loop on lanes 2p and
//     2p + 1 (every lane live), both values stored.  Rate bound at 1024
//     lanes 1.02 ms; chain bound 267 products (about 0.40 ms).
//   lh_product_kernel replaces _product_kernel (pairing_kernel.py :811,
//     pallas_call :843): 128 blocks, class t's R = M/128 lanes in shared
//     memory, each butterfly level one wave of 54 products a lane (a
//     64-thread group a lane) and the block's barrier.  Rate bound 54 M
//     log2(R) products (0.0049 ms at 512 lanes); chain bound log2(R)
//     dependent products (2 at 512 lanes, about 0.003 ms): like
//     product_chunks, the loads, waves, post phases and launch set its time.
//   lh_product_chunks_kernel replaces _product_chunk_kernel
//     (pairing_kernel.py :853, pallas_call :877): one Fq12 product a
//     group, its 54 Montgomery products as one wave.  Its rate bound (54
//     products an output lane, 0.0018 ms at 384 output lanes) and chain
//     bound (one dependent product, about 0.0015 ms) sit below a launch:
//     the load, one wave, the post phases and the launch set its time.
//   lh_hash_g2_kernel replaces _hash_g2_kernel (htc_kernel.py :247,
//     pallas_call :285).  Chain bound 2,288 products (about 3.4 ms), which
//     binds at both paths' sizes (the rate bound prices the plain version's
//     distinct messages only); its two Fermat ladders (2 x 610 products)
//     stay one thread's serial chain.
//   lh_sigma_ladder_kernel + lh_sigma_fold_kernel replace _sigma_kernel
//     (pairing_kernel.py :969, pallas_call :1001): a 32-thread group per
//     lane runs its 64-bit ladder (acc + base beside base + base, two waves
//     of 36 products a bit), then a cluster of 8 blocks per 128-lane chunk
//     runs the butterfly over distributed shared memory (7 steps of two
//     waves; on one block the chunk's 32k products would sit on one SM's
//     issue, about 0.38 ms).  Rate bound 0.44 ms at C = 8 (the waves' 36
//     products use 36 of 64 thread slots, so the issue is about 1.8x it);
//     chain bound 142 products (about 0.21 ms).
//   lh_prepare_kernel replaces _prepare_kernel (pairing_kernel.py :1198,
//     pallas_call :1240): a 16-thread group per set, two sets a warp: K
//     in-order G1 additions (two waves of 6 products, the next key fetched
//     meanwhile), the 64-bit ladder (two waves of 12 a bit), the Fermat
//     inversion on one thread.  Chain bound 2K + 739 products (771, about
//     1.15 ms, at K = 16; 1,763 at the block batch's K = 512), 79% of it the
//     Fermat ladder at K = 16: the chain binds, not the rate (0.21 ms).
// product_chunks moves the most bytes per product (two Fq12 in, one out:
// 4.6 KB per 54 Montgomery products) and is still bound by operations.

#include <cuda_runtime.h>

#include "bls381_field.cuh"

#define LANE_BLOCK 128

// --- hash to G2: one group of G threads per message -------------------------
// hash_g2_body (bls381_field.cuh): u0 and u1 side by side through SSWU and
// the isogeny, then q0 + q1, cofactor clearing and the affine point, each
// step one wave of products; the group's state sits in shared memory
// (HashShared, one per group); groups of 32 sync on __syncwarp, groups of
// 64 or 128 on named barriers 1..15.
template <int G>
__global__ void __launch_bounds__(LH_GROUP_BLOCK_MAX)
lh_hash_g2_kernel(const int32_t* __restrict__ u, int32_t* __restrict__ out,
                  long long m2) {
  extern __shared__ __align__(16) unsigned char lh_group_smem[];
  const int gi = threadIdx.x / G, groups = blockDim.x / G;
  hash_g2_body(GroupRun<G>{(int)threadIdx.x % G, groups == 1 ? 0 : 1 + gi},
               reinterpret_cast<HashShared*>(lh_group_smem)[gi], u, out, m2,
               (long long)blockIdx.x * groups + gi);
}

// --- sigma: one group of G threads per lane, then a cluster per chunk -------
// sigma_ladder_body (bls381_field.cuh): the lane's masked point times its
// 64-bit RLC scalar, acc + base and base + base as one pair of waves a bit;
// the state sits in shared memory (SigmaLane, one per group).  The ladder
// values go to ``out``; lh_sigma_fold_kernel then folds each chunk there.
template <int G>
__global__ void __launch_bounds__(LH_GROUP_BLOCK_MAX)
lh_sigma_ladder_kernel(const int32_t* __restrict__ sig,
                       const int32_t* __restrict__ mask,
                       const int32_t* __restrict__ lo,
                       const int32_t* __restrict__ hi, int32_t* out,
                       long long m) {
  extern __shared__ __align__(16) unsigned char lh_group_smem[];
  const int gi = threadIdx.x / G, groups = blockDim.x / G;
  sigma_ladder_body(GroupRun<G>{(int)threadIdx.x % G, groups == 1 ? 0 : 1 + gi},
                    reinterpret_cast<SigmaLane*>(lh_group_smem)[gi], sig, mask,
                    lo, hi, out, m, (long long)blockIdx.x * groups + gi);
}

// The butterfly of each 128-lane chunk in place on ``out``: a cluster of
// LH_SIGMA_CLUSTER blocks (one chunk), LH_SIGMA_FOLD_LANES lanes a block in
// its shared memory; each step's additions read the partner lanes from the
// cluster's other blocks (distributed shared memory), one pair of waves
// over the block's threads, then the cluster's barrier (sigma_fold_cluster).
__global__ void __cluster_dims__(LH_SIGMA_CLUSTER, 1, 1)
__launch_bounds__(LH_SIGMA_FOLD_THREADS)
lh_sigma_fold_kernel(int32_t* out, long long m) {
  __shared__ SigmaFoldShared sh;
  sigma_fold_cluster(sh, out, m);
}

// --- Miller loop + masked fold: one group of G threads per lane pair ---------
// miller_fold_body (bls381_field.cuh): pair (j, j + 128) of a cell, both
// live lanes' doubling and addition steps as shared waves (a dead lane
// skips its loop and is ONE), then f_j * f_{j+128}; the state sits in
// shared memory (MillerShared, one per group).  At most 128 registers, so
// four 128-thread blocks fit an SM.
template <int G>
__global__ void __launch_bounds__(LH_GROUP_BLOCK_MAX, 2)
lh_miller_fold_kernel(const int32_t* __restrict__ g1,
                      const int32_t* __restrict__ g2,
                      const int32_t* __restrict__ mask, int32_t* out,
                      long long m) {
  extern __shared__ __align__(16) unsigned char lh_group_smem[];
  const int gi = threadIdx.x / G, groups = blockDim.x / G;
  miller_fold_body(GroupRun<G>{(int)threadIdx.x % G, groups == 1 ? 0 : 1 + gi},
                   reinterpret_cast<MillerShared*>(lh_group_smem)[gi], g1, g2,
                   mask, out, m, (long long)blockIdx.x * groups + gi);
}

// --- finalize: one block of LH_COOP_THREADS threads sharing the tower -------
// finalize_body (bls381_field.cuh): the 128 lanes sit in shared memory;
// every Fq12 step is a few phases between barriers, each Montgomery
// product of a step on its own thread (54 per Fq12 product, 8 products per
// step of the fold), so each of the ~360 dependent steps of the hard part
// costs one product wave (plus additions and barriers), not 54 products.
// The Fermat inversion of the easy part stays one thread's serial chain.
__global__ void __launch_bounds__(LH_COOP_THREADS)
lh_finalize_kernel(const int32_t* __restrict__ f, int32_t* ok, int32_t* g) {
  extern __shared__ __align__(16) unsigned char lh_fin_smem[];
  finalize_body(GroupRun<LH_COOP_THREADS>{(int)threadIdx.x, 0},
                *reinterpret_cast<FinShared*>(lh_fin_smem), f, ok, g);
}

// --- sigma_combine: a thread per partial --------------------------------------
// Thread t folds partial t's C chunk sums and writes its affine column and
// identity flag (sigma_combine_lane); the shared path's two partials run
// side by side in one warp.
__global__ void lh_sigma_combine_kernel(const int32_t* __restrict__ p0,
                                        const int32_t* __restrict__ p1,
                                        int32_t* __restrict__ cols,
                                        unsigned char* __restrict__ flags,
                                        long long m) {
  const int t = threadIdx.x;
  flags[t] = (unsigned char)sigma_combine_lane(
      t ? p1 : p0, m, (int)(m / LANE_BLOCK), cols + t * 4 * LH_ROWS);
}

// --- prepare: one sub-warp group of G threads per set ------------------------
// prepare_body (bls381_field.cuh): set s of chunk c reads key k at column
// (c*K + k)*128 + s: the K slots summed in k order from the identity, the
// identity flag, the 64-bit RLC ladder, and the affine point c_i * aggpk_i;
// G = 8 or 16 puts several sets in one warp (__syncwarp over the group's
// lanes), its state in shared memory (PrepShared, one per group).
template <int G>
__global__ void __launch_bounds__(LH_GROUP_BLOCK_MAX)
lh_prepare_kernel(const int32_t* __restrict__ pk,
                  const int32_t* __restrict__ kmask,
                  const int32_t* __restrict__ lo, const int32_t* __restrict__ hi,
                  int32_t* __restrict__ out, int32_t* __restrict__ flags,
                  long long m, int K) {
  extern __shared__ __align__(16) unsigned char lh_group_smem[];
  const int gi = threadIdx.x / G, groups = blockDim.x / G;
  prepare_body(GroupRun<G>{(int)threadIdx.x % G, groups == 1 ? 0 : 1 + gi},
               reinterpret_cast<PrepShared*>(lh_group_smem)[gi], pk, kmask, lo,
               hi, out, flags, m, K, (long long)blockIdx.x * groups + gi);
}

// --- product_chunks: one group of G threads per output lane ------------------
// product_pair_body (bls381_field.cuh): output lane j of chunk c is the
// masked f_{c*256+j} * f_{c*256+j+128}, one wave of its 54 products over
// the group; the operands and the wave's values sit in shared memory
// (PairShared, one per group).
template <int G>
__global__ void __launch_bounds__(LH_GROUP_BLOCK_MAX)
lh_product_chunks_kernel(const int32_t* __restrict__ f,
                         const int32_t* __restrict__ mask, int32_t* out,
                         long long m) {
  extern __shared__ __align__(16) unsigned char lh_group_smem[];
  const int gi = threadIdx.x / G, groups = blockDim.x / G;
  product_pair_body(GroupRun<G>{(int)threadIdx.x % G, groups == 1 ? 0 : 1 + gi},
                    reinterpret_cast<PairShared*>(lh_group_smem)[gi], f, mask,
                    out, m, (long long)blockIdx.x * groups + gi);
}

// --- Miller loop alone: one group of G threads per lane pair ----------------
// miller_body (bls381_field.cuh): lanes 2p and 2p + 1, both live, through
// Miller+fold's load phase and loop (MillerShared, one per group), then
// both conjugated values stored.  Miller+fold's register cap.
template <int G>
__global__ void __launch_bounds__(LH_GROUP_BLOCK_MAX, 2)
lh_miller_kernel(const int32_t* __restrict__ g1,
                 const int32_t* __restrict__ g2, int32_t* out, long long m) {
  extern __shared__ __align__(16) unsigned char lh_group_smem[];
  const int gi = threadIdx.x / G, groups = blockDim.x / G;
  miller_body(GroupRun<G>{(int)threadIdx.x % G, groups == 1 ? 0 : 1 + gi},
              reinterpret_cast<MillerShared*>(lh_group_smem)[gi], g1, g2, out,
              m, (long long)blockIdx.x * groups + gi);
}

// --- product: the roll butterfly, a block per residue class mod 128 ---------
// product_class_body (bls381_field.cuh): the class's lanes in shared
// memory, double-buffered; each level one wave of the Fq12 products over
// groups of G threads (K lanes a group's wave), then the block's barrier.
template <int G, int K>
__global__ void __launch_bounds__(LH_PRODUCT_GROUPS_MAX * G)
lh_product_kernel(const int32_t* __restrict__ f,
                  const int32_t* __restrict__ mask, int32_t* out,
                  long long m) {
  product_classes<G, K>(f, mask, out, m);
}

// --- probe: one Montgomery product per lane ----------------------------------
__global__ void lh_fp_mul_kernel(const int32_t* __restrict__ a,
                                 const int32_t* __restrict__ b,
                                 int32_t* __restrict__ out, long long n) {
  const long long lane = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= n) return;
  store_fp(out, n, lane, 0, fp_mul(load_fp(a, n, lane, 0), load_fp(b, n, lane, 0)));
}

// --- probe: a dependent chain of n Montgomery products on one thread --------
// x <- x * y, n times, with x and y the two lanes of a (32, 2) block: the
// latency of one dependent product, which prices the finalize's chain.
__global__ void lh_fp_mul_chain_kernel(const int32_t* __restrict__ xy,
                                       int32_t* __restrict__ out, int n) {
  Fp x = load_fp(xy, 2, 0, 0);
  const Fp y = load_fp(xy, 2, 1, 0);
#pragma unroll 1
  for (int i = 0; i < n; ++i) x = fp_mul(x, y);
  store_fp(out, 1, 0, 0, x);
}

// --- C entries ---------------------------------------------------------------

extern "C" {

int lh_bls_init(const void* host_consts, int nwords) {
  if ((size_t)nwords * 4 != sizeof(BlsConsts)) return -2;
  cudaError_t e = cudaMemcpyToSymbol(KC, host_consts, sizeof(BlsConsts));
  return (int)(e != cudaSuccess ? e : cudaGetLastError());
}

}  // extern "C"

// One group of G threads per work item (n of them), ``groups`` a block,
// each with its Shared state in dynamic shared memory.  Named barriers
// allow 15 groups of more than 32 threads a block; groups of 32 threads or
// fewer sync on __syncwarp.
template <class Shared, int G, int groups, class... P, class... A>
static int launch_groups(void (*kernel)(P...), long long n, void* stream,
                         A... args) {
  static_assert(G * groups <= LH_GROUP_BLOCK_MAX && (G <= 32 || groups <= 15),
                "launch shape");
  if (n % groups != 0) return (int)cudaErrorInvalidValue;
  const int bytes = groups * (int)sizeof(Shared);   // above 48 KB: opt in
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return (int)e;
  kernel<<<(unsigned)(n / groups), G * groups, bytes, (cudaStream_t)stream>>>(
      args...);
  return (int)cudaGetLastError();
}

extern "C" {

int lh_hash_g2(const int32_t* u, int32_t* out, long long m2, void* stream) {
  return launch_groups<HashShared, LH_HASH_G, LH_HASH_GROUPS>(   // a group
      lh_hash_g2_kernel<LH_HASH_G>, m2 / 2, stream, u, out, m2); // a message
}

int lh_sigma(const int32_t* sig, const int32_t* mask, const int32_t* lo,
             const int32_t* hi, int32_t* out, long long m, void* stream) {
  const int e = launch_groups<SigmaLane, LH_SIGMA_G, LH_SIGMA_GROUPS>(
      lh_sigma_ladder_kernel<LH_SIGMA_G>, m, stream,   // a group a lane
      sig, mask, lo, hi, out, m);
  if (e != 0) return e;
  lh_sigma_fold_kernel<<<(unsigned)(m / LH_SIGMA_FOLD_LANES),
                         LH_SIGMA_FOLD_THREADS, 0, (cudaStream_t)stream>>>(
      out, m);
  return (int)cudaGetLastError();
}

int lh_miller_fold(const int32_t* g1, const int32_t* g2, const int32_t* mask,
                   int32_t* out, long long m, void* stream) {
  return launch_groups<MillerShared, LH_MILLER_G, LH_MILLER_GROUPS>(
      lh_miller_fold_kernel<LH_MILLER_G>, m / 2, stream,   // a lane pair
      g1, g2, mask, out, m);
}

// A group kernel's launch shape (which: 0 Miller+fold, 1 hash-to-G2, 2 the
// sigma ladder, 3 prepare, 4 the sigma butterfly, whose group is its block
// of a cluster, 5 product_chunks, 6 the Miller loop alone, 7 the product
// butterfly, whose groups a block is its most: R/K at M = 128R) and what
// ptxas gave it: info = {threads a group, groups a block, shared bytes a
// group, registers a thread, local (stack) bytes a thread, input lanes a
// group, blocks a cluster}.
int lh_group_kernel_info(int which, int* info) {
  static const int shape[8][5] = {
      {LH_MILLER_G, LH_MILLER_GROUPS, (int)sizeof(MillerShared), 2, 1},
      {LH_HASH_G, LH_HASH_GROUPS, (int)sizeof(HashShared), 2, 1},
      {LH_SIGMA_G, LH_SIGMA_GROUPS, (int)sizeof(SigmaLane), 1, 1},
      {LH_PREP_G, LH_PREP_GROUPS, (int)sizeof(PrepShared), 1, 1},
      {LH_SIGMA_FOLD_THREADS, 1, (int)sizeof(SigmaFoldShared),
       LH_SIGMA_FOLD_LANES, LH_SIGMA_CLUSTER},
      {LH_PCHUNK_G, LH_PCHUNK_GROUPS, (int)sizeof(PairShared), 2, 1},
      {LH_MLOOP_G, LH_MLOOP_GROUPS, (int)sizeof(MillerShared), 2, 1},
      {LH_PRODUCT_G, LH_PRODUCT_GROUPS_MAX,
       (int)sizeof(ProductWave<LH_PRODUCT_LANES>), LH_PRODUCT_LANES, 1}};
  if (which < 0 || which > 7) return (int)cudaErrorInvalidValue;
  cudaFuncAttributes a;
  cudaError_t e =
      which == 0   ? cudaFuncGetAttributes(&a, lh_miller_fold_kernel<LH_MILLER_G>)
      : which == 1 ? cudaFuncGetAttributes(&a, lh_hash_g2_kernel<LH_HASH_G>)
      : which == 2 ? cudaFuncGetAttributes(&a, lh_sigma_ladder_kernel<LH_SIGMA_G>)
      : which == 3 ? cudaFuncGetAttributes(&a, lh_prepare_kernel<LH_PREP_G>)
      : which == 4 ? cudaFuncGetAttributes(&a, lh_sigma_fold_kernel)
      : which == 5 ? cudaFuncGetAttributes(&a, lh_product_chunks_kernel<LH_PCHUNK_G>)
      : which == 6 ? cudaFuncGetAttributes(&a, lh_miller_kernel<LH_MLOOP_G>)
      : cudaFuncGetAttributes(
            &a, lh_product_kernel<LH_PRODUCT_G, LH_PRODUCT_LANES>);
  if (e != cudaSuccess) return (int)e;
  for (int i = 0; i < 3; ++i) info[i] = shape[which][i];
  info[3] = a.numRegs;
  info[4] = (int)a.localSizeBytes;
  info[5] = shape[which][3];
  info[6] = shape[which][4];
  return 0;
}

int lh_finalize(const int32_t* f, int32_t* ok, int32_t* g, void* stream) {
  const int bytes = (int)sizeof(FinShared);   // above 48 KB: opt in
  cudaError_t e = cudaFuncSetAttribute(
      lh_finalize_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return (int)e;
  lh_finalize_kernel<<<1, LH_COOP_THREADS, bytes, (cudaStream_t)stream>>>(
      f, ok, g);
  return (int)cudaGetLastError();
}

int lh_sigma_combine(const int32_t* p0, const int32_t* p1, int32_t* cols,
                     unsigned char* flags, long long m, int n, void* stream) {
  lh_sigma_combine_kernel<<<1, n, 0, (cudaStream_t)stream>>>(p0, p1, cols,
                                                            flags, m);
  return (int)cudaGetLastError();
}

int lh_prepare(const int32_t* pk, const int32_t* kmask, const int32_t* lo,
               const int32_t* hi, int32_t* out, int32_t* flags, long long m,
               int K, void* stream) {
  return launch_groups<PrepShared, LH_PREP_G, LH_PREP_GROUPS>(
      lh_prepare_kernel<LH_PREP_G>, m, stream,   // a group a set
      pk, kmask, lo, hi, out, flags, m, K);
}

int lh_product_chunks(const int32_t* f, const int32_t* mask, int32_t* out,
                      long long m, void* stream) {
  return launch_groups<PairShared, LH_PCHUNK_G, LH_PCHUNK_GROUPS>(
      lh_product_chunks_kernel<LH_PCHUNK_G>, m / 2, stream,   // a group an
      f, mask, out, m);                                         // output lane
}

int lh_miller(const int32_t* g1, const int32_t* g2, int32_t* out, long long m,
              void* stream) {
  return launch_groups<MillerShared, LH_MLOOP_G, LH_MLOOP_GROUPS>(
      lh_miller_kernel<LH_MLOOP_G>, m / 2, stream,   // a lane pair
      g1, g2, out, m);
}

int lh_product(const int32_t* f, const int32_t* mask, int32_t* out,
               long long m, void* stream) {
  return launch_product<LH_PRODUCT_G, LH_PRODUCT_LANES>(
      lh_product_kernel<LH_PRODUCT_G, LH_PRODUCT_LANES>, f, mask, out, m,
      stream);
}

int lh_fp_mul_chain(const int32_t* xy, int32_t* out, int n, void* stream) {
  lh_fp_mul_chain_kernel<<<1, 1, 0, (cudaStream_t)stream>>>(xy, out, n);
  return (int)cudaGetLastError();
}

int lh_fp_mul(const int32_t* a, const int32_t* b, int32_t* out, long long n,
              void* stream) {
  lh_fp_mul_kernel<<<(unsigned)((n + 127) / 128), 128, 0,
                     (cudaStream_t)stream>>>(a, b, out, n);
  return (int)cudaGetLastError();
}

}  // extern "C"
