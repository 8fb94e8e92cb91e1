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
// lh_sigma_kernel          pairing_kernel.py _sigma_kernel (:1001)
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
// One thread per lane: sigma, prepare, product_chunks and the unfused
// Miller kernel (ladders rolled, tower functions __noinline__); the product
// butterfly runs 128 threads, one per residue class mod 128; sigma_combine
// runs each partial's chain (about 600-900 products) on one thread.
//
// Thread groups sharing each tower step (the cooperative phases of
// bls381_field.cuh): each step's independent Montgomery products run as one
// wave on the group's threads, its additions as item phases, then the
// group's barrier.  finalize is one 256-thread group (the block): each step
// of its 983-product chain costs a wave, not 54 products in a row.
// Miller+fold and hash-to-G2 run one small group per lane pair or message
// (LH_MILLER_G, LH_HASH_G threads; several groups a block, enough blocks
// for every SM at the general path's sizes), so their many independent
// chains fill the card and each chain is a few hundred waves:
//   lh_miller_fold_kernel replaces _miller_fold_kernel (pairing_kernel.py
//     :893, pallas_call :938).  Rate bound at 1280 lanes (1025 live) 1.02
//     ms; chain bound 268 products (four waves a doubling step, three an
//     addition step, the fold), about 0.40 ms, which binds at the shared
//     path's 2 live lanes.
//   lh_hash_g2_kernel replaces _hash_g2_kernel (htc_kernel.py :247,
//     pallas_call :285).  Chain bound 2,288 products (about 3.4 ms), which
//     binds at both paths' sizes (the rate bound prices the plain version's
//     distinct messages only); its two Fermat ladders (2 x 610 products)
//     stay one thread's serial chain.
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

// --- sigma: one 128-lane chunk per block -------------------------------------
// Masked point, 64-bit RLC ladder, then the butterfly: for w = 64 ... 1,
// lane j adds lane (j + w) mod 128, exchanged through shared memory.
__global__ void __launch_bounds__(LANE_BLOCK)
lh_sigma_kernel(const int32_t* __restrict__ sig,
                const int32_t* __restrict__ mask,
                const int32_t* __restrict__ lo, const int32_t* __restrict__ hi,
                int32_t* __restrict__ out, long long m) {
  __shared__ G2P pts[LANE_BLOCK];
  const int tid = threadIdx.x;
  const long long lane = (long long)blockIdx.x * LANE_BLOCK + tid;
  G2P p = g2_identity();
  if (mask[lane] != 0)
    p = {load_fp2(sig, m, lane, 0), load_fp2(sig, m, lane, 2), fp2_one()};
  G2P acc = sigma_ladder(p, (uint32_t)lo[lane], (uint32_t)hi[lane]);
  for (int w = LANE_BLOCK / 2; w >= 1; w >>= 1) {
    pts[tid] = acc;
    __syncthreads();
    const G2P other = pts[(tid + w) & (LANE_BLOCK - 1)];
    __syncthreads();
    acc = g2_add(acc, other);
  }
  store_fp2(out, m, lane, 0, acc.X);
  store_fp2(out, m, lane, 2, acc.Y);
  store_fp2(out, m, lane, 4, acc.Z);
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

// --- prepare: one block per 128-set chunk, a thread per set -----------------
// Set s of chunk c reads key k at column (c*K + k)*128 + s: the K slots
// summed from the identity, the identity flag, the 64-bit RLC ladder, and
// the affine point c_i * aggpk_i (prepare_set).
__global__ void __launch_bounds__(LANE_BLOCK)
lh_prepare_kernel(const int32_t* __restrict__ pk,
                  const int32_t* __restrict__ kmask,
                  const int32_t* __restrict__ lo, const int32_t* __restrict__ hi,
                  int32_t* __restrict__ out, int32_t* __restrict__ flags,
                  long long m, int K) {
  const int tid = threadIdx.x;
  const long long lane = (long long)blockIdx.x * LANE_BLOCK + tid;
  const long long col = (long long)blockIdx.x * K * LANE_BLOCK + tid;
  Fp xa, ya;
  flags[lane] = prepare_set(pk, kmask, m * K, col, LANE_BLOCK, K,
                            (uint32_t)lo[lane], (uint32_t)hi[lane], xa, ya);
  store_fp(out, m, lane, 0, xa);
  store_fp(out, m, lane, 1, ya);
}

// --- product_chunks: one block per 256-lane chunk, a thread per output lane --
// Output lane j of chunk c is the masked f_{c*256+j} * f_{c*256+j+128}.
__global__ void __launch_bounds__(LANE_BLOCK)
lh_product_chunks_kernel(const int32_t* __restrict__ f,
                         const int32_t* __restrict__ mask,
                         int32_t* __restrict__ out, long long m) {
  const int tid = threadIdx.x;
  const long long a = (long long)blockIdx.x * 2 * LANE_BLOCK + tid;
  const Fp12 fa = fp12_masked(f, mask, m, a);
  const Fp12 fb = fp12_masked(f, mask, m, a + LANE_BLOCK);
  store_fp12(out, m / 2, (long long)blockIdx.x * LANE_BLOCK + tid,
             fp12_mul(fa, fb));
}

// --- Miller loop alone: one block per 128 lanes, a thread per lane -----------
__global__ void __launch_bounds__(LANE_BLOCK)
lh_miller_kernel(const int32_t* __restrict__ g1,
                 const int32_t* __restrict__ g2, int32_t* __restrict__ out,
                 long long m) {
  const long long lane = (long long)blockIdx.x * LANE_BLOCK + threadIdx.x;
  store_fp12(out, m, lane,
             miller_loop(load_fp(g1, m, lane, 0), load_fp(g1, m, lane, 1),
                         load_fp2(g2, m, lane, 0), load_fp2(g2, m, lane, 2)));
}

// --- product: the roll butterfly, a thread per residue class mod 128 ---------
// A class never reads another (every roll is a multiple of 128 lanes), so
// the 128 threads run their classes alone through M-lane global scratch.
__global__ void __launch_bounds__(LANE_BLOCK)
lh_product_kernel(const int32_t* __restrict__ f,
                  const int32_t* __restrict__ mask, Fp12* a, Fp12* b,
                  int32_t* __restrict__ out, long long m) {
  product_class(f, mask, a, b, out, m, threadIdx.x);
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
// allow 15 groups of more than 32 threads a block.
template <class Shared, int G, int groups, class... P, class... A>
static int launch_groups(void (*kernel)(P...), long long n, void* stream,
                         A... args) {
  static_assert(G * groups <= LH_GROUP_BLOCK_MAX && (G == 32 || groups <= 15),
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
  lh_sigma_kernel<<<(unsigned)(m / LANE_BLOCK), LANE_BLOCK, 0,
                    (cudaStream_t)stream>>>(sig, mask, lo, hi, out, m);
  return (int)cudaGetLastError();
}

int lh_miller_fold(const int32_t* g1, const int32_t* g2, const int32_t* mask,
                   int32_t* out, long long m, void* stream) {
  return launch_groups<MillerShared, LH_MILLER_G, LH_MILLER_GROUPS>(
      lh_miller_fold_kernel<LH_MILLER_G>, m / 2, stream,   // a lane pair
      g1, g2, mask, out, m);
}

// A group kernel's launch shape (which: 0 Miller+fold, 1 hash-to-G2) and
// what ptxas gave it: info = {threads a group, groups a block, shared
// bytes a group, registers a thread, local (stack) bytes a thread}.
int lh_group_kernel_info(int which, int* info) {
  cudaFuncAttributes a;
  cudaError_t e =
      which ? cudaFuncGetAttributes(&a, lh_hash_g2_kernel<LH_HASH_G>)
            : cudaFuncGetAttributes(&a, lh_miller_fold_kernel<LH_MILLER_G>);
  if (e != cudaSuccess) return (int)e;
  info[0] = which ? LH_HASH_G : LH_MILLER_G;
  info[1] = which ? LH_HASH_GROUPS : LH_MILLER_GROUPS;
  info[2] = which ? (int)sizeof(HashShared) : (int)sizeof(MillerShared);
  info[3] = a.numRegs;
  info[4] = (int)a.localSizeBytes;
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
  lh_prepare_kernel<<<(unsigned)(m / LANE_BLOCK), LANE_BLOCK, 0,
                      (cudaStream_t)stream>>>(pk, kmask, lo, hi, out, flags,
                                              m, K);
  return (int)cudaGetLastError();
}

int lh_product_chunks(const int32_t* f, const int32_t* mask, int32_t* out,
                      long long m, void* stream) {
  lh_product_chunks_kernel<<<(unsigned)(m / (2 * LANE_BLOCK)), LANE_BLOCK, 0,
                             (cudaStream_t)stream>>>(f, mask, out, m);
  return (int)cudaGetLastError();
}

int lh_miller(const int32_t* g1, const int32_t* g2, int32_t* out, long long m,
              void* stream) {
  lh_miller_kernel<<<(unsigned)(m / LANE_BLOCK), LANE_BLOCK, 0,
                     (cudaStream_t)stream>>>(g1, g2, out, m);
  return (int)cudaGetLastError();
}

int lh_product(const int32_t* f, const int32_t* mask, int32_t* scratch,
               int32_t* out, long long m, void* stream) {
  Fp12* a = reinterpret_cast<Fp12*>(scratch);
  lh_product_kernel<<<1, LANE_BLOCK, 0, (cudaStream_t)stream>>>(
      f, mask, a, a + m, out, m);
  return (int)cudaGetLastError();
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
