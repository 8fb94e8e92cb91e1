// Tuning probe for the thread-group kernels of csrc/bls381.cu, for
// probe_group_kernels.py: the bodies of lh_miller_fold_kernel and
// lh_hash_g2_kernel at any launch shape (G = 32, 64 or 128 threads a
// group, several groups a block), under a runner that also stamps the SM
// clock (clock64) after every barrier of one group (group 0 of block 0)
// when given a stamp buffer; the sigma ladder (G = 16, 32 or 64, then the
// port's butterfly), prepare (G = 8, 16 or 32), product_chunks (G = 32 or
// 64), the Miller loop alone (G = 64 or 128) at any launch shape, the
// product butterfly at G = 32 or 64 threads a group and K = 1 or 2 lanes a
// group's wave; and the latency of one dependent Fq addition and
// subtraction.  The port
// never calls this library.

#include <cuda_runtime.h>

#include "bls381_field.cuh"

#define LH_STAMPS 4096   // stamps a buffer holds; the last slot gets the count

// GroupRun that also stamps the clock after each barrier, on thread 0 of a
// group whose ``stamps`` is set.
template <int G>
struct StampRun {
  static constexpr int G_ = G;
  GroupRun<G> run;
  long long* stamps;
  int* n;
  template <class F>
  __device__ __forceinline__ void operator()(F&& phase) const {
    run(phase);
    if (stamps && run.t == 0) stamps[(*n)++] = clock64();
  }
};

template <int G>
__device__ __forceinline__ StampRun<G> stamp_run(long long* stamps, int* n) {
  const int gi = threadIdx.x / G, groups = blockDim.x / G;
  return {{(int)threadIdx.x % G, groups == 1 ? 0 : 1 + gi},
          blockIdx.x == 0 && gi == 0 ? stamps : nullptr, n};
}

template <int G>
__global__ void __launch_bounds__(LH_GROUP_BLOCK_MAX, 2)   // as the kernel
lh_miller_fold_phases_kernel(const int32_t* g1, const int32_t* g2,
                             const int32_t* mask, int32_t* out, long long m,
                             long long* stamps) {
  extern __shared__ __align__(16) unsigned char lh_group_smem[];
  const int gi = threadIdx.x / G;
  int n = 0;
  const StampRun<G> run = stamp_run<G>(stamps, &n);
  if (run.stamps && threadIdx.x == 0) stamps[n++] = clock64();
  miller_fold_body(run, reinterpret_cast<MillerShared*>(lh_group_smem)[gi],
                   g1, g2, mask, out, m,
                   (long long)blockIdx.x * (blockDim.x / G) + gi);
  if (run.stamps && threadIdx.x == 0) stamps[LH_STAMPS - 1] = n;
}

template <int G>
__global__ void __launch_bounds__(LH_GROUP_BLOCK_MAX)
lh_hash_g2_phases_kernel(const int32_t* u, int32_t* out, long long m2,
                         long long* stamps) {
  extern __shared__ __align__(16) unsigned char lh_group_smem[];
  const int gi = threadIdx.x / G;
  int n = 0;
  const StampRun<G> run = stamp_run<G>(stamps, &n);
  if (run.stamps && threadIdx.x == 0) stamps[n++] = clock64();
  hash_g2_body(run, reinterpret_cast<HashShared*>(lh_group_smem)[gi], u, out,
               m2, (long long)blockIdx.x * (blockDim.x / G) + gi);
  if (run.stamps && threadIdx.x == 0) stamps[LH_STAMPS - 1] = n;
}

template <int G>
__global__ void __launch_bounds__(LH_GROUP_BLOCK_MAX)
lh_sigma_ladder_phases_kernel(const int32_t* sig, const int32_t* mask,
                              const int32_t* lo, const int32_t* hi,
                              int32_t* out, long long m) {
  extern __shared__ __align__(16) unsigned char lh_group_smem[];
  const int gi = threadIdx.x / G, groups = blockDim.x / G;
  sigma_ladder_body(GroupRun<G>{(int)threadIdx.x % G, groups == 1 ? 0 : 1 + gi},
                    reinterpret_cast<SigmaLane*>(lh_group_smem)[gi], sig, mask,
                    lo, hi, out, m, (long long)blockIdx.x * groups + gi);
}

__global__ void __cluster_dims__(LH_SIGMA_CLUSTER, 1, 1)
__launch_bounds__(LH_SIGMA_FOLD_THREADS)
lh_sigma_fold_phases_kernel(int32_t* out, long long m) {
  __shared__ SigmaFoldShared sh;
  sigma_fold_cluster(sh, out, m);
}

template <int G>
__global__ void __launch_bounds__(LH_GROUP_BLOCK_MAX)
lh_prepare_phases_kernel(const int32_t* pk, const int32_t* kmask,
                         const int32_t* lo, const int32_t* hi, int32_t* out,
                         int32_t* flags, long long m, int K) {
  extern __shared__ __align__(16) unsigned char lh_group_smem[];
  const int gi = threadIdx.x / G, groups = blockDim.x / G;
  prepare_body(GroupRun<G>{(int)threadIdx.x % G, 0},
               reinterpret_cast<PrepShared*>(lh_group_smem)[gi], pk, kmask, lo,
               hi, out, flags, m, K, (long long)blockIdx.x * groups + gi);
}

template <int G>
__global__ void __launch_bounds__(LH_GROUP_BLOCK_MAX)
lh_product_chunks_phases_kernel(const int32_t* f, const int32_t* mask,
                                int32_t* out, long long m) {
  extern __shared__ __align__(16) unsigned char lh_group_smem[];
  const int gi = threadIdx.x / G, groups = blockDim.x / G;
  product_pair_body(GroupRun<G>{(int)threadIdx.x % G, groups == 1 ? 0 : 1 + gi},
                    reinterpret_cast<PairShared*>(lh_group_smem)[gi], f, mask,
                    out, m, (long long)blockIdx.x * groups + gi);
}

template <int G>
__global__ void __launch_bounds__(LH_GROUP_BLOCK_MAX, 2)   // as the kernel
lh_miller_phases_kernel(const int32_t* g1, const int32_t* g2, int32_t* out,
                        long long m) {
  extern __shared__ __align__(16) unsigned char lh_group_smem[];
  const int gi = threadIdx.x / G, groups = blockDim.x / G;
  miller_body(GroupRun<G>{(int)threadIdx.x % G, groups == 1 ? 0 : 1 + gi},
              reinterpret_cast<MillerShared*>(lh_group_smem)[gi], g1, g2, out,
              m, (long long)blockIdx.x * groups + gi);
}

template <int G, int K>
__global__ void __launch_bounds__(LH_PRODUCT_GROUPS_MAX * G)
lh_product_phases_kernel(const int32_t* f, const int32_t* mask, int32_t* out,
                         long long m) {
  product_classes<G, K>(f, mask, out, m);
}

// One group per work item (n of them), ``groups`` a block of G threads.
template <class Shared, class... P, class... A>
static int launch_shape(void (*kernel)(P...), int G, int groups, long long n,
                        void* stream, A... args) {
  if (groups < 1 || G * groups > LH_GROUP_BLOCK_MAX || n % groups != 0 ||
      (G > 32 && groups > 15))
    return (int)cudaErrorInvalidValue;
  const int bytes = groups * (int)sizeof(Shared);
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return (int)e;
  kernel<<<(unsigned)(n / groups), G * groups, bytes, (cudaStream_t)stream>>>(
      args...);
  return (int)cudaGetLastError();
}

// n dependent fp_add (or fp_sub) on one thread; cycles[0] gets the clock
// cycles they took.
__global__ void lh_fp_add_chain_kernel(const int32_t* xy, int32_t* out, int n,
                                       int sub, long long* cycles) {
  Fp x = load_fp(xy, 2, 0, 0);
  const Fp y = load_fp(xy, 2, 1, 0);
  const long long t0 = clock64();
#pragma unroll 1
  for (int i = 0; i < n; ++i) x = sub ? fp_sub(x, y) : fp_add(x, y);
  cycles[0] = clock64() - t0;
  store_fp(out, 1, 0, 0, x);
}

extern "C" {

int lh_phases_init(const void* host_consts, int nwords) {
  if ((size_t)nwords * 4 != sizeof(BlsConsts)) return -2;
  cudaError_t e = cudaMemcpyToSymbol(KC, host_consts, sizeof(BlsConsts));
  return (int)(e != cudaSuccess ? e : cudaGetLastError());
}

// Miller+fold (one group per lane pair) and hash-to-G2 (one group per
// message) with groups of G threads (32, 64 or 128), ``groups`` a block;
// stamps: null, or LH_STAMPS slots for group 0's clock after each barrier.
int lh_miller_fold_phases(const int32_t* g1, const int32_t* g2,
                          const int32_t* mask, int32_t* out, long long m,
                          int G, int groups, long long* stamps,
                          void* stream) {
  auto go = [&](auto kernel) {
    return launch_shape<MillerShared>(kernel, G, groups, m / 2, stream, g1,
                                      g2, mask, out, m, stamps);
  };
  switch (G) {
    case 32: return go(lh_miller_fold_phases_kernel<32>);
    case 64: return go(lh_miller_fold_phases_kernel<64>);
    case 128: return go(lh_miller_fold_phases_kernel<128>);
  }
  return (int)cudaErrorInvalidValue;
}

int lh_hash_g2_phases(const int32_t* u, int32_t* out, long long m2, int G,
                      int groups, long long* stamps, void* stream) {
  auto go = [&](auto kernel) {
    return launch_shape<HashShared>(kernel, G, groups, m2 / 2, stream, u, out,
                                    m2, stamps);
  };
  switch (G) {
    case 32: return go(lh_hash_g2_phases_kernel<32>);
    case 64: return go(lh_hash_g2_phases_kernel<64>);
    case 128: return go(lh_hash_g2_phases_kernel<128>);
  }
  return (int)cudaErrorInvalidValue;
}

// The sigma ladder with groups of G threads (16, 32 or 64), ``groups`` a
// block, then the port's butterfly: the whole of lh_sigma.
int lh_sigma_phases(const int32_t* sig, const int32_t* mask, const int32_t* lo,
                    const int32_t* hi, int32_t* out, long long m, int G,
                    int groups, void* stream) {
  auto go = [&](auto kernel) {
    return launch_shape<SigmaLane>(kernel, G, groups, m, stream, sig, mask, lo,
                                   hi, out, m);
  };
  int e = (int)cudaErrorInvalidValue;
  switch (G) {
    case 16: e = go(lh_sigma_ladder_phases_kernel<16>); break;
    case 32: e = go(lh_sigma_ladder_phases_kernel<32>); break;
    case 64: e = go(lh_sigma_ladder_phases_kernel<64>); break;
  }
  if (e != 0) return e;
  lh_sigma_fold_phases_kernel<<<(unsigned)(m / LH_SIGMA_FOLD_LANES),
                                LH_SIGMA_FOLD_THREADS, 0,
                                (cudaStream_t)stream>>>(out, m);
  return (int)cudaGetLastError();
}

// Prepare with groups of G threads (8, 16 or 32), ``groups`` a block.
int lh_prepare_phases(const int32_t* pk, const int32_t* kmask,
                      const int32_t* lo, const int32_t* hi, int32_t* out,
                      int32_t* flags, long long m, int K, int G, int groups,
                      void* stream) {
  auto go = [&](auto kernel) {
    return launch_shape<PrepShared>(kernel, G, groups, m, stream, pk, kmask,
                                    lo, hi, out, flags, m, K);
  };
  switch (G) {
    case 8: return go(lh_prepare_phases_kernel<8>);
    case 16: return go(lh_prepare_phases_kernel<16>);
    case 32: return go(lh_prepare_phases_kernel<32>);
  }
  return (int)cudaErrorInvalidValue;
}

// product_chunks with groups of G threads (32 or 64), ``groups`` a block.
int lh_product_chunks_phases(const int32_t* f, const int32_t* mask,
                             int32_t* out, long long m, int G, int groups,
                             void* stream) {
  auto go = [&](auto kernel) {
    return launch_shape<PairShared>(kernel, G, groups, m / 2, stream, f, mask,
                                    out, m);
  };
  switch (G) {
    case 32: return go(lh_product_chunks_phases_kernel<32>);
    case 64: return go(lh_product_chunks_phases_kernel<64>);
  }
  return (int)cudaErrorInvalidValue;
}

// The Miller loop alone with groups of G threads (64 or 128), ``groups`` a
// block.
int lh_miller_phases(const int32_t* g1, const int32_t* g2, int32_t* out,
                     long long m, int G, int groups, void* stream) {
  auto go = [&](auto kernel) {
    return launch_shape<MillerShared>(kernel, G, groups, m / 2, stream, g1,
                                      g2, out, m);
  };
  switch (G) {
    case 64: return go(lh_miller_phases_kernel<64>);
    case 128: return go(lh_miller_phases_kernel<128>);
  }
  return (int)cudaErrorInvalidValue;
}

// The product butterfly with groups of G threads (32 or 64) taking K
// lanes (1 or 2) a wave; groups a block follow from m (product_shape).
int lh_product_phases(const int32_t* f, const int32_t* mask, int32_t* out,
                      long long m, int G, int K, void* stream) {
  if (G == 32 && K == 1)
    return launch_product<32, 1>(lh_product_phases_kernel<32, 1>, f, mask,
                                 out, m, stream);
  if (G == 32 && K == 2)
    return launch_product<32, 2>(lh_product_phases_kernel<32, 2>, f, mask,
                                 out, m, stream);
  if (G == 64 && K == 1)
    return launch_product<64, 1>(lh_product_phases_kernel<64, 1>, f, mask,
                                 out, m, stream);
  if (G == 64 && K == 2)
    return launch_product<64, 2>(lh_product_phases_kernel<64, 2>, f, mask,
                                 out, m, stream);
  return (int)cudaErrorInvalidValue;
}

int lh_fp_add_chain(const int32_t* xy, int32_t* out, int n, int sub,
                    long long* cycles, void* stream) {
  lh_fp_add_chain_kernel<<<1, 1, 0, (cudaStream_t)stream>>>(xy, out, n, sub,
                                                            cycles);
  return (int)cudaGetLastError();
}

}  // extern "C"
