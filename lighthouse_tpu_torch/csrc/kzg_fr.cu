// KZG blob evaluation for Hopper (sm_90a), with a plain C interface.
//
// Built by lighthouse_tpu_torch/ops/cuda_build.py like the other sources
// and loaded with ctypes by lighthouse_tpu_torch/kzg/device.py.  Every
// pointer is a raw device address; every element is 8 little-endian u32
// words of an Fr value below N (the field core is csrc/kzg_fr.cuh): f and
// the output canonical, z and the roots in Montgomery form (x * 2^256
// mod N; the roots stay resident, each z is converted once on the host).
// Every C entry launches on the stream it is given and returns
// cudaGetLastError().
//
// lh_kzg_eval replaces lighthouse_tpu/kzg/device.py:81 _eval_kernel, a
// jax.jit program (no pallas_call): for each blob i,
//
//   p_i(z_i) = (z_i^W - 1) / W * sum_j f_ij * w_j / (z_i - w_j)
//
// over the W roots of unity w_j, or f_ij where z_i = w_j.  Two launches:
//
// - lh_kzg_eval_kernel: a thread per element (blob i, root j), KZG_TPB
//   threads a block, W / KZG_TPB blocks a blob, so 6 blobs of 4096 spread
//   over 384 blocks and every SM.  Each thread inverts z - w by Fermat
//   (254 squarings and 163 products, a branch on a bit of the constant
//   N - 2 that every thread takes alike) and multiplies by f * w (two
//   products, the term canonical); the block sums its terms (and its hit
//   lane's f, and the hit flag) exactly mod N in shared memory and writes
//   one partial.
// - lh_kzg_eval_finish_kernel: a thread per blob sums its partials,
//   takes z^W by log2 W squarings, multiplies by (z^W - 1) * W^-1 and
//   selects the hit lane's f where z is a root.
//
// What bounds it: the dependent chain.  The function needs one inversion
// a blob (a batched inversion: some 5 products an element) and one
// inversion's chain of ~312 dependent products (a sliding-window ladder);
// this kernel runs a ladder an element instead, 419 products an element
// (10.3 M for 6 x 4096, some 80 times the least work), whose issue time
// is about as long as its own 432-product chain; every element has its
// own thread, spread over every SM, so the chains run side by side.  A batched inversion and a windowed ladder
// are later work (ROADMAP speed item 7(b)).  chip_smoke.py phase 16
// prints the kernel's time beside both bounds (PERF.md section 6).

#include <cuda_runtime.h>
#include <stdint.h>

#include "kzg_fr.cuh"

#define KZG_TPB 64        // threads (elements) a block
#define KZG_PARTIAL 17    // words of one block's partial: sum, hit f, flag

extern "C" __global__ void __launch_bounds__(KZG_TPB)
lh_kzg_eval_kernel(const uint32_t* __restrict__ f,
                   const uint32_t* __restrict__ z_mont,
                   const uint32_t* __restrict__ roots,
                   uint32_t* __restrict__ partial, long long width) {
  __shared__ Fr s_sum[KZG_TPB];
  __shared__ Fr s_hit[KZG_TPB];
  __shared__ uint32_t s_flag[KZG_TPB];
  const int t = threadIdx.x;
  const long long j = (long long)blockIdx.x * KZG_TPB + t;
  const long long b = blockIdx.y;
  Fr term = fr_zero(), fh = fr_zero();
  uint32_t flag = 0;
  if (j < width) {
    const Fr zm = fr_load(z_mont + b * KF_NW);
    const Fr fj = fr_load(f + (b * width + j) * KF_NW);
    bool hit;
    term = kzg_term(fj, fr_load(roots + j * KF_NW), zm, &hit);
    if (hit) {
      fh = fj;
      flag = 1;
    }
  }
  s_sum[t] = term;
  s_hit[t] = fh;
  s_flag[t] = flag;
  __syncthreads();
  for (int s = KZG_TPB / 2; s > 0; s >>= 1) {
    if (t < s) {
      s_sum[t] = fr_add(s_sum[t], s_sum[t + s]);
      s_hit[t] = fr_add(s_hit[t], s_hit[t + s]);
      s_flag[t] |= s_flag[t + s];
    }
    __syncthreads();
  }
  if (t == 0) {
    uint32_t* p = partial + (b * gridDim.x + blockIdx.x) * KZG_PARTIAL;
    fr_store(p, s_sum[0]);
    fr_store(p + KF_NW, s_hit[0]);
    p[2 * KF_NW] = s_flag[0];
  }
}

extern "C" __global__ void __launch_bounds__(32)
lh_kzg_eval_finish_kernel(const uint32_t* __restrict__ zm,
                          const uint32_t* __restrict__ partial,
                          uint32_t* __restrict__ out, long long blobs,
                          int blocks, int log2w) {
  const long long b = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= blobs) return;
  Fr sum = fr_zero(), fh = fr_zero();
  uint32_t flag = 0;
  for (int k = 0; k < blocks; ++k) {
    const uint32_t* p = partial + (b * blocks + k) * KZG_PARTIAL;
    sum = fr_add(sum, fr_load(p));
    fh = fr_add(fh, fr_load(p + KF_NW));
    flag |= p[2 * KF_NW];
  }
  fr_store(out + b * KF_NW,
           kzg_finish(sum, fh, flag != 0, fr_load(zm + b * KF_NW), log2w));
}

// One Fr product a*b/R mod N per lane: its SASS (cuobjdump) prices a
// product for the rate bound.  Nothing launches it.
extern "C" __global__ void __launch_bounds__(256)
lh_fr_mul_kernel(const uint32_t* __restrict__ a,
                 const uint32_t* __restrict__ b, uint32_t* __restrict__ out,
                 long long n) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  fr_store(out + i * KF_NW,
           fr_mul(fr_load(a + i * KF_NW), fr_load(b + i * KF_NW)));
}

// x <- x*y/R mod N, n dependent products on one thread: the latency probe
// that prices the chain bound.  No KZG path calls it.
extern "C" __global__ void lh_fr_mul_chain_kernel(
    const uint32_t* __restrict__ xy, uint32_t* __restrict__ out, int n) {
  Fr x = fr_load(xy), y = fr_load(xy + KF_NW);
  for (int k = 0; k < n; ++k) x = fr_mul(x, y);
  fr_store(out, x);
}

extern "C" int lh_kzg_eval(const void* f, const void* zm, const void* roots,
                           void* partial, void* out, long long blobs,
                           long long width, int log2w, int partial_blocks,
                           void* stream) {
  const long long blocks = (width + KZG_TPB - 1) / KZG_TPB;
  if (blobs <= 0 || width <= 0) return (int)cudaGetLastError();
  if (blocks != partial_blocks || blobs > 65535 ||
      (1LL << log2w) != width)
    return (int)cudaErrorInvalidValue;
  dim3 grid((unsigned int)blocks, (unsigned int)blobs);
  lh_kzg_eval_kernel<<<grid, KZG_TPB, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)f, (const uint32_t*)zm, (const uint32_t*)roots,
      (uint32_t*)partial, width);
  int rc = (int)cudaGetLastError();
  if (rc) return rc;
  lh_kzg_eval_finish_kernel<<<(unsigned int)((blobs + 31) / 32), 32, 0,
                              (cudaStream_t)stream>>>(
      (const uint32_t*)zm, (const uint32_t*)partial, (uint32_t*)out, blobs,
      (int)blocks, log2w);
  return (int)cudaGetLastError();
}

extern "C" int lh_kzg_threads(void) { return KZG_TPB; }

extern "C" int lh_fr_mul_chain(const void* xy, void* out, int n,
                               void* stream) {
  lh_fr_mul_chain_kernel<<<1, 1, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)xy, (uint32_t*)out, n);
  return (int)cudaGetLastError();
}
