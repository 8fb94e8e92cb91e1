// SHA-256 Merkle kernels for Hopper (sm_90a), with a plain C interface.
//
// Built by lighthouse_tpu_torch/ops/cuda_build.py:
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o build/kernels/libsha256_merkle-<hash>.so
// and loaded with ctypes.  Every pointer is a raw device address, every
// digest is 8 big-endian u32 words (the words of hash32_concat), and every
// C entry launches on the stream it is given and returns cudaGetLastError().
//
// Both kernels are bounded by integer ALU work, not memory: one hash64 is
// two SHA-256 compressions, some 2,400 to 2,700 integer instructions per
// 96 bytes moved (two 32-byte inputs read, one 32-byte digest written).
// The first design is the simple one: one thread per hash, the message
// schedule in a rolling 16-word register window, every round unrolled.
// Packing several hashes per thread, or the SHA-NI-style interleaving of
// independent chains, is later work.

#include <cuda_runtime.h>
#include <stdint.h>

// Round constants (FIPS 180-4).
__constant__ uint32_t kK[64] = {
    0x428A2F98u, 0x71374491u, 0xB5C0FBCFu, 0xE9B5DBA5u, 0x3956C25Bu, 0x59F111F1u,
    0x923F82A4u, 0xAB1C5ED5u, 0xD807AA98u, 0x12835B01u, 0x243185BEu, 0x550C7DC3u,
    0x72BE5D74u, 0x80DEB1FEu, 0x9BDC06A7u, 0xC19BF174u, 0xE49B69C1u, 0xEFBE4786u,
    0x0FC19DC6u, 0x240CA1CCu, 0x2DE92C6Fu, 0x4A7484AAu, 0x5CB0A9DCu, 0x76F988DAu,
    0x983E5152u, 0xA831C66Du, 0xB00327C8u, 0xBF597FC7u, 0xC6E00BF3u, 0xD5A79147u,
    0x06CA6351u, 0x14292967u, 0x27B70A85u, 0x2E1B2138u, 0x4D2C6DFCu, 0x53380D13u,
    0x650A7354u, 0x766A0ABBu, 0x81C2C92Eu, 0x92722C85u, 0xA2BFE8A1u, 0xA81A664Bu,
    0xC24B8B70u, 0xC76C51A3u, 0xD192E819u, 0xD6990624u, 0xF40E3585u, 0x106AA070u,
    0x19A4C116u, 0x1E376C08u, 0x2748774Cu, 0x34B0BCB5u, 0x391C0CB3u, 0x4ED8AA4Au,
    0x5B9CCA4Fu, 0x682E6FF3u, 0x748F82EEu, 0x78A5636Fu, 0x84C87814u, 0x8CC70208u,
    0x90BEFFFAu, 0xA4506CEBu, 0xBEF9A3F7u, 0xC67178F2u,
};

// W[i] + K[i] of the constant second block of a 64-byte message (0x80,
// zeros, bit length 512): ops/sha256.py _PAD64_KW, the same table.
__constant__ uint32_t kPad64KW[64] = {
    0xC28A2F98u, 0x71374491u, 0xB5C0FBCFu, 0xE9B5DBA5u, 0x3956C25Bu, 0x59F111F1u,
    0x923F82A4u, 0xAB1C5ED5u, 0xD807AA98u, 0x12835B01u, 0x243185BEu, 0x550C7DC3u,
    0x72BE5D74u, 0x80DEB1FEu, 0x9BDC06A7u, 0xC19BF374u, 0x649B69C1u, 0xF0FE4786u,
    0x0FE1EDC6u, 0x240CF254u, 0x4FE9346Fu, 0x6CC984BEu, 0x61B9411Eu, 0x16F988FAu,
    0xF2C65152u, 0xA88E5A6Du, 0xB019FC65u, 0xB9D99EC7u, 0x9A1231C3u, 0xE70EEAA0u,
    0xFDB1232Bu, 0xC7353EB0u, 0x3069BAD5u, 0xCB976D5Fu, 0x5A0F118Fu, 0xDC1EEEFDu,
    0x0A35B689u, 0xDE0B7A04u, 0x58F4CA9Du, 0xE15D5B16u, 0x007F3E86u, 0x37088980u,
    0xA507EA32u, 0x6FAB9537u, 0x17406110u, 0x0D8CD6F1u, 0xCDAA3B6Du, 0xC0BBBE37u,
    0x83613BDAu, 0xDB48A363u, 0x0B02E931u, 0x6FD15CA7u, 0x521AFACAu, 0x31338431u,
    0x6ED41A95u, 0x6D437890u, 0xC39C91F2u, 0x9ECCABBDu, 0xB5C9A0E6u, 0x532FB63Cu,
    0xD2C741C6u, 0x07237EA3u, 0xA4954B68u, 0x4C191D76u,
};

__device__ __forceinline__ uint32_t rotr(uint32_t x, int n) {
  return __funnelshift_r(x, x, n);
}

#define SHA_ROUND(kw)                                                   \
  do {                                                                  \
    uint32_t s1_ = rotr(e, 6) ^ rotr(e, 11) ^ rotr(e, 25);              \
    uint32_t ch_ = (e & f) ^ (~e & g);                                  \
    uint32_t t1_ = h + s1_ + ch_ + (kw);                                \
    uint32_t s0_ = rotr(a, 2) ^ rotr(a, 13) ^ rotr(a, 22);              \
    uint32_t maj_ = (a & b) ^ (a & c) ^ (b & c);                        \
    h = g; g = f; f = e; e = d + t1_;                                   \
    d = c; c = b; b = a; a = t1_ + s0_ + maj_;                          \
  } while (0)

// hash32_concat of the 64-byte block m[0..16) (left digest, right digest):
// the data-block compression from the IV, then the padding-block
// compression against the precomputed W+K.  Everything stays in registers.
__device__ __forceinline__ void hash64_words(const uint32_t m[16],
                                             uint32_t out[8]) {
  uint32_t w[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) w[i] = m[i];
  uint32_t a = 0x6A09E667u, b = 0xBB67AE85u, c = 0x3C6EF372u,
           d = 0xA54FF53Au, e = 0x510E527Fu, f = 0x9B05688Cu,
           g = 0x1F83D9ABu, h = 0x5BE0CD19u;
#pragma unroll
  for (int i = 0; i < 64; ++i) {
    uint32_t wi;
    if (i < 16) {
      wi = w[i];
    } else {
      uint32_t x15 = w[(i - 15) & 15], x2 = w[(i - 2) & 15];
      uint32_t s0 = rotr(x15, 7) ^ rotr(x15, 18) ^ (x15 >> 3);
      uint32_t s1 = rotr(x2, 17) ^ rotr(x2, 19) ^ (x2 >> 10);
      wi = w[i & 15] + s0 + w[(i - 7) & 15] + s1;
      w[i & 15] = wi;
    }
    SHA_ROUND(kK[i] + wi);
  }
  const uint32_t m0 = 0x6A09E667u + a, m1 = 0xBB67AE85u + b,
                 m2 = 0x3C6EF372u + c, m3 = 0xA54FF53Au + d,
                 m4 = 0x510E527Fu + e, m5 = 0x9B05688Cu + f,
                 m6 = 0x1F83D9ABu + g, m7 = 0x5BE0CD19u + h;
  a = m0; b = m1; c = m2; d = m3; e = m4; f = m5; g = m6; h = m7;
#pragma unroll
  for (int i = 0; i < 64; ++i) SHA_ROUND(kPad64KW[i]);
  out[0] = m0 + a; out[1] = m1 + b; out[2] = m2 + c; out[3] = m3 + d;
  out[4] = m4 + e; out[5] = m5 + f; out[6] = m6 + g; out[7] = m7 + h;
}

// Batched hash32_concat.  Replaces the TPU kernel _hash64_pallas_kernel /
// hash64_pallas (lighthouse_tpu/ops/merkle_kernel.py:173-203).
//
// One thread per output digest: thread i hashes left row i with right row
// i into out row i.  Left and right are pointer + row stride (in words),
// so one kernel serves a tree level (cur[0::2] and cur[1::2] of one
// (2m, 8) array, stride 16) and two separate arrays (the pubkey pre-hash,
// stride 12 and 8).  Any n is taken; the tail block is masked.
//
// Bound: integer ALU.  96 bytes per hash against ~2,500 instructions
// means the memory system is idle next to the INT32 pipes; the design
// keeps both compressions in registers and reads each input word once.
extern "C" __global__ void __launch_bounds__(256)
lh_hash64_kernel(const uint32_t* __restrict__ left, long long lstride,
                 const uint32_t* __restrict__ right, long long rstride,
                 uint32_t* __restrict__ out, long long n) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  uint32_t m[16], dig[8];
  const uint32_t* l = left + i * lstride;
  const uint32_t* r = right + i * rstride;
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    m[k] = l[k];
    m[8 + k] = r[k];
  }
  hash64_words(m, dig);
  uint32_t* o = out + i * 8;
#pragma unroll
  for (int k = 0; k < 8; ++k) o[k] = dig[k];
}

// Chunk sub-tree roots.  Replaces the TPU kernel _subtree_kernel /
// chunk_roots (lighthouse_tpu/ops/merkle_kernel.py:123-170).
//
// One thread block per 2^chunk_log2-leaf chunk in natural leaf order,
// 2^(chunk_log2-1) threads.  Thread t hashes leaves (2t, 2t+1) straight
// from device memory into shared memory; the block then reduces level by
// level in shared memory (word planes: plane k holds word k of every
// node, so neighbouring threads touch neighbouring banks), with a barrier
// between the reads and the writes of a level, then writes the 8 words
// of the chunk root.  The TPU kernel's bit-reversed "halves"
// layout existed only because Mosaic has no strided lane access; here
// pairing is plain indexing, so leaves stay in natural order.
//
// Bound: integer ALU, as for hash64 (2^c - 1 hashes per 32 * 2^c bytes
// read).  Half the block idles at each level past the first, so the
// average lane occupancy of the reduction tail is ~1/c of the first
// level's; a later design can fold several chunks per block.
extern "C" __global__ void __launch_bounds__(512)
lh_subtree_kernel(const uint32_t* __restrict__ leaves,
                  uint32_t* __restrict__ roots, int chunk_log2) {
  extern __shared__ uint32_t planes[];  // 8 planes of `half` words
  const int half = 1 << (chunk_log2 - 1);
  const int t = threadIdx.x;
  const uint32_t* base =
      leaves + ((long long)blockIdx.x << chunk_log2) * 8 + 16LL * t;
  uint32_t m[16], dig[8];
#pragma unroll
  for (int k = 0; k < 16; ++k) m[k] = base[k];
  hash64_words(m, dig);
#pragma unroll
  for (int k = 0; k < 8; ++k) planes[k * half + t] = dig[k];
  __syncthreads();
  for (int width = half >> 1; width >= 1; width >>= 1) {
    const bool active = t < width;
    if (active) {
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        m[k] = planes[k * half + 2 * t];
        m[8 + k] = planes[k * half + 2 * t + 1];
      }
      hash64_words(m, dig);
    }
    __syncthreads();  // every read of this level lands before any write
    if (active) {
#pragma unroll
      for (int k = 0; k < 8; ++k) planes[k * half + t] = dig[k];
    }
    __syncthreads();
  }
  for (int k = t; k < 8; k += half) {
    roots[(long long)blockIdx.x * 8 + k] = planes[k * half];
  }
}

extern "C" int lh_hash64(const void* left, long long lstride,
                         const void* right, long long rstride, void* out,
                         long long n, void* stream) {
  if (n > 0) {
    const int threads = 256;
    const long long blocks = (n + threads - 1) / threads;
    lh_hash64_kernel<<<(unsigned int)blocks, threads, 0,
                       (cudaStream_t)stream>>>(
        (const uint32_t*)left, lstride, (const uint32_t*)right, rstride,
        (uint32_t*)out, n);
  }
  return (int)cudaGetLastError();
}

extern "C" int lh_subtree(const void* leaves, void* roots, long long n_chunks,
                          int chunk_log2, void* stream) {
  if (n_chunks > 0) {
    const int half = 1 << (chunk_log2 - 1);
    const size_t smem = 8u * (size_t)half * sizeof(uint32_t);
    lh_subtree_kernel<<<(unsigned int)n_chunks, half, smem,
                        (cudaStream_t)stream>>>(
        (const uint32_t*)leaves, (uint32_t*)roots, chunk_log2);
  }
  return (int)cudaGetLastError();
}
