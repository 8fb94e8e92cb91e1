// Fr (the BLS12-381 scalar field, N = r) for the port's KZG kernels
// (csrc/kzg_fr.cu).
//
// An element is 8 little-endian 32-bit words.  Products are CIOS
// Montgomery products with R = 2^256, the card's own domain: the JAX
// package keeps 17 16-bit limbs with R = 2^272 and lazy residues < 2N
// (lighthouse_tpu/kzg/fr_limb.py), which rests on 4N/R < 2^-15.  Here N
// > R/4, so that rule does not carry over: every sum and product is
// reduced below N.  The boundary of the kernels is therefore canonical
// values (each element < N, in words); the plain PyTorch version keeps
// the JAX limbs and meets the kernels in canonical values.
//
//   fr_add   a + b, minus N once if >= N (a, b < N; a + b < 2N < 2^256)
//   fr_sub   a - b, plus N on a borrow
//   fr_mul   (a*b + m*N) / R with m = -a*b/N mod R, < 2N for a, b < N,
//            then minus N once: canonical
//   fr_inv   a^(N-2), 254 squarings and 163 products along the bits of
//            N - 2 (the same in every thread, so the branch on a bit
//            never diverges); fr_inv(0) = 0, as the JAX program's
//
// The header compiles as CUDA (device functions, constants in
// __constant__ memory) and as plain C++ (host functions), so the
// per-element arithmetic can be run and tested without a GPU.

#pragma once
#include <stdint.h>

#if defined(__CUDACC__)
#define KF_FN __device__ __forceinline__
#define KF_CONST __constant__
#else
#define KF_FN static inline
#define KF_CONST static const
#endif

#define KF_NW 8
#define KF_EXP_TOP 254   // the top set bit of N - 2

struct Fr { uint32_t w[KF_NW]; };

// N, 2^512 mod N (to_mont), 2^256 mod N (Montgomery 1), N - 2 (the
// Fermat exponent), -N^-1 mod 2^32
KF_CONST uint32_t KF_N[KF_NW] = {
    0x00000001u, 0xffffffffu, 0xfffe5bfeu, 0x53bda402u,
    0x09a1d805u, 0x3339d808u, 0x299d7d48u, 0x73eda753u};
KF_CONST uint32_t KF_R2[KF_NW] = {
    0xf3f29c6du, 0xc999e990u, 0x87925c23u, 0x2b6cedcbu,
    0x7254398fu, 0x05d31496u, 0x9f59ff11u, 0x0748d9d9u};
KF_CONST uint32_t KF_R1[KF_NW] = {
    0xfffffffeu, 0x00000001u, 0x00034802u, 0x5884b7fau,
    0xecbc4ff5u, 0x998c4fefu, 0xacc5056fu, 0x1824b159u};
KF_CONST uint32_t KF_EXP[KF_NW] = {
    0xffffffffu, 0xfffffffeu, 0xfffe5bfeu, 0x53bda402u,
    0x09a1d805u, 0x3339d808u, 0x299d7d48u, 0x73eda753u};
#define KF_N0INV 0xffffffffu

KF_FN Fr fr_load(const uint32_t* p) {
  Fr a;
#pragma unroll
  for (int i = 0; i < KF_NW; ++i) a.w[i] = p[i];
  return a;
}

KF_FN void fr_store(uint32_t* p, const Fr& a) {
#pragma unroll
  for (int i = 0; i < KF_NW; ++i) p[i] = a.w[i];
}

KF_FN Fr fr_zero() {
  Fr a;
#pragma unroll
  for (int i = 0; i < KF_NW; ++i) a.w[i] = 0;
  return a;
}

KF_FN bool fr_is_zero(const Fr& a) {
  uint32_t acc = 0;
#pragma unroll
  for (int i = 0; i < KF_NW; ++i) acc |= a.w[i];
  return acc == 0;
}

// a - N where a >= N, else a (a < 2N)
KF_FN Fr fr_reduce_once(const Fr& a, uint32_t top) {
  Fr d;
  uint64_t borrow = 0;
#pragma unroll
  for (int i = 0; i < KF_NW; ++i) {
    uint64_t t = (uint64_t)a.w[i] - KF_N[i] - borrow;
    d.w[i] = (uint32_t)t;
    borrow = (t >> 32) & 1u;
  }
  // a >= N when the 257-bit value top:a does not borrow
  bool keep = (top == 0) && borrow;
  return keep ? a : d;
}

KF_FN Fr fr_add(const Fr& a, const Fr& b) {
  Fr s;
  uint64_t c = 0;
#pragma unroll
  for (int i = 0; i < KF_NW; ++i) {
    c += (uint64_t)a.w[i] + b.w[i];
    s.w[i] = (uint32_t)c;
    c >>= 32;
  }
  return fr_reduce_once(s, (uint32_t)c);
}

KF_FN Fr fr_sub(const Fr& a, const Fr& b) {
  Fr d;
  uint64_t borrow = 0;
#pragma unroll
  for (int i = 0; i < KF_NW; ++i) {
    uint64_t t = (uint64_t)a.w[i] - b.w[i] - borrow;
    d.w[i] = (uint32_t)t;
    borrow = (t >> 32) & 1u;
  }
  if (borrow) {
    uint64_t c = 0;
#pragma unroll
    for (int i = 0; i < KF_NW; ++i) {
      c += (uint64_t)d.w[i] + KF_N[i];
      d.w[i] = (uint32_t)c;
      c >>= 32;
    }
  }
  return d;
}

// CIOS Montgomery product a*b/R mod N, canonical for a, b < N.
KF_FN Fr fr_mul(const Fr& a, const Fr& b) {
  uint32_t t[KF_NW + 2];
#pragma unroll
  for (int i = 0; i < KF_NW + 2; ++i) t[i] = 0;
#pragma unroll
  for (int i = 0; i < KF_NW; ++i) {
    uint64_t c = 0;
#pragma unroll
    for (int j = 0; j < KF_NW; ++j) {
      c = (uint64_t)t[j] + (uint64_t)a.w[j] * b.w[i] + (c >> 32);
      t[j] = (uint32_t)c;
    }
    c = (uint64_t)t[KF_NW] + (c >> 32);
    t[KF_NW] = (uint32_t)c;
    t[KF_NW + 1] = (uint32_t)(c >> 32);
    uint32_t m = t[0] * KF_N0INV;
    c = (uint64_t)t[0] + (uint64_t)m * KF_N[0];
#pragma unroll
    for (int j = 1; j < KF_NW; ++j) {
      c = (uint64_t)t[j] + (uint64_t)m * KF_N[j] + (c >> 32);
      t[j - 1] = (uint32_t)c;
    }
    c = (uint64_t)t[KF_NW] + (c >> 32);
    t[KF_NW - 1] = (uint32_t)c;
    t[KF_NW] = t[KF_NW + 1] + (uint32_t)(c >> 32);
  }
  Fr r;
#pragma unroll
  for (int i = 0; i < KF_NW; ++i) r.w[i] = t[i];
  return fr_reduce_once(r, t[KF_NW]);
}

KF_FN Fr fr_to_mont(const Fr& a) { return fr_mul(a, fr_load(KF_R2)); }

KF_FN uint32_t fr_exp_bit(int b) { return (KF_EXP[b >> 5] >> (b & 31)) & 1u; }

KF_FN Fr fr_inv(const Fr& a) {
  Fr acc = a;
  for (int b = KF_EXP_TOP - 1; b >= 0; --b) {
    acc = fr_mul(acc, acc);
    if (fr_exp_bit(b)) acc = fr_mul(acc, a);
  }
  return acc;
}

// W^-1 mod N for W = 2^log2w dividing N - 1: N - (N - 1) / W, canonical
KF_FN Fr fr_inv_pow2(int log2w) {
  Fr q;
#pragma unroll
  for (int i = 0; i < KF_NW; ++i) {
    uint64_t lo = KF_N[i] - (i == 0 ? 1u : 0u);   // N - 1 (its word 0 is 1)
    uint64_t hi = i + 1 < KF_NW ? KF_N[i + 1] : 0u;
    q.w[i] = (uint32_t)(((hi << 32) | lo) >> log2w);
  }
  return fr_sub(fr_load(KF_N), q);
}

// One element of blob i: the canonical term f_j * w_j / (z - w_j) (0
// when z = w_j, since fr_inv(0) = 0) and whether z = w_j.  f is
// canonical; wm and zm are w_j and z in Montgomery form, so f * wm is
// the canonical f_j * w_j and the ladder on zm - wm gives 1 / (z - w_j)
// in Montgomery form: two products and the ladder, no conversion.
KF_FN Fr kzg_term(const Fr& f, const Fr& wm, const Fr& zm, bool* hit) {
  Fr d = fr_sub(zm, wm);
  *hit = fr_is_zero(d);
  return fr_mul(fr_mul(f, wm), fr_inv(d));
}

// The blob's value from the sum of its canonical terms, the sum of its
// hit lanes' f (canonical; at most one lane hits) and whether any hit:
// (z^W - 1) / W * sum, canonical, or the hit lane's f.  zm is z in
// Montgomery form, so the factor stays in Montgomery form and its product
// with the canonical sum is canonical.
KF_FN Fr kzg_finish(const Fr& sum, const Fr& fhit, bool hit, const Fr& zm,
                    int log2w) {
  Fr zw = zm;
  for (int k = 0; k < log2w; ++k) zw = fr_mul(zw, zw);
  Fr factor = fr_mul(fr_sub(zw, fr_load(KF_R1)),
                     fr_to_mont(fr_inv_pow2(log2w)));
  Fr out = fr_mul(sum, factor);
  return hit ? fhit : out;
}
