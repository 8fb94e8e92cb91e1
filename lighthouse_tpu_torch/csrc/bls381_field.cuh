// BLS12-381 field core for the port's CUDA kernels (csrc/bls381.cu).
//
// An Fq element is 13 little-endian 32-bit words holding a Montgomery
// residue with R = 2^416 -- the JAX package's R, so a boundary plane of
// 26 16-bit limbs re-packs into these words limb pair by limb pair, with
// no change of domain.  Every operation is the reference's value for
// value (lighthouse_tpu/crypto/pairing_kernel.py):
//
//   fp_add  a + b, conditionally minus 2N        (k_add)
//   fp_sub  a + 2N - b, conditionally minus 2N   (k_sub)
//   fp_neg  2N - a, unreduced                    (k_neg)
//   fp_muls a * s, minus 16N, 8N, 4N, 2N         (k_muls)
//   fp_mul  CIOS Montgomery product: (a*b + m*N) / R with m = -a*b/N mod
//           R, the value the reference's full-width reduction gives (m is
//           the unique such value below R), < 2N for inputs <= 2N (k_mont_mul)
//
// and the tower, the RCB point law, the Miller steps, the final
// exponentiation and the hash-to-curve maps repeat the reference's
// formulas in its order, so every boundary tensor matches the plain
// PyTorch versions limb for limb.  Values stay lazily below 2N.
//
// The header compiles as CUDA (device functions, constants in
// __constant__ memory) and as plain C++ (host functions), so the per-lane
// arithmetic can be exercised without a GPU.  Big functions are
// __noinline__: code size and nvcc time stay small, at the price of
// passing operands through the stack.

#pragma once
#include <stdint.h>

#if defined(__CUDACC__)
#define LH_FN __device__ __forceinline__
#define LH_MFN __device__ __forceinline__   // member functions
#define LH_NI __device__ __noinline__
#define LH_CONST __constant__
#else
#define LH_FN static inline
#define LH_MFN inline
#define LH_NI static __attribute__((noinline))
#define LH_CONST static
#endif

#define LH_NW 13
#define LH_ROWS 32   // rows of one Fq block in the boundary layout
#define LH_LANES 128  // lanes of one cell (the reference's lane block)

struct Fp { uint32_t w[LH_NW]; };
struct Fp2 { Fp c0, c1; };
struct Fp6 { Fp2 c[3]; };
struct Fp12 { Fp6 c[2]; };
struct G2P { Fp2 X, Y, Z; };
struct G1P { Fp X, Y, Z; };

// Uploaded once per process (lh_bls_init); built by pairing_kernel.
// cuda_consts() field by field in this order.
struct BlsConsts {
  Fp N, N2, K4, K8, K16;     // k*N
  Fp ONE;                    // Montgomery 1
  Fp RAW_ONE;                // the integer 1 (mont_mul by it leaves the domain)
  Fp ZP[8];                  // k*N, k < 8: the lazy zeros
  Fp2 FROB[3][6];            // Frobenius n = 1..3, coefficient i*3 + j
  Fp2 H_A, H_B, H_Z, H_NEGBA, H_X1EXC;
  Fp2 E8I[4], TK[4];         // sqrt candidates
  Fp2 XN[4], XD[3], YN[4], YD[4];   // 3-isogeny polynomials, low degree first
  Fp2 PSI_CX, PSI_CY;
  uint32_t n0inv;            // -N^-1 mod 2^32
  uint32_t x_bits, pm2_bits, e16_bits;
  uint32_t xabs[2];          // |x| = 0xd201000000010000
  uint32_t pm2[12];          // p - 2
  uint32_t e16[24];          // (p^2 + 7) / 16
};

LH_CONST BlsConsts KC;

LH_FN uint32_t exp_bit(const uint32_t* words, uint32_t b) {
  return (words[b >> 5] >> (b & 31)) & 1u;
}

// ---------------------------------------------------------------------------
// Fq
// ---------------------------------------------------------------------------

LH_FN void fp_add_raw(Fp& r, const Fp& a, const Fp& b) {  // mod 2^416
  uint64_t c = 0;
#pragma unroll
  for (int i = 0; i < LH_NW; ++i) {
    c += (uint64_t)a.w[i] + b.w[i];
    r.w[i] = (uint32_t)c;
    c >>= 32;
  }
}

LH_FN uint32_t fp_sub_raw(Fp& r, const Fp& a, const Fp& b) {  // borrow out
  uint64_t br = 0;
#pragma unroll
  for (int i = 0; i < LH_NW; ++i) {
    uint64_t d = (uint64_t)a.w[i] - b.w[i] - br;
    r.w[i] = (uint32_t)d;
    br = (d >> 32) & 1u;
  }
  return (uint32_t)br;
}

// x - k if x >= k else x  (_cond_sub_raw)
LH_FN Fp fp_cond_sub(const Fp& x, const Fp& k) {
  Fp d;
  return fp_sub_raw(d, x, k) ? x : d;
}

LH_FN Fp fp_add(const Fp& a, const Fp& b) {
  Fp s;
  fp_add_raw(s, a, b);
  return fp_cond_sub(s, KC.N2);
}

LH_FN Fp fp_sub(const Fp& a, const Fp& b) {
  Fp t, d;
  fp_add_raw(t, a, KC.N2);
  fp_sub_raw(d, t, b);
  return fp_cond_sub(d, KC.N2);
}

LH_FN Fp fp_neg(const Fp& a) {
  Fp d;
  fp_sub_raw(d, KC.N2, a);
  return d;
}

LH_FN Fp fp_muls(const Fp& a, uint32_t s) {
  Fp x;
  uint64_t c = 0;
#pragma unroll
  for (int i = 0; i < LH_NW; ++i) {
    c += (uint64_t)a.w[i] * s;
    x.w[i] = (uint32_t)c;
    c >>= 32;
  }
  x = fp_cond_sub(x, KC.K16);
  x = fp_cond_sub(x, KC.K8);
  x = fp_cond_sub(x, KC.K4);
  return fp_cond_sub(x, KC.N2);
}

LH_NI Fp fp_mul(const Fp& a, const Fp& b) {
  uint32_t t[LH_NW + 2];
#pragma unroll
  for (int j = 0; j < LH_NW + 2; ++j) t[j] = 0;
#pragma unroll
  for (int i = 0; i < LH_NW; ++i) {
    uint64_t c = 0;
#pragma unroll
    for (int j = 0; j < LH_NW; ++j) {
      c += (uint64_t)t[j] + (uint64_t)a.w[j] * b.w[i];
      t[j] = (uint32_t)c;
      c >>= 32;
    }
    c += t[LH_NW];
    t[LH_NW] = (uint32_t)c;
    t[LH_NW + 1] = (uint32_t)(c >> 32);
    uint32_t m = t[0] * KC.n0inv;
    c = (uint64_t)t[0] + (uint64_t)m * KC.N.w[0];
    c >>= 32;
#pragma unroll
    for (int j = 1; j < LH_NW; ++j) {
      c += (uint64_t)t[j] + (uint64_t)m * KC.N.w[j];
      t[j - 1] = (uint32_t)c;
      c >>= 32;
    }
    c += t[LH_NW];
    t[LH_NW - 1] = (uint32_t)c;
    t[LH_NW] = t[LH_NW + 1] + (uint32_t)(c >> 32);
  }
  Fp r;
#pragma unroll
  for (int j = 0; j < LH_NW; ++j) r.w[j] = t[j];
  return r;
}

LH_FN bool fp_eq(const Fp& a, const Fp& b) {
  uint32_t d = 0;
#pragma unroll
  for (int i = 0; i < LH_NW; ++i) d |= a.w[i] ^ b.w[i];
  return d == 0;
}

// a == 0 mod N for lazy values < 8N  (k_is_zero)
LH_FN bool fp_is_zero(const Fp& a) {
  bool z = false;
#pragma unroll
  for (int k = 0; k < 8; ++k) z = z || fp_eq(a, KC.ZP[k]);
  return z;
}

LH_FN Fp fp_zero() {
  Fp r;
#pragma unroll
  for (int i = 0; i < LH_NW; ++i) r.w[i] = 0;
  return r;
}

// Fermat ladder a^(p-2), MSB first; inv(0) = 0  (k_fq_inv)
LH_NI Fp fp_inv(const Fp& a) {
  Fp acc = KC.ONE;
#pragma unroll 1
  for (int i = (int)KC.pm2_bits - 1; i >= 0; --i) {
    acc = fp_mul(acc, acc);
    if (exp_bit(KC.pm2, (uint32_t)i)) acc = fp_mul(acc, a);
  }
  return acc;
}

// mont_mul by the integer 1, then minus N: the canonical value (k_canonical)
LH_FN Fp fp_canonical(const Fp& a) {
  return fp_cond_sub(fp_mul(a, KC.RAW_ONE), KC.N);
}

// ---------------------------------------------------------------------------
// Fq2 = Fq[u]/(u^2 + 1)
// ---------------------------------------------------------------------------

LH_FN Fp2 fp2_add(const Fp2& a, const Fp2& b) {
  return {fp_add(a.c0, b.c0), fp_add(a.c1, b.c1)};
}
LH_FN Fp2 fp2_sub(const Fp2& a, const Fp2& b) {
  return {fp_sub(a.c0, b.c0), fp_sub(a.c1, b.c1)};
}
LH_FN Fp2 fp2_neg(const Fp2& a) { return {fp_neg(a.c0), fp_neg(a.c1)}; }
LH_FN Fp2 fp2_conj(const Fp2& a) { return {a.c0, fp_neg(a.c1)}; }
LH_FN Fp2 fp2_muls(const Fp2& a, uint32_t s) {
  return {fp_muls(a.c0, s), fp_muls(a.c1, s)};
}
// xi = 1 + u: (a0 - a1) + (a0 + a1)u
LH_FN Fp2 fp2_mul_by_xi(const Fp2& a) {
  return {fp_sub(a.c0, a.c1), fp_add(a.c0, a.c1)};
}
// Karatsuba: (m0 - m1, m2 - (m0 + m1))
LH_NI Fp2 fp2_mul(const Fp2& a, const Fp2& b) {
  Fp m0 = fp_mul(a.c0, b.c0);
  Fp m1 = fp_mul(a.c1, b.c1);
  Fp m2 = fp_mul(fp_add(a.c0, a.c1), fp_add(b.c0, b.c1));
  return {fp_sub(m0, m1), fp_sub(m2, fp_add(m0, m1))};
}
// Schoolbook: (a0b0 - a1b1, a0b1 + a1b0) -- the XLA tower's product, which
// the reference's sigma_combine glue runs (fq2_mul_schoolbook)
LH_NI Fp2 fp2_mul_schoolbook(const Fp2& a, const Fp2& b) {
  return {fp_sub(fp_mul(a.c0, b.c0), fp_mul(a.c1, b.c1)),
          fp_add(fp_mul(a.c0, b.c1), fp_mul(a.c1, b.c0))};
}
LH_FN Fp2 fp2_mul_fp(const Fp2& a, const Fp& s) {
  return {fp_mul(a.c0, s), fp_mul(a.c1, s)};
}
LH_FN bool fp2_is_zero(const Fp2& a) {
  return fp_is_zero(a.c0) && fp_is_zero(a.c1);
}
LH_FN bool fp2_eq(const Fp2& a, const Fp2& b) {
  return fp_is_zero(fp_sub(a.c0, b.c0)) && fp_is_zero(fp_sub(a.c1, b.c1));
}
LH_FN Fp2 fp2_zero() { return {fp_zero(), fp_zero()}; }
LH_FN Fp2 fp2_one() { return {KC.ONE, fp_zero()}; }

LH_NI Fp2 fp2_inv(const Fp2& a) {
  Fp ni = fp_inv(fp_add(fp_mul(a.c0, a.c0), fp_mul(a.c1, a.c1)));
  return {fp_mul(a.c0, ni), fp_mul(fp_neg(a.c1), ni)};
}

// ---------------------------------------------------------------------------
// Fq6 = Fq2[v]/(v^3 - xi), Fq12 = Fq6[w]/(w^2 - v)
// ---------------------------------------------------------------------------

LH_FN Fp6 fp6_add(const Fp6& a, const Fp6& b) {
  return {{fp2_add(a.c[0], b.c[0]), fp2_add(a.c[1], b.c[1]),
           fp2_add(a.c[2], b.c[2])}};
}
LH_FN Fp6 fp6_sub(const Fp6& a, const Fp6& b) {
  return {{fp2_sub(a.c[0], b.c[0]), fp2_sub(a.c[1], b.c[1]),
           fp2_sub(a.c[2], b.c[2])}};
}
LH_FN Fp6 fp6_neg(const Fp6& a) {
  return {{fp2_neg(a.c[0]), fp2_neg(a.c[1]), fp2_neg(a.c[2])}};
}
LH_FN Fp6 fp6_mul_by_v(const Fp6& a) {
  return {{fp2_mul_by_xi(a.c[2]), a.c[0], a.c[1]}};
}

LH_NI Fp6 fp6_mul(const Fp6& a, const Fp6& b) {
  Fp2 v0 = fp2_mul(a.c[0], b.c[0]);
  Fp2 v1 = fp2_mul(a.c[1], b.c[1]);
  Fp2 v2 = fp2_mul(a.c[2], b.c[2]);
  Fp2 v01 = fp2_mul(fp2_add(a.c[0], a.c[1]), fp2_add(b.c[0], b.c[1]));
  Fp2 v12 = fp2_mul(fp2_add(a.c[1], a.c[2]), fp2_add(b.c[1], b.c[2]));
  Fp2 v02 = fp2_mul(fp2_add(a.c[0], a.c[2]), fp2_add(b.c[0], b.c[2]));
  Fp6 r;
  r.c[0] = fp2_add(v0, fp2_mul_by_xi(fp2_sub(v12, fp2_add(v1, v2))));
  r.c[1] = fp2_add(fp2_sub(v01, fp2_add(v0, v1)), fp2_mul_by_xi(v2));
  r.c[2] = fp2_add(fp2_sub(v02, fp2_add(v0, v2)), v1);
  return r;
}

LH_NI Fp12 fp12_mul(const Fp12& a, const Fp12& b) {
  Fp6 v00 = fp6_mul(a.c[0], b.c[0]);
  Fp6 v11 = fp6_mul(a.c[1], b.c[1]);
  Fp6 vxx = fp6_mul(fp6_add(a.c[0], a.c[1]), fp6_add(b.c[0], b.c[1]));
  Fp12 r;
  r.c[0] = fp6_add(v00, fp6_mul_by_v(v11));
  r.c[1] = fp6_sub(vxx, fp6_add(v00, v11));
  return r;
}

LH_FN Fp12 fp12_conj(const Fp12& a) {
  Fp12 r;
  r.c[0] = a.c[0];
  r.c[1] = fp6_neg(a.c[1]);
  return r;
}

LH_FN Fp12 fp12_one() {
  Fp12 r;
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) r.c[i].c[j] = fp2_zero();
  r.c[0].c[0].c0 = KC.ONE;
  return r;
}

LH_FN bool fp12_is_one(const Fp12& a) {
  const Fp12 one = fp12_one();
  bool ok = true;
#pragma unroll 1
  for (int i = 0; i < 2; ++i)
#pragma unroll 1
    for (int j = 0; j < 3; ++j) {
      ok = ok && fp_is_zero(fp_sub(a.c[i].c[j].c0, one.c[i].c[j].c0));
      ok = ok && fp_is_zero(fp_sub(a.c[i].c[j].c1, one.c[i].c[j].c1));
    }
  return ok;
}

// ---------------------------------------------------------------------------
// G2, homogeneous projective, RCB complete addition (a = 0, b3 = 3*4*xi)
// ---------------------------------------------------------------------------

LH_FN Fp2 g2_b3(const Fp2& t) { return fp2_muls(fp2_mul_by_xi(t), 12); }

// The law over any Fq2 product MUL (a functor): Karatsuba for the kernels'
// g2_add, schoolbook for the sigma_combine glue's g2_add_schoolbook.
template <class MUL>
LH_FN G2P g2_add_law(const G2P& p, const G2P& q, MUL mul) {
  Fp2 t0 = mul(p.X, q.X);
  Fp2 t1 = mul(p.Y, q.Y);
  Fp2 t2 = mul(p.Z, q.Z);
  Fp2 pxy = mul(fp2_add(p.X, p.Y), fp2_add(q.X, q.Y));
  Fp2 pyz = mul(fp2_add(p.Y, p.Z), fp2_add(q.Y, q.Z));
  Fp2 pxz = mul(fp2_add(p.X, p.Z), fp2_add(q.X, q.Z));
  Fp2 s3 = fp2_sub(pxy, fp2_add(t0, t1));
  Fp2 s4 = fp2_sub(pyz, fp2_add(t1, t2));
  Fp2 s5 = fp2_sub(pxz, fp2_add(t0, t2));
  Fp2 b3t2 = g2_b3(t2);
  Fp2 um = fp2_sub(t1, b3t2);
  Fp2 up = fp2_add(t1, b3t2);
  G2P r;
  r.X = fp2_sub(mul(s3, um), g2_b3(mul(s4, s5)));
  r.Y = fp2_add(mul(up, um), fp2_muls(g2_b3(mul(t0, s5)), 3));
  r.Z = fp2_add(mul(s4, up), fp2_muls(mul(t0, s3), 3));
  return r;
}

struct Fp2MulKaratsuba {
  LH_MFN Fp2 operator()(const Fp2& a, const Fp2& b) const {
    return fp2_mul(a, b);
  }
};
struct Fp2MulSchoolbook {
  LH_MFN Fp2 operator()(const Fp2& a, const Fp2& b) const {
    return fp2_mul_schoolbook(a, b);
  }
};

LH_NI G2P g2_add(const G2P& p, const G2P& q) {
  return g2_add_law(p, q, Fp2MulKaratsuba());
}
LH_NI G2P g2_add_schoolbook(const G2P& p, const G2P& q) {
  return g2_add_law(p, q, Fp2MulSchoolbook());
}

LH_FN G2P g2_identity() { return {fp2_zero(), fp2_one(), fp2_zero()}; }
LH_FN G2P g2_neg(const G2P& p) { return {p.X, fp2_neg(p.Y), p.Z}; }

// ---------------------------------------------------------------------------
// G1, the same law over Fq (b3 = 3*4): the reference's _G1ops + point_add
// ---------------------------------------------------------------------------

LH_FN Fp g1_b3(const Fp& t) { return fp_muls(t, 12); }

LH_NI G1P g1_add(const G1P& p, const G1P& q) {
  Fp t0 = fp_mul(p.X, q.X);
  Fp t1 = fp_mul(p.Y, q.Y);
  Fp t2 = fp_mul(p.Z, q.Z);
  Fp pxy = fp_mul(fp_add(p.X, p.Y), fp_add(q.X, q.Y));
  Fp pyz = fp_mul(fp_add(p.Y, p.Z), fp_add(q.Y, q.Z));
  Fp pxz = fp_mul(fp_add(p.X, p.Z), fp_add(q.X, q.Z));
  Fp s3 = fp_sub(pxy, fp_add(t0, t1));
  Fp s4 = fp_sub(pyz, fp_add(t1, t2));
  Fp s5 = fp_sub(pxz, fp_add(t0, t2));
  Fp b3t2 = g1_b3(t2);
  Fp um = fp_sub(t1, b3t2);
  Fp up = fp_add(t1, b3t2);
  G1P r;
  r.X = fp_sub(fp_mul(s3, um), g1_b3(fp_mul(s4, s5)));
  r.Y = fp_add(fp_mul(up, um), fp_muls(g1_b3(fp_mul(t0, s5)), 3));
  r.Z = fp_add(fp_mul(s4, up), fp_muls(fp_mul(t0, s3), 3));
  return r;
}

LH_FN G1P g1_identity() { return {fp_zero(), KC.ONE, fp_zero()}; }

// LSB-first 64-bit double-and-add (scalar_mul), as sigma_ladder does it.
LH_NI G1P g1_ladder(const G1P& p, uint32_t lo, uint32_t hi) {
  G1P acc = g1_identity();
  G1P base = p;
#pragma unroll 1
  for (int i = 0; i < 64; ++i) {
    uint32_t bit = ((i < 32 ? lo : hi) >> (i & 31)) & 1u;
    G1P added = g1_add(acc, base);
    if (bit) acc = added;
    base = g1_add(base, base);
  }
  return acc;
}

// ---------------------------------------------------------------------------
// Boundary layout: block k of a (rows, M) int32 plane, 16-bit limbs
// ---------------------------------------------------------------------------

LH_FN Fp load_fp(const int32_t* base, long long M, long long lane, int blk) {
  const int32_t* p = base + (long long)blk * LH_ROWS * M + lane;
  Fp r;
#pragma unroll
  for (int i = 0; i < LH_NW; ++i)
    r.w[i] = ((uint32_t)p[(2 * i) * M] & 0xFFFFu) |
             ((uint32_t)p[(2 * i + 1) * M] << 16);
  return r;
}

LH_FN void store_fp(int32_t* base, long long M, long long lane, int blk,
                    const Fp& a) {
  int32_t* p = base + (long long)blk * LH_ROWS * M + lane;
#pragma unroll
  for (int i = 0; i < LH_NW; ++i) {
    p[(2 * i) * M] = (int32_t)(a.w[i] & 0xFFFFu);
    p[(2 * i + 1) * M] = (int32_t)(a.w[i] >> 16);
  }
#pragma unroll
  for (int r = 2 * LH_NW; r < LH_ROWS; ++r) p[r * M] = 0;
}

LH_FN Fp2 load_fp2(const int32_t* base, long long M, long long lane, int blk) {
  return {load_fp(base, M, lane, blk), load_fp(base, M, lane, blk + 1)};
}

LH_FN void store_fp2(int32_t* base, long long M, long long lane, int blk,
                     const Fp2& a) {
  store_fp(base, M, lane, blk, a.c0);
  store_fp(base, M, lane, blk + 1, a.c1);
}

LH_FN Fp12 load_fp12(const int32_t* base, long long M, long long lane) {
  Fp12 r;
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j)
      r.c[i].c[j] = load_fp2(base, M, lane, 2 * (i * 3 + j));
  return r;
}

LH_FN void store_fp12(int32_t* base, long long M, long long lane,
                      const Fp12& a) {
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j)
      store_fp2(base, M, lane, 2 * (i * 3 + j), a.c[i].c[j]);
}

// ---------------------------------------------------------------------------
// Per-lane pieces of the kernels
// ---------------------------------------------------------------------------

// Sigma: LSB-first 64-bit double-and-add (scalar_mul); the add is computed
// every step and kept where the bit is set.
LH_FN G2P sigma_ladder(const G2P& p, uint32_t lo, uint32_t hi) {
  G2P acc = g2_identity();
  G2P base = p;
#pragma unroll 1
  for (int i = 0; i < 64; ++i) {
    uint32_t bit = ((i < 32 ? lo : hi) >> (i & 31)) & 1u;
    G2P added = g2_add(acc, base);
    if (bit) acc = added;
    base = g2_add(base, base);
  }
  return acc;
}

// Line ((A, B, 0), (0, C, 0)) as a dense Fq12 (the reference multiplies
// the dense element, so the lazy representatives match).
LH_FN Fp12 line_fp12(const Fp2& A, const Fp2& B, const Fp2& C) {
  Fp12 l;
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) l.c[i].c[j] = fp2_zero();
  l.c[0].c[0] = A;
  l.c[0].c[1] = B;
  l.c[1].c[1] = C;
  return l;
}

// f <- f^2 * l_{T,T}(P), T <- 2T  (_miller_dbl_step)
LH_NI void miller_dbl(Fp12& f, G2P& T, const Fp& xP, const Fp& yP) {
  Fp2 XX = fp2_mul(T.X, T.X);
  Fp2 YY = fp2_mul(T.Y, T.Y);
  Fp2 ZZ = fp2_mul(T.Z, T.Z);
  Fp2 X3 = fp2_mul(T.X, XX);
  Fp2 Y2Z = fp2_mul(YY, T.Z);
  Fp2 X2Z = fp2_mul(XX, T.Z);
  Fp2 YZ2 = fp2_mul(T.Y, ZZ);
  Fp2 A = fp2_sub(fp2_muls(X3, 3), fp2_muls(Y2Z, 2));
  Fp2 B = fp2_neg(fp2_mul_fp(fp2_muls(X2Z, 3), xP));
  Fp2 C = fp2_mul_fp(fp2_muls(YZ2, 2), yP);
  T = g2_add(T, T);
  f = fp12_mul(fp12_mul(f, f), line_fp12(A, B, C));
}

// f <- f * l_{T,Q}(P), T <- T + Q  (_miller_add_step)
LH_NI void miller_add(Fp12& f, G2P& T, const G2P& Q, const Fp& xP,
                      const Fp& yP) {
  Fp2 Nn = fp2_sub(fp2_mul(Q.Y, T.Z), T.Y);
  Fp2 Dd = fp2_sub(fp2_mul(Q.X, T.Z), T.X);
  Fp2 A = fp2_sub(fp2_mul(Nn, Q.X), fp2_mul(Q.Y, Dd));
  Fp2 B = fp2_neg(fp2_mul_fp(Nn, xP));
  Fp2 C = fp2_mul_fp(Dd, yP);
  T = g2_add(T, Q);
  f = fp12_mul(f, line_fp12(A, B, C));
}

// Conjugated Miller loop over the 63 bits of |x| below its top bit.
LH_FN Fp12 miller_loop(const Fp& xP, const Fp& yP, const Fp2& Qx,
                       const Fp2& Qy) {
  const G2P Q = {Qx, Qy, fp2_one()};
  G2P T = Q;
  Fp12 f = fp12_one();
#pragma unroll 1
  for (int b = (int)KC.x_bits - 2; b >= 0; --b) {
    miller_dbl(f, T, xP, yP);
    if (exp_bit(KC.xabs, (uint32_t)b)) miller_add(f, T, Q, xP, yP);
  }
  return fp12_conj(f);   // x < 0
}

// --- hash to G2 -------------------------------------------------------------

// RFC 9380 sgn0 over Fq2, on canonical values
LH_FN uint32_t fp2_sgn0(const Fp2& a) {
  Fp c0 = fp_canonical(a.c0);
  Fp c1 = fp_canonical(a.c1);
  uint32_t z0 = fp_eq(c0, fp_zero()) ? 1u : 0u;
  return (c0.w[0] & 1u) | (z0 & (c1.w[0] & 1u));
}

// a^((p^2 + 7)/16), LSB first
LH_NI Fp2 fp2_pow_e16(const Fp2& a) {
  Fp2 res = fp2_one();
  Fp2 base = a;
#pragma unroll 1
  for (uint32_t i = 0; i < KC.e16_bits; ++i) {
    if (exp_bit(KC.e16, i)) res = fp2_mul(res, base);
    base = fp2_mul(base, base);
  }
  return res;
}

// Simplified SWU onto E' with the branchless 8-candidate square root
LH_NI void sswu_map(const Fp2& t, Fp2& x, Fp2& y) {
  Fp2 tt = fp2_mul(t, t);
  Fp2 tv1 = fp2_mul(KC.H_Z, tt);
  Fp2 tv2 = fp2_add(fp2_mul(tv1, tv1), tv1);
  bool d_zero = fp2_is_zero(tv2);
  Fp2 x1 = fp2_mul(KC.H_NEGBA, fp2_add(fp2_one(), fp2_inv(tv2)));
  if (d_zero) x1 = KC.H_X1EXC;
  Fp2 gx1 = fp2_add(fp2_mul(fp2_mul(x1, x1), x1),
                    fp2_add(fp2_mul(KC.H_A, x1), KC.H_B));
  Fp2 c = fp2_pow_e16(gx1);
  Fp2 y1 = fp2_zero(), s = fp2_zero();
  bool is_qr = false;
  Fp2 zgx1 = fp2_mul(KC.H_Z, gx1);
#pragma unroll 1
  for (int k = 0; k < 4; ++k) {
    Fp2 cand = fp2_mul(c, KC.E8I[k]);
    if (fp2_eq(fp2_mul(cand, cand), gx1)) {
      y1 = cand;
      is_qr = true;
    }
  }
#pragma unroll 1
  for (int k = 0; k < 4; ++k) {
    Fp2 cand = fp2_mul(c, KC.TK[k]);
    if (fp2_eq(fp2_mul(cand, cand), zgx1)) s = cand;
  }
  if (is_qr) {
    x = x1;
    y = y1;
  } else {
    x = fp2_mul(tv1, x1);
    y = fp2_mul(fp2_mul(tv1, t), s);
  }
  if (fp2_sgn0(t) != fp2_sgn0(y)) y = fp2_neg(y);
}

// 3-isogeny E' -> E, projective: (XN*YD, y*YN*XD, XD*YD).  The
// polynomials add their terms low degree first; XD and YD are monic.
LH_NI G2P iso_map_proj(const Fp2& x, const Fp2& y) {
  Fp2 x2 = fp2_mul(x, x);
  Fp2 x3 = fp2_mul(x2, x);
  Fp2 xn = fp2_add(fp2_add(fp2_add(KC.XN[0], fp2_mul(KC.XN[1], x)),
                           fp2_mul(KC.XN[2], x2)), fp2_mul(KC.XN[3], x3));
  Fp2 xd = fp2_add(fp2_add(KC.XD[0], fp2_mul(KC.XD[1], x)), x2);
  Fp2 yp = fp2_add(fp2_add(fp2_add(KC.YN[0], fp2_mul(KC.YN[1], x)),
                           fp2_mul(KC.YN[2], x2)), fp2_mul(KC.YN[3], x3));
  Fp2 yn = fp2_mul(y, yp);
  Fp2 yd = fp2_add(fp2_add(fp2_add(KC.YD[0], fp2_mul(KC.YD[1], x)),
                           fp2_mul(KC.YD[2], x2)), x3);
  return {fp2_mul(xn, yd), fp2_mul(yn, xd), fp2_mul(xd, yd)};
}

// [|x|]P, MSB first
LH_NI G2P g2_mul_x_abs(const G2P& p) {
  G2P acc = g2_identity();
#pragma unroll 1
  for (int b = (int)KC.x_bits - 1; b >= 0; --b) {
    acc = g2_add(acc, acc);
    if (exp_bit(KC.xabs, (uint32_t)b)) acc = g2_add(acc, p);
  }
  return acc;
}

LH_FN G2P g2_psi(const G2P& p) {
  return {fp2_mul(KC.PSI_CX, fp2_conj(p.X)), fp2_mul(KC.PSI_CY, fp2_conj(p.Y)),
          fp2_conj(p.Z)};
}

// Budroni-Pintore: ([x^2]P - [x]P - P) + psi([x]P - P) + psi^2([2]P)
LH_NI G2P clear_cofactor(const G2P& p) {
  G2P t1 = g2_neg(g2_mul_x_abs(p));
  G2P t2 = g2_neg(g2_mul_x_abs(t1));
  G2P acc = g2_add(t2, g2_neg(t1));
  acc = g2_add(acc, g2_neg(p));
  acc = g2_add(acc, g2_psi(g2_add(t1, g2_neg(p))));
  return g2_add(acc, g2_psi(g2_psi(g2_add(p, p))));
}

// One u lane: SSWU then the isogeny.
LH_FN G2P hash_lane(const Fp2& t) {
  Fp2 x, y;
  sswu_map(t, x, y);
  return iso_map_proj(x, y);
}

// One message: q(u0) + q(u1), cofactor clearing, affine (x, y).
LH_NI void hash_finish(const G2P& q0, const G2P& q1, Fp2& xa, Fp2& ya) {
  G2P p = clear_cofactor(g2_add(q0, q1));
  Fp2 zi = fp2_inv(p.Z);
  xa = fp2_mul(p.X, zi);
  ya = fp2_mul(p.Y, zi);
}

// --- the general batch verify -----------------------------------------------

// Prepare, one set: its K key slots summed in k order from the identity
// (a masked slot adds the identity), the identity flag of the sum, the
// RLC ladder, then affine by Fermat.  inv(0) = 0, so a set whose sum is
// the identity, and a dead lane, come out as (0, 0) with flag 1.  ``col``
// is the column of key 0, ``stride`` the step between keys, ``mk`` the
// key plane's width.
LH_FN int prepare_set(const int32_t* pk, const int32_t* kmask, long long mk,
                      long long col, long long stride, int K, uint32_t lo,
                      uint32_t hi, Fp& xa, Fp& ya) {
  G1P acc = g1_identity();
#pragma unroll 1
  for (int k = 0; k < K; ++k, col += stride) {
    G1P blk = g1_identity();
    if (kmask[col] != 0)
      blk = {load_fp(pk, mk, col, 0), load_fp(pk, mk, col, 1), KC.ONE};
    acc = g1_add(acc, blk);
  }
  const int flag = fp_is_zero(acc.Z) ? 1 : 0;
  const G1P s = g1_ladder(acc, lo, hi);
  const Fp zi = fp_inv(s.Z);
  xa = fp_mul(s.X, zi);
  ya = fp_mul(s.Y, zi);
  return flag;
}

// Lane ``lane`` of an Fq12 plane, or 1 where the mask is 0.
LH_FN Fp12 fp12_masked(const int32_t* f, const int32_t* mask, long long m,
                       long long lane) {
  return mask[lane] != 0 ? load_fp12(f, m, lane) : fp12_one();
}

// The roll butterfly over residue class t of an M-lane plane: lanes t +
// 128r, r < R = M/128.  Step w = 128v (v = R/2 ... 1) multiplies lane j by
// lane (j + w) mod M, every lane from the previous step's values, so a
// class never reads another class.  ``a`` and ``b`` are M-lane scratch.
LH_FN void product_class(const int32_t* f, const int32_t* mask, Fp12* a,
                         Fp12* b, int32_t* out, long long m, int t) {
  const long long R = m / LH_LANES;
#pragma unroll 1
  for (long long r = 0; r < R; ++r)
    a[r * LH_LANES + t] = fp12_masked(f, mask, m, r * LH_LANES + t);
#pragma unroll 1
  for (long long v = R / 2; v >= 1; v >>= 1) {
#pragma unroll 1
    for (long long r = 0; r < R; ++r)
      b[r * LH_LANES + t] = fp12_mul(a[r * LH_LANES + t],
                                     a[((r + v) & (R - 1)) * LH_LANES + t]);
    Fp12* tmp = a;
    a = b;
    b = tmp;
  }
#pragma unroll 1
  for (long long r = 0; r < R; ++r)
    store_fp12(out, m, r * LH_LANES + t, a[r * LH_LANES + t]);
}

// --- sigma_combine ----------------------------------------------------------

// One partial of sigma_combine (the reference's XLA glue): chunk c's
// projective sum sits at lane c*128 of the (192, m) partial; the C points
// fold in chunk order by the XLA twin's law (schoolbook Fq2), the sum goes
// affine through fp2_inv (inv(0) = 0), and the Miller-ready column (x.c0,
// x.c1, y.c0, y.c1, 32 rows each) is stored at ``col``.  Returns 1 where
// the sum is the identity (its Z is 0).
LH_FN int sigma_combine_lane(const int32_t* part, long long m, int C,
                             int32_t* col) {
  G2P acc = {load_fp2(part, m, 0, 0), load_fp2(part, m, 0, 2),
             load_fp2(part, m, 0, 4)};
#pragma unroll 1
  for (int c = 1; c < C; ++c) {
    const long long lane = (long long)c * LH_LANES;
    const G2P p = {load_fp2(part, m, lane, 0), load_fp2(part, m, lane, 2),
                   load_fp2(part, m, lane, 4)};
    acc = g2_add_schoolbook(acc, p);
  }
  const int flag = fp2_is_zero(acc.Z) ? 1 : 0;
  const Fp2 zi = fp2_inv(acc.Z);
  store_fp2(col, 1, 0, 0, fp2_mul_schoolbook(acc.X, zi));
  store_fp2(col, 1, 0, 2, fp2_mul_schoolbook(acc.Y, zi));
  return flag;
}

// ---------------------------------------------------------------------------
// Cooperative tower arithmetic: the threads of one block share each step
// ---------------------------------------------------------------------------
//
// A tower product is a few phases: pre-additions, ONE wave of its
// independent Montgomery products (54 for an Fq12 product), post-additions.
// A phase is a function of (tid, shared state) that every thread of the
// block runs, followed by a barrier; its work items are spread over the
// threads, item i on thread i mod LH_COOP_THREADS.  A runner executes the
// phases: BlockRun on the card (the phase on threadIdx.x, then
// __syncthreads), HostRun in a plain C++ build (the phase for tid = 0 ...
// T-1 in a loop), so a host build runs the very arithmetic the card runs.
// An item never reads what another item of its phase writes.  Each item
// computes its coefficient with the serial formulas above (fp2_mul,
// fp6_mul, fp12_mul, fp2_inv, ...) on the same operands, so every value is
// the serial one limb for limb.  A dependent chain of Fq12 steps then
// costs one wave of products per step (plus its additions and barriers),
// not 54 products in a row.

#define LH_COOP_THREADS 256
#define LH_COOP_BATCH 8      // Fq12 products per cooperative step

#if defined(__CUDACC__)
struct BlockRun {
  template <class F>
  LH_MFN void operator()(F&& phase) const {
    phase((int)threadIdx.x);
    __syncthreads();
  }
};
#else
struct HostRun {
  template <class F>
  void operator()(F&& phase) const {
    for (int t = 0; t < LH_COOP_THREADS; ++t) phase(t);
  }
};
#endif

#define LH_ITEMS(i, tid, n) \
  for (int i = (tid); i < (n); i += LH_COOP_THREADS)

// Scratch of one step: up to LH_COOP_BATCH Fq12 products, i.e. three times
// as many Fq6 products, 18 times as many Fq2 and 54 times as many Fq ones,
// and the temporaries of the Fq6 inversion.
struct CoopBuf {
  Fp6 A6[3 * LH_COOP_BATCH], B6[3 * LH_COOP_BATCH], W6[3 * LH_COOP_BATCH];
  Fp2 X[18 * LH_COOP_BATCH], Y[18 * LH_COOP_BATCH];
  Fp M[54 * LH_COOP_BATCH];
  Fp6 T6;
  Fp2 C[3], NRM, NI;
  Fp SQ[2], INV;
};

// Fq block b (0..11) of an Fq12, in the boundary layout's order.
LH_FN Fp& fp12_block(Fp12& a, int b) {
  Fp2& c = a.c[b / 6].c[(b >> 1) % 3];
  return (b & 1) ? c.c1 : c.c0;
}

// X[k] <- X[k] * Y[k], k < n (fp2_mul).
template <class Run>
LH_NI void coop_fp2_mul(const Run& run, CoopBuf& s, int n) {
  run([&](int tid) {
    LH_ITEMS(i, tid, 3 * n) {      // m0, m1, m2 of product i / 3
      const Fp2& x = s.X[i / 3];
      const Fp2& y = s.Y[i / 3];
      const int t = i % 3;
      // every thread adds, so the warp stays converged for the product
      const Fp sx = fp_add(x.c0, x.c1), sy = fp_add(y.c0, y.c1);
      s.M[i] = fp_mul(t == 0 ? x.c0 : t == 1 ? x.c1 : sx,
                      t == 0 ? y.c0 : t == 1 ? y.c1 : sy);
    }
  });
  run([&](int tid) {
    LH_ITEMS(k, tid, n) {
      const Fp* m = s.M + 3 * k;
      s.X[k] = {fp_sub(m[0], m[1]), fp_sub(m[2], fp_add(m[0], m[1]))};
    }
  });
}

// W6[k] <- A6[k] * B6[k], k < n (fp6_mul: v0 v1 v2 v01 v12 v02).
template <class Run>
LH_NI void coop_fp6_mul(const Run& run, CoopBuf& s, int n) {
  run([&](int tid) {
    LH_ITEMS(i, tid, 12 * n) {     // Fq2 operand j of product k, each side
      const int k = i / 12, side = i % 12 / 6, j = i % 6;
      const Fp6& a = side ? s.B6[k] : s.A6[k];
      Fp2& out = side ? s.Y[6 * k + j] : s.X[6 * k + j];
      out = j < 3 ? a.c[j]
                  : fp2_add(a.c[j == 5 ? 0 : j - 3], a.c[j == 3 ? 1 : 2]);
    }
  });
  coop_fp2_mul(run, s, 6 * n);
  run([&](int tid) {
    LH_ITEMS(i, tid, 3 * n) {
      const int k = i / 3, c = i % 3;
      const Fp2* v = s.X + 6 * k;
      s.W6[k].c[c] =
          c == 0 ? fp2_add(v[0], fp2_mul_by_xi(fp2_sub(v[4], fp2_add(v[1], v[2]))))
        : c == 1 ? fp2_add(fp2_sub(v[3], fp2_add(v[0], v[1])), fp2_mul_by_xi(v[2]))
                 : fp2_add(fp2_sub(v[5], fp2_add(v[0], v[2])), v[1]);
    }
  });
}

// d[k] <- a[k] * b[k], k < n <= LH_COOP_BATCH (fp12_mul); d may be a or b.
template <class Run>
LH_NI void coop_fp12_mul(const Run& run, CoopBuf& s, Fp12* d, const Fp12* a,
                         const Fp12* b, int n) {
  run([&](int tid) {
    LH_ITEMS(i, tid, 6 * n) {      // a0 b0, a1 b1, a0 + a1 b0 + b1
      const int k = i / 6, side = i % 6 / 3, h = i % 3;
      const Fp12& x = side ? b[k] : a[k];
      Fp6& out = side ? s.B6[3 * k + h] : s.A6[3 * k + h];
      out = h < 2 ? x.c[h] : fp6_add(x.c[0], x.c[1]);
    }
  });
  coop_fp6_mul(run, s, 3 * n);
  run([&](int tid) {
    LH_ITEMS(i, tid, 6 * n) {      // (v00 + v11 v, vxx - (v00 + v11))
      const int k = i / 6, h = i % 6 / 3, c = i % 3;
      const Fp6* v = s.W6 + 3 * k;
      d[k].c[h].c[c] =
          h == 0 ? fp2_add(v[0].c[c], c == 0 ? fp2_mul_by_xi(v[1].c[2])
                                             : v[1].c[c - 1])
                 : fp2_sub(v[2].c[c], fp2_add(v[0].c[c], v[1].c[c]));
    }
  });
}

template <class Run>
LH_NI void coop_fp12_conj(const Run& run, Fp12& d, const Fp12& a) {
  run([&](int tid) {
    LH_ITEMS(k, tid, 6) {
      const int h = k / 3, c = k % 3;
      d.c[h].c[c] = h ? fp2_neg(a.c[1].c[c]) : a.c[0].c[c];
    }
  });
}

// d <- a^(p^n): coefficient (i, j) conjugated for odd n, times FROB[n-1].
template <class Run>
LH_NI void coop_fp12_frobenius(const Run& run, CoopBuf& s, Fp12& d,
                               const Fp12& a, int n) {
  run([&](int tid) {
    LH_ITEMS(k, tid, 6) {
      const Fp2& c = a.c[k / 3].c[k % 3];
      s.X[k] = (n & 1) ? fp2_conj(c) : c;
      s.Y[k] = KC.FROB[n - 1][k];
    }
  });
  coop_fp2_mul(run, s, 6);
  run([&](int tid) { LH_ITEMS(k, tid, 6) d.c[k / 3].c[k % 3] = s.X[k]; });
}

// d <- a^-1 in Fq6: c0 = a0^2 - xi a1a2, c1 = xi a2^2 - a0a1, c2 = a1^2 -
// a0a2, nrm = a0c0 + xi(a2c1 + a1c2), d = c * fp2_inv(nrm).  The Fermat
// ladder of fp2_inv is one thread's serial chain.  d may be a.
template <class Run>
LH_NI void coop_fp6_inv(const Run& run, CoopBuf& s, Fp6& d, const Fp6& a) {
  run([&](int tid) {
    LH_ITEMS(k, tid, 6) {          // a0a0 a1a2 a2a2 a0a1 a1a1 a0a2
      s.X[k] = a.c[(0x010210 >> (4 * k)) & 0xF];
      s.Y[k] = a.c[(0x211220 >> (4 * k)) & 0xF];
    }
  });
  coop_fp2_mul(run, s, 6);
  run([&](int tid) {
    LH_ITEMS(k, tid, 3) {
      const Fp2* p = s.X;
      s.C[k] = k == 0 ? fp2_sub(p[0], fp2_mul_by_xi(p[1]))
             : k == 1 ? fp2_sub(fp2_mul_by_xi(p[2]), p[3])
                      : fp2_sub(p[4], p[5]);
    }
  });
  run([&](int tid) {
    LH_ITEMS(k, tid, 3) {          // a0 c0, a2 c1, a1 c2
      s.X[k] = a.c[(0x120 >> (4 * k)) & 0xF];
      s.Y[k] = s.C[k];
    }
  });
  coop_fp2_mul(run, s, 3);
  run([&](int tid) {
    LH_ITEMS(k, tid, 2) {          // nrm and the squares of fp2_inv
      const Fp2 nrm = fp2_add(s.X[0], fp2_mul_by_xi(fp2_add(s.X[1], s.X[2])));
      const Fp& c = k ? nrm.c1 : nrm.c0;
      s.SQ[k] = fp_mul(c, c);
      if (k == 0) s.NRM = nrm;
    }
  });
  run([&](int tid) {
    if (tid == 0) s.INV = fp_inv(fp_add(s.SQ[0], s.SQ[1]));
  });
  run([&](int tid) {
    LH_ITEMS(k, tid, 2) {
      const Fp x = k ? fp_neg(s.NRM.c1) : s.NRM.c0;
      (k ? s.NI.c1 : s.NI.c0) = fp_mul(x, s.INV);
    }
  });
  run([&](int tid) {
    LH_ITEMS(k, tid, 3) {
      s.X[k] = s.C[k];
      s.Y[k] = s.NI;
    }
  });
  coop_fp2_mul(run, s, 3);
  run([&](int tid) { LH_ITEMS(k, tid, 3) d.c[k] = s.X[k]; });
}

// d <- a^-1 in Fq12: ni = (a0^2 - v a1^2)^-1, d = (a0 ni, -a1 ni).
template <class Run>
LH_NI void coop_fp12_inv(const Run& run, CoopBuf& s, Fp12& d, const Fp12& a) {
  run([&](int tid) {
    LH_ITEMS(k, tid, 2) s.A6[k] = s.B6[k] = a.c[k];
  });
  coop_fp6_mul(run, s, 2);
  run([&](int tid) {
    if (tid == 0) s.T6 = fp6_sub(s.W6[0], fp6_mul_by_v(s.W6[1]));
  });
  coop_fp6_inv(run, s, s.T6, s.T6);
  run([&](int tid) {
    LH_ITEMS(k, tid, 2) {
      s.A6[k] = k ? fp6_neg(a.c[1]) : a.c[0];
      s.B6[k] = s.T6;
    }
  });
  coop_fp6_mul(run, s, 2);
  run([&](int tid) { LH_ITEMS(k, tid, 2) d.c[k] = s.W6[k]; });
}

// d <- f^u = conj(f^|x|), MSB first over the 64 bits of |x| (cyclotomic f).
template <class Run>
LH_NI void coop_pow_u(const Run& run, CoopBuf& s, Fp12& d, const Fp12& f) {
  run([&](int tid) {
    if (tid == 0) d = fp12_one();
  });
#pragma unroll 1
  for (int b = (int)KC.x_bits - 1; b >= 0; --b) {
    coop_fp12_mul(run, s, &d, &d, &d, 1);
    if (exp_bit(KC.xabs, (uint32_t)b)) coop_fp12_mul(run, s, &d, &d, &f, 1);
  }
  coop_fp12_conj(run, d, d);
}

// Shared state of the finalize: the 128 lanes of the fold, whose first
// slots then hold the values of the final exponentiation.
struct FinShared {
  Fp12 F[LH_LANES];
  CoopBuf s;
};

// The finalize (lh_finalize_kernel): the 128 -> 1 fold (level w multiplies
// lane j < w by lane j + w, LH_COOP_BATCH products per step), the easy part
// m = f^((q^6 - 1)(q^2 + 1)), the hard part x3 (HHT), and the == 1 test;
// ``ok`` gets the flag and ``g`` the (384, 1) value.  f is (384, 128).
template <class Run>
LH_FN void finalize_body(const Run& run, FinShared& sh, const int32_t* f,
                         int32_t* ok, int32_t* g) {
  Fp12* F = sh.F;
  CoopBuf& s = sh.s;
  run([&](int tid) {
    LH_ITEMS(i, tid, 12 * LH_LANES)
      fp12_block(F[i % LH_LANES], i / LH_LANES) =
          load_fp(f, LH_LANES, i % LH_LANES, i / LH_LANES);
  });
#pragma unroll 1
  for (int w = LH_LANES / 2; w >= 1; w >>= 1)
#pragma unroll 1
    for (int q = 0; q < w; q += LH_COOP_BATCH)
      coop_fp12_mul(run, s, F + q, F + q, F + q + w,
                    w - q < LH_COOP_BATCH ? w - q : LH_COOP_BATCH);
  // easy part: m = conj(f) / f, then m^(p^2) m
  Fp12 &inv = F[1], &t = F[2], &m = F[3];
  coop_fp12_inv(run, s, inv, F[0]);
  coop_fp12_conj(run, t, F[0]);
  coop_fp12_mul(run, s, &t, &t, &inv, 1);
  coop_fp12_frobenius(run, s, inv, t, 2);
  coop_fp12_mul(run, s, &m, &inv, &t, 1);
  // hard part: m1 = m^u conj(m), k2 = m1^u conj(m1), k3 = k2^u k2^p,
  // k4 = (k3^(u^2) k3^(p^2)) conj(k3), result k4 (m^2 m)
  Fp12 &pu = F[4], &x = F[5], &k = F[6], &u2 = F[7], &m3 = F[8], &r = F[9];
  coop_pow_u(run, s, pu, m);
  coop_fp12_conj(run, x, m);
  coop_fp12_mul(run, s, &k, &pu, &x, 1);              // m1
  coop_pow_u(run, s, pu, k);
  coop_fp12_conj(run, x, k);
  coop_fp12_mul(run, s, &k, &pu, &x, 1);              // k2
  coop_pow_u(run, s, pu, k);
  coop_fp12_frobenius(run, s, x, k, 1);
  coop_fp12_mul(run, s, &k, &pu, &x, 1);              // k3
  coop_pow_u(run, s, pu, k);
  coop_pow_u(run, s, u2, pu);
  coop_fp12_frobenius(run, s, x, k, 2);
  coop_fp12_mul(run, s, &u2, &u2, &x, 1);
  coop_fp12_conj(run, x, k);
  coop_fp12_mul(run, s, &k, &u2, &x, 1);              // k4
  coop_fp12_mul(run, s, &m3, &m, &m, 1);
  coop_fp12_mul(run, s, &m3, &m3, &m, 1);
  coop_fp12_mul(run, s, &r, &k, &m3, 1);
  run([&](int tid) {
    if (tid == 0) ok[0] = fp12_is_one(r) ? 1 : 0;
    LH_ITEMS(b, tid, 12) store_fp(g, 1, 0, b, fp12_block(r, b));
  });
}
