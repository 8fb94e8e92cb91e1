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
#include <cooperative_groups.h>
#endif

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

// On the card the two raw 13-word chains are PTX carry chains (add.cc /
// addc, sub.cc / subc): the same bits as the C loops, which the host build
// keeps, with one dependent instruction a word.
LH_FN void fp_add_raw(Fp& r, const Fp& a, const Fp& b) {  // mod 2^416
#if defined(__CUDA_ARCH__)
  asm("add.cc.u32 %0, %13, %26;\n\t"
      "addc.cc.u32 %1, %14, %27;\n\t"
      "addc.cc.u32 %2, %15, %28;\n\t"
      "addc.cc.u32 %3, %16, %29;\n\t"
      "addc.cc.u32 %4, %17, %30;\n\t"
      "addc.cc.u32 %5, %18, %31;\n\t"
      "addc.cc.u32 %6, %19, %32;\n\t"
      "addc.cc.u32 %7, %20, %33;\n\t"
      "addc.cc.u32 %8, %21, %34;\n\t"
      "addc.cc.u32 %9, %22, %35;\n\t"
      "addc.cc.u32 %10, %23, %36;\n\t"
      "addc.cc.u32 %11, %24, %37;\n\t"
      "addc.u32 %12, %25, %38;\n\t"
      : "=r"(r.w[0]), "=r"(r.w[1]), "=r"(r.w[2]), "=r"(r.w[3]),
        "=r"(r.w[4]), "=r"(r.w[5]), "=r"(r.w[6]), "=r"(r.w[7]),
        "=r"(r.w[8]), "=r"(r.w[9]), "=r"(r.w[10]), "=r"(r.w[11]),
        "=r"(r.w[12])
      : "r"(a.w[0]), "r"(a.w[1]), "r"(a.w[2]), "r"(a.w[3]),
        "r"(a.w[4]), "r"(a.w[5]), "r"(a.w[6]), "r"(a.w[7]),
        "r"(a.w[8]), "r"(a.w[9]), "r"(a.w[10]), "r"(a.w[11]),
        "r"(a.w[12]), "r"(b.w[0]), "r"(b.w[1]), "r"(b.w[2]),
        "r"(b.w[3]), "r"(b.w[4]), "r"(b.w[5]), "r"(b.w[6]),
        "r"(b.w[7]), "r"(b.w[8]), "r"(b.w[9]), "r"(b.w[10]),
        "r"(b.w[11]), "r"(b.w[12]));
  return;
#endif
  uint64_t c = 0;
#pragma unroll
  for (int i = 0; i < LH_NW; ++i) {
    c += (uint64_t)a.w[i] + b.w[i];
    r.w[i] = (uint32_t)c;
    c >>= 32;
  }
}

LH_FN uint32_t fp_sub_raw(Fp& r, const Fp& a, const Fp& b) {  // borrow out
#if defined(__CUDA_ARCH__)
  uint32_t bo;
  asm("sub.cc.u32 %0, %14, %27;\n\t"
      "subc.cc.u32 %1, %15, %28;\n\t"
      "subc.cc.u32 %2, %16, %29;\n\t"
      "subc.cc.u32 %3, %17, %30;\n\t"
      "subc.cc.u32 %4, %18, %31;\n\t"
      "subc.cc.u32 %5, %19, %32;\n\t"
      "subc.cc.u32 %6, %20, %33;\n\t"
      "subc.cc.u32 %7, %21, %34;\n\t"
      "subc.cc.u32 %8, %22, %35;\n\t"
      "subc.cc.u32 %9, %23, %36;\n\t"
      "subc.cc.u32 %10, %24, %37;\n\t"
      "subc.cc.u32 %11, %25, %38;\n\t"
      "subc.cc.u32 %12, %26, %39;\n\t"
      "subc.u32 %13, 0, 0;"
      : "=r"(r.w[0]), "=r"(r.w[1]), "=r"(r.w[2]), "=r"(r.w[3]),
        "=r"(r.w[4]), "=r"(r.w[5]), "=r"(r.w[6]), "=r"(r.w[7]),
        "=r"(r.w[8]), "=r"(r.w[9]), "=r"(r.w[10]), "=r"(r.w[11]),
        "=r"(r.w[12]), "=r"(bo)
      : "r"(a.w[0]), "r"(a.w[1]), "r"(a.w[2]), "r"(a.w[3]),
        "r"(a.w[4]), "r"(a.w[5]), "r"(a.w[6]), "r"(a.w[7]),
        "r"(a.w[8]), "r"(a.w[9]), "r"(a.w[10]), "r"(a.w[11]),
        "r"(a.w[12]), "r"(b.w[0]), "r"(b.w[1]), "r"(b.w[2]),
        "r"(b.w[3]), "r"(b.w[4]), "r"(b.w[5]), "r"(b.w[6]),
        "r"(b.w[7]), "r"(b.w[8]), "r"(b.w[9]), "r"(b.w[10]),
        "r"(b.w[11]), "r"(b.w[12]));
  return bo & 1u;
#endif
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
// G1, the same law over Fq (b3 = 3*4): the reference's _G1ops + point_add,
// run only as the cooperative waves of g1_add_opnd1 ... g1_add_out below
// ---------------------------------------------------------------------------

LH_FN Fp g1_b3(const Fp& t) { return fp_muls(t, 12); }

LH_FN G1P g1_identity() { return {fp_zero(), KC.ONE, fp_zero()}; }

// ---------------------------------------------------------------------------
// Boundary layout: block k of a (rows, M) int32 plane, 16-bit limbs
// ---------------------------------------------------------------------------

// Word w (two 16-bit limbs) of Fq block ``blk`` of a boundary plane.
LH_FN uint32_t load_word(const int32_t* base, long long M, long long lane,
                         int blk, int w) {
  const int32_t* p = base + (long long)blk * LH_ROWS * M + lane;
  return ((uint32_t)p[(2 * w) * M] & 0xFFFFu) | ((uint32_t)p[(2 * w + 1) * M] << 16);
}

LH_FN Fp load_fp(const int32_t* base, long long M, long long lane, int blk) {
  Fp r;
#pragma unroll
  for (int i = 0; i < LH_NW; ++i) r.w[i] = load_word(base, M, lane, blk, i);
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

// ---------------------------------------------------------------------------
// Per-lane pieces of the kernels
// ---------------------------------------------------------------------------

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
// Cooperative tower arithmetic: the threads of a group share each step
// ---------------------------------------------------------------------------
//
// A tower product is a few phases: pre-additions, ONE wave of its
// independent Montgomery products (54 for an Fq12 product), post-additions.
// A phase is a function of (tid, shared state) that every thread of a
// group of G threads runs, followed by the group's barrier; its work items
// are spread over the group, item i on thread i mod G.  A runner executes
// the phases: GroupRun on the card (the phase on the thread's index in its
// group, then the group's barrier: __syncwarp over the group's lanes for G
// = 8, 16 or 32 (a sub-warp group is G aligned lanes of one warp), a named
// barrier ``bar.sync id, G`` for a group of 64 or 128 threads,
// __syncthreads where the group is the whole block), HostRun in a plain C++
// build (the phase for each tid of 0 ... G-1 in a loop, in one of three
// orders), so a host build runs the card's arithmetic (its raw additions as
// C loops, the same bits as the card's PTX chains).  An item never reads
// what another item of its phase writes; a host build run in every order
// checks that.
// Each item computes its value with the serial formulas (fp2_mul, fp2_inv,
// g2_add above, the Karatsuba Fq6 and Fq12 products of fp6_post and
// fp12_post, the G1 law of g1_add_opnd1 ...) on the same operands in the
// same order, so every value is the serial one limb for limb.  A
// dependent chain of tower steps then costs one wave of products per step
// (plus its additions and barriers), not the step's products in a row.
// Finalize runs one group of LH_COOP_THREADS (the block); Miller+fold, the
// Miller loop alone, hash-to-G2, the sigma ladder and product_chunks run
// many small groups per block, one per lane pair, message, lane or output
// lane; prepare runs sub-warp groups, several sets a warp; the sigma
// butterfly runs a cluster of blocks per chunk.  Measured on
// the H100 (the phase profile of probe_group_kernels.py): a dependent
// addition costs about a twentieth of a product, and a phase costs the serial
// sum of every item kind its warp holds, so the items of a phase share one
// code path where they can (selected operands and destinations), and the big
// item helpers are __noinline__, one copy each.

#define LH_COOP_THREADS 256  // finalize's group: the whole block
#define LH_COOP_BATCH 8      // Fq12 products per cooperative step

#if defined(__CUDACC__)
template <int G>
struct GroupRun {
  static constexpr int G_ = G;
  int t;    // this thread's index in its group
  int bar;  // 0: the group is the block; else its named barrier (1..15)
  template <class F>
  LH_MFN void operator()(F&& phase) const {
    phase(t);
    if constexpr (G < 32) {          // the group's G aligned lanes
      static_assert(32 % G == 0, "a sub-warp group divides a warp");
      __syncwarp(((1u << G) - 1u) << (threadIdx.x & (32u - G)));
    } else if constexpr (G == 32) {
      __syncwarp();
    } else if (bar == 0) {
      __syncthreads();
    } else {
      asm volatile("bar.sync %0, %1;" ::"r"(bar), "r"(G) : "memory");
    }
  }
};
#else
// order 0 runs a phase's threads 0 ... G-1, 1 runs G-1 ... 0, 2 one fixed
// shuffle: an item that reads what another item of its phase writes gives
// a different value in some order.
template <int G>
struct HostRun {
  static constexpr int G_ = G;
  int perm[G];
  explicit HostRun(int order = 0) {
    for (int t = 0; t < G; ++t) perm[t] = order == 1 ? G - 1 - t : t;
    uint32_t s = 0x9e3779b9u;
    for (int t = G - 1; order == 2 && t > 0; --t) {   // Fisher-Yates
      s = s * 1664525u + 1013904223u;
      const int j = (int)((s >> 8) % (uint32_t)(t + 1)), x = perm[t];
      perm[t] = perm[j];
      perm[j] = x;
    }
  }
  template <class F>
  void operator()(F&& phase) const {
    for (int t = 0; t < G; ++t) phase(perm[t]);
  }
};
#endif

// Items i < n of a phase, strided over the group (inside a template whose
// runner type is ``Run``).
#define LH_ITEMS(i, tid, n) for (int i = (tid); i < (n); i += Run::G_)
// List t of a phase whose lists take different branches: all of it on warp
// t mod (G/32) of the group, so a warp does not run several kinds of item
// one after the other (groups of whole warps only).
#define LH_LIST(i, tid, n, t)                                         \
  static_assert(Run::G_ % 32 == 0, "LH_LIST needs a group of warps"); \
  if (((tid) >> 5) == (t) % (Run::G_ >> 5))                           \
    for (int i = (tid)&31; i < (n); i += 32)

// Operands of Karatsuba product t (m0 = a0 b0, m1 = a1 b1, m2 = (a0 + a1)
// (b0 + b1)) of fp2_mul(x, y) (a square adds once), and fp2_mul's value
// from m0 m1 m2.
LH_FN void kara_opnd(const Fp2& x, const Fp2& y, int t, Fp& a, Fp& b) {
  if (t == 2) {
    a = fp_add(x.c0, x.c1);
    b = &x == &y ? a : fp_add(y.c0, y.c1);
  } else {
    a = t ? x.c1 : x.c0;
    b = t ? y.c1 : y.c0;
  }
}
LH_FN Fp2 kara_post(const Fp* m) {
  return {fp_sub(m[0], m[1]), fp_sub(m[2], fp_add(m[0], m[1]))};
}

// Coefficient c of an Fq6 product's value from its six Fq2 products v0 v1
// v2 v01 v12 v02, and coefficient (h, c) of an Fq12 product's value from
// its three Fq6 products v00 v11 vxx: the serial formulas as one code path
// with selects (a - b is a + (-b) bit for bit: fp_sub adds 2N - b as
// fp_neg makes it).
//   c0 = v0 + xi(v12 - (v1 + v2)), c1 = (v01 - (v0 + v1)) + xi(v2),
//   c2 = (v02 - (v0 + v2)) + v1;
//   (v00 + v v11).c = v00.c + (c ? v11.c[c-1] : xi(v11.c2)),
//   (vxx - (v00 + v11)).c = vxx.c + -(v00.c + v11.c).
LH_FN Fp2 fp6_post(const Fp2* v, int c) {
  const Fp2 t = fp2_sub(v[c == 0 ? 4 : c == 1 ? 3 : 5],
                        fp2_add(v[c == 0 ? 1 : 0], v[c == 1 ? 1 : 2]));
  const Fp2 xs = fp2_mul_by_xi(c == 0 ? t : v[2]);
  return fp2_add(c == 0 ? v[0] : t, c == 2 ? v[1] : xs);
}
LH_FN Fp2 fp12_post(const Fp6* v, int h, int c) {
  const Fp2 sum = fp2_add(v[0].c[c], v[1].c[c]);
  const Fp2 xs = fp2_mul_by_xi(v[1].c[2]);
  return fp2_add(v[h ? 2 : 0].c[c],
                 h ? fp2_neg(sum) : c ? v[1].c[c - 1] : xs);
}

// Component k of Fq2 coefficient i of an Fq12 product's Fq6 operand h (a0,
// a1, a0 + a1), and of the Fq6 product's Fq2 operand j on it (c0, c1, c2,
// c0 + c1, c1 + c2, c0 + c2).
LH_FN Fp fp12_opnd6(const Fp12& a, int h, int i, int k) {
  const Fp& u = k ? a.c[0].c[i].c1 : a.c[0].c[i].c0;
  const Fp& v = k ? a.c[1].c[i].c1 : a.c[1].c[i].c0;
  if (h == 2) return fp_add(u, v);
  return h ? v : u;
}
LH_FN Fp fp12_opnd2(const Fp12& a, int h, int j, int k) {
  if (j < 3) return fp12_opnd6(a, h, j, k);
  return fp_add(fp12_opnd6(a, h, j == 5 ? 0 : j - 3, k),
                fp12_opnd6(a, h, j == 3 ? 1 : 2, k));
}
LH_FN Fp fp12_opnd(const Fp12& a, int h, int j, int t) {
  return t < 2 ? fp12_opnd2(a, h, j, t)
               : fp_add(fp12_opnd2(a, h, j, 0), fp12_opnd2(a, h, j, 1));
}
// Operands of Montgomery product r < 54 of the Fq12 product a b: Fq6 product
// r / 18, its Fq2 product r % 18 / 3, Karatsuba product r % 3.  Each item
// recomputes the serial pre-additions it needs; a square (a and b one
// object) computes its operand once.
LH_NI void fp12_mul_opnd(const Fp12& a, const Fp12& b, int r, Fp& x, Fp& y) {
  const int h = r / 18, j = r % 18 / 3, t = r % 3;
  x = fp12_opnd(a, h, j, t);
  y = &a == &b ? x : fp12_opnd(b, h, j, t);
}

// --- the RCB addition p + q as two waves of six Fq2 products ----------------

// Coordinate c (X, Y, Z) of p, or of -p where neg.
LH_FN Fp2 g2_coord(const G2P& p, int c, bool neg) {
  return c == 0 ? p.X : c == 2 ? p.Z : neg ? fp2_neg(p.Y) : p.Y;
}
// Product r < 18 of the first wave: t0 = X X', t1 = Y Y', t2 = Z Z', pxy,
// pyz, pxz (Karatsuba product r % 3).  A doubling (p and q one point)
// computes its operand once.
LH_NI void g2_add_opnd1(const G2P& p, bool np, const G2P& q, bool nq, int r,
                        Fp& a, Fp& b) {
  const int k = r / 3;
  auto side = [k](const G2P& s, bool n) -> Fp2 {
    if (k < 3) return g2_coord(s, k, n);
    return fp2_add(g2_coord(s, k == 5 ? 0 : k - 3, n),    // X+Y, Y+Z, X+Z
                   g2_coord(s, k == 3 ? 1 : 2, n));
  };
  const Fp2 x = side(p, np);
  if (&p == &q && np == nq) {
    kara_opnd(x, x, r % 3, a, b);
  } else {
    const Fp2 y = side(q, nq);
    kara_opnd(x, y, r % 3, a, b);
  }
}
// Middle value k (s3 s4 s5 um up t0) from the first wave's products m:
// s = p - (u + v) for pxy pyz pxz, t1 -/+ b3(t2), t0; one code path but
// for the branch between the sum and b3 (a - b as a + (-b), as above).
LH_NI Fp2 g2_add_mid(const Fp* m, int k) {
  const Fp2 a = kara_post(m + 3 * (k < 3 ? 3 + k : k < 5 ? 1 : 0));
  if (k == 5) return a;
  const Fp2 b = k < 3 ? fp2_add(kara_post(m + 3 * (k == 1 ? 1 : 0)),
                                kara_post(m + 3 * (k == 0 ? 1 : 2)))
                      : g2_b3(kara_post(m + 6));
  return fp2_add(a, k == 4 ? b : fp2_neg(b));
}
// Product r < 18 of the second wave: s3 um, s4 s5, up um, t0 s5, s4 up,
// t0 s3, on the middle values mid.
LH_NI void g2_add_opnd2(const Fp2* mid, int r, Fp& a, Fp& b) {
  const int k = r / 3;
  kara_opnd(mid[(0x515410 >> (4 * k)) & 0xF], mid[(0x042323 >> (4 * k)) & 0xF],
            r % 3, a, b);
}
// Coordinate k (X Y Z) of p + q from the second wave's products m: X =
// s3um - b3(s4s5), Y = upum + 3 b3(t0s5), Z = s4up + 3 t0s3.
LH_NI Fp2 g2_add_out(const Fp* m, int k) {
  const Fp2 v = kara_post(m + 6 * k);
  Fp2 w = kara_post(m + 6 * k + 3);
  if (k < 2) w = g2_b3(w);
  if (k > 0) w = fp2_muls(w, 3);
  return fp2_add(v, k == 0 ? fp2_neg(w) : w);
}

// One wave of n Montgomery products over the group: item i takes its
// operands from opnd(i, a, b) and hands its product to put(i, r); every
// item calls fp_mul once, whatever branch chose its operands.  Then the
// phase runs extra(tid): items that neither read nor write what the
// products do.
template <class Run, class Opnd, class Put, class Extra>
LH_FN void coop_wave(const Run& run, int n, Opnd opnd, Put put, Extra extra) {
  run([&](int tid) {
    LH_ITEMS(i, tid, n) {
      Fp a, b;
      opnd(i, a, b);
      put(i, fp_mul(a, b));
    }
    extra(tid);
  });
}
template <class Run, class Opnd, class Put>
LH_FN void coop_wave(const Run& run, int n, Opnd opnd, Put put) {
  coop_wave(run, n, opnd, put, [](int) {});
}

// n RCB additions side by side (g2_add), as ONE pair of waves of 18n
// products: pts(q, a, na, b, nb) names addition q's operands (a + b, each
// negated where na, nb), out(q, k, v) takes coordinate k (X Y Z) of its
// sum.  M holds 18n products, mid 6n middle values.  out runs after both
// waves, so an addition may write its own operands.
template <class Run, class Pts, class Out>
LH_FN void coop_g2_adds(const Run& run, Fp* M, Fp2* mid, int n, Pts pts,
                        Out out) {
  auto to_m = [&](int i, const Fp& r) { M[i] = r; };
  coop_wave(run, 18 * n, [&](int i, Fp& x, Fp& y) {
    const G2P *a, *b;
    bool na, nb;
    pts(i / 18, a, na, b, nb);
    g2_add_opnd1(*a, na, *b, nb, i % 18, x, y);
  }, to_m);
  run([&](int tid) {
    LH_ITEMS(k, tid, 6 * n) mid[k] = g2_add_mid(M + 18 * (k / 6), k % 6);
  });
  coop_wave(run, 18 * n, [&](int i, Fp& x, Fp& y) {
    g2_add_opnd2(mid + 6 * (i / 18), i % 18, x, y);
  }, to_m);
  run([&](int tid) {
    LH_ITEMS(k, tid, 3 * n) out(k / 3, k % 3, g2_add_out(M + 18 * (k / 3), k % 3));
  });
}

LH_FN Fp2& g2_coord_ref(G2P& p, int c) { return c == 0 ? p.X : c == 1 ? p.Y : p.Z; }

// --- the G1 addition p + q as two waves of six products --------------------
//
// The serial law, over Fq (b3(t) = 12 t):
//   t0 = X X', t1 = Y Y', t2 = Z Z', pxy = (X + Y)(X' + Y'),
//   pyz = (Y + Z)(Y' + Z'), pxz = (X + Z)(X' + Z');
//   s3 = pxy - (t0 + t1), s4 = pyz - (t1 + t2), s5 = pxz - (t0 + t2),
//   um = t1 - b3(t2), up = t1 + b3(t2);
//   X'' = s3 um - b3(s4 s5), Y'' = up um + 3 b3(t0 s5), Z'' = s4 up + 3 t0 s3.

LH_FN Fp& g1_coord(G1P& p, int c) { return c == 0 ? p.X : c == 1 ? p.Y : p.Z; }
LH_FN const Fp& g1_coord(const G1P& p, int c) {
  return c == 0 ? p.X : c == 1 ? p.Y : p.Z;
}
// Product r < 6 of the first wave: t0 t1 t2 pxy pyz pxz.  A doubling (p and
// q one point) computes its operand once.
LH_NI void g1_add_opnd1(const G1P& p, const G1P& q, int r, Fp& a, Fp& b) {
  auto side = [r](const G1P& s) -> Fp {
    if (r < 3) return g1_coord(s, r);
    return fp_add(g1_coord(s, r == 5 ? 0 : r - 3), g1_coord(s, r == 3 ? 1 : 2));
  };
  a = side(p);
  b = &p == &q ? a : side(q);
}
// Middle value k (s3 s4 s5 um up t0) from the first wave's products m
// (a - b as a + (-b), the same bits).
LH_NI Fp g1_add_mid(const Fp* m, int k) {
  const Fp a = m[k < 3 ? 3 + k : k < 5 ? 1 : 0];
  if (k == 5) return a;
  const Fp b = k < 3 ? fp_add(m[k == 1 ? 1 : 0], m[k == 0 ? 1 : 2])
                     : g1_b3(m[2]);
  return fp_add(a, k == 4 ? b : fp_neg(b));
}
// Product r < 6 of the second wave: s3 um, s4 s5, up um, t0 s5, s4 up,
// t0 s3, on the middle values mid.
LH_FN void g1_add_opnd2(const Fp* mid, int r, Fp& a, Fp& b) {
  a = mid[(0x515410 >> (4 * r)) & 0xF];
  b = mid[(0x042323 >> (4 * r)) & 0xF];
}
// Coordinate k (X Y Z) of p + q from the second wave's products m; one
// code path with selects.
LH_NI Fp g1_add_out(const Fp* m, int k) {
  const Fp w = m[2 * k + 1], b = g1_b3(w);
  const Fp t = fp_muls(k < 2 ? b : w, 3);
  const Fp u = k == 0 ? b : t;
  return fp_add(m[2 * k], k == 0 ? fp_neg(u) : u);
}

// n G1 additions side by side (the law above), as ONE pair of waves of 6n
// products: pts(q, a, b) names addition q's operands (a + b), out(q, k, v)
// takes coordinate k of its sum.  fetch(tid) runs at the start of the first
// wave's phase and keep(tid, fetched) at its end: loads that are in flight
// while the products run (they touch nothing the additions read or write).
template <class Run, class Pts, class Out, class Fetch, class Keep>
LH_FN void coop_g1_adds(const Run& run, Fp* M, Fp* mid, int n, Pts pts,
                        Out out, Fetch fetch, Keep keep) {
  run([&](int tid) {
    const auto fetched = fetch(tid);
    LH_ITEMS(i, tid, 6 * n) {
      const G1P *a, *b;
      pts(i / 6, a, b);
      Fp x, y;
      g1_add_opnd1(*a, *b, i % 6, x, y);
      M[i] = fp_mul(x, y);
    }
    keep(tid, fetched);
  });
  run([&](int tid) {
    LH_ITEMS(k, tid, 6 * n) mid[k] = g1_add_mid(M + 6 * (k / 6), k % 6);
  });
  run([&](int tid) {
    LH_ITEMS(i, tid, 6 * n) {
      Fp x, y;
      g1_add_opnd2(mid + 6 * (i / 6), i % 6, x, y);
      M[i] = fp_mul(x, y);
    }
  });
  run([&](int tid) {
    LH_ITEMS(k, tid, 3 * n) out(k / 3, k % 3, g1_add_out(M + 6 * (k / 3), k % 3));
  });
}

// After a wave of n Fq12 products (product q's 54 at M + q*stride): their
// Fq2 values (V, 18 each), Fq6 values (W, 3 each), and coefficient (h, c)
// of product q handed to out(q, h, c, value).
template <class Run, class Out>
LH_FN void coop_fp12_post(const Run& run, const Fp* M, Fp2* V, Fp6* W, int n,
                          int stride, Out out) {
  run([&](int tid) {
    LH_ITEMS(i, tid, 18 * n) V[i] = kara_post(M + i / 18 * stride + 3 * (i % 18));
  });
  run([&](int tid) {
    LH_ITEMS(i, tid, 9 * n) W[i / 3].c[i % 3] = fp6_post(V + 6 * (i / 3), i % 3);
  });
  run([&](int tid) {
    LH_ITEMS(i, tid, 6 * n) {
      const int q = i / 6, h = i % 6 / 3, c = i % 3;
      out(q, h, c, fp12_post(W + 3 * q, h, c));
    }
  });
}

// n Fq12 products side by side: ONE wave of their 54n Montgomery products
// (item i's operands from opnd(i, x, y), fp12_mul_opnd of product i / 54;
// product q's 54 at M + 54q), then coop_fp12_post handing coefficient (h,
// c) of product q to out(q, h, c, value).
template <class Run, class Opnd, class Out>
LH_FN void coop_fp12_muls(const Run& run, Fp* M, Fp2* V, Fp6* W, int n,
                          Opnd opnd, Out out) {
  coop_wave(run, 54 * n, opnd, [&](int i, const Fp& r) { M[i] = r; });
  coop_fp12_post(run, M, V, W, n, 54, out);
}

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
    LH_ITEMS(k, tid, n) s.X[k] = kara_post(s.M + 3 * k);
  });
}

// W6[k] <- A6[k] * B6[k], k < n (Karatsuba: v0 v1 v2 v01 v12 v02).
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
    LH_ITEMS(i, tid, 3 * n)
      s.W6[i / 3].c[i % 3] = fp6_post(s.X + 6 * (i / 3), i % 3);
  });
}

// d[k] <- a[k] * b[k], k < n <= LH_COOP_BATCH (Karatsuba); d may be a or b.
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
      d[k].c[h].c[c] = fp12_post(s.W6 + 3 * k, h, c);
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

// Threads a group (G) and groups a block of the group kernels, chosen by
// the launch-shape table of probe_group_kernels.py on the H100 (PERF.md),
// and the most threads a block of them may have; the sigma butterfly's
// cluster of blocks per chunk and its threads a block (one product of a
// wave each: 18 per addition, LH_LANES / LH_SIGMA_CLUSTER additions).
#define LH_GROUP_BLOCK_MAX 256
#define LH_MILLER_G 64
#define LH_MILLER_GROUPS 2
#define LH_HASH_G 32
#define LH_HASH_GROUPS 2
#define LH_SIGMA_G 32
#define LH_SIGMA_GROUPS 2
#define LH_PREP_G 16
#define LH_PREP_GROUPS 2
#define LH_PCHUNK_G 64
#define LH_PCHUNK_GROUPS 2
#define LH_MLOOP_G 64          // the Miller loop alone
#define LH_MLOOP_GROUPS 2
#define LH_SIGMA_CLUSTER 8
#define LH_SIGMA_FOLD_LANES (LH_LANES / LH_SIGMA_CLUSTER)
#define LH_SIGMA_FOLD_THREADS (18 * LH_SIGMA_FOLD_LANES)

// ---------------------------------------------------------------------------
// Miller loops: one group per lane pair
// ---------------------------------------------------------------------------
//
// The conjugated Miller loop of each live lane of the pair (the formulas
// of the plain version's miller_dbl_step, miller_add_step and miller_loop
// in crypto/pairing_kernel.py, in their order; a dead lane skips it and is
// Fq12 ONE), in three pieces: miller_pair_load, miller_pair_loop, and a
// tail.  Miller+fold (miller_fold_body) pairs lanes j and j + 128 of a
// 256-lane cell and stores f_j * f_{j+128}; the Miller loop alone
// (miller_body) pairs lanes 2p and 2p + 1 and stores both values.
// A doubling step is four waves of products for both live lanes at once:
//   W1  f*f beside the line's XX YY ZZ and g2_add(T, T)'s first wave
//   W2  X*XX, YY*Z, XX*Z, Y*ZZ beside g2_add's second wave
//   W3  B = -(3 X2Z)*xP, C = (2 YZ2)*yP into the dense line
//   W4  (f*f)*line
// and an addition step three (Q.Y*T.Z, Q.X*T.Z and g2_add(T, Q)'s first
// wave; Nn*Q.X, Q.Y*Dd, Nn*xP, Dd*yP and the second wave; f*line).  The
// line stays the dense Fq12 of line_fp12.

struct MillerLane {
  Fp12 f, l;         // the Miller value; the line (A, B, 0; 0, C, 0)
  G2P T, Q;          // Q = (Qx, Qy, 1)
  Fp xP, yP;
  Fp2 sq[3];         // XX YY ZZ of a doubling step
  Fp2 mid[6];        // g2_add's middle values
  Fp2 Nn, Dd;        // the addition step's line values
};

struct MillerShared {
  MillerLane L[2];   // lane j, lane j + 128
  Fp M[2 * 81];      // the products of one wave (81 a lane at most)
  Fp2 V[2 * 18];     // Fq2 values of the Fq12 products
  Fp6 W[2 * 3];      // their Fq6 values
  int live[2], nl;   // the live lanes of the pair
};

// f <- f^2 * l_{T,T}(P), T <- 2T for the live lanes (miller_dbl).
template <class Run>
LH_NI void miller_dbl_group(const Run& run, MillerShared& sh) {
  const int nl = sh.nl;
  auto lane = [&](int q) -> MillerLane& { return sh.L[sh.live[q]]; };
  auto to_m = [&](int i, const Fp& r) { sh.M[i] = r; };
  coop_wave(run, 81 * nl, [&](int i, Fp& a, Fp& b) {
    const MillerLane& L = lane(i / 81);
    const int r = i % 81;
    if (r < 54) {
      fp12_mul_opnd(L.f, L.f, r, a, b);
    } else if (r < 63) {
      const Fp2& c = r < 57 ? L.T.X : r < 60 ? L.T.Y : L.T.Z;
      kara_opnd(c, c, r % 3, a, b);
    } else {
      g2_add_opnd1(L.T, false, L.T, false, r - 63, a, b);
    }
  }, to_m);
  run([&](int tid) {
    LH_LIST(i, tid, 18 * nl, 0)
      sh.V[i] = kara_post(sh.M + i / 18 * 81 + 3 * (i % 18));
    LH_LIST(i, tid, 3 * nl, 1)
      lane(i / 3).sq[i % 3] = kara_post(sh.M + i / 3 * 81 + 54 + 3 * (i % 3));
    LH_LIST(i, tid, 6 * nl, 2)
      lane(i / 6).mid[i % 6] = g2_add_mid(sh.M + i / 6 * 81 + 63, i % 6);
  });
  coop_wave(run, 30 * nl, [&](int i, Fp& a, Fp& b) {
    const MillerLane& L = lane(i / 30);
    const int r = i % 30, k = r / 3;
    if (r < 12) {    // X3 = X XX, Y2Z = YY Z, X2Z = XX Z, YZ2 = Y ZZ
      kara_opnd(k == 0 ? L.T.X : k == 1 ? L.sq[1] : k == 2 ? L.sq[0] : L.T.Y,
                k == 0 ? L.sq[0] : k == 3 ? L.sq[2] : L.T.Z, r % 3, a, b);
    } else {
      g2_add_opnd2(L.mid, r - 12, a, b);
    }
  }, to_m, [&](int tid) {
    LH_LIST(i, tid, 9 * nl, 3)
      sh.W[i / 3].c[i % 3] = fp6_post(sh.V + 6 * (i / 3), i % 3);
  });
  coop_wave(run, 4 * nl, [&](int i, Fp& a, Fp& b) {
    const MillerLane& L = lane(i / 4);
    const int r = i % 4;
    const Fp2 v = kara_post(sh.M + i / 4 * 30 + (r < 2 ? 6 : 9));  // X2Z, YZ2
    a = fp_muls(r & 1 ? v.c1 : v.c0, r < 2 ? 3 : 2);
    b = r < 2 ? L.xP : L.yP;
  }, [&](int i, const Fp& r) {
    Fp2& c = i % 4 < 2 ? lane(i / 4).l.c[0].c[1] : lane(i / 4).l.c[1].c[1];
    if (i % 4 < 2) (i & 1 ? c.c1 : c.c0) = fp_neg(r);
    else (i & 1 ? c.c1 : c.c0) = r;
  }, [&](int tid) {  // f <- f*f; T <- 2T; A = 3 X3 - 2 Y2Z
    LH_LIST(i, tid, 6 * nl, 1) {
      const int h = i % 6 / 3, c = i % 3;
      lane(i / 6).f.c[h].c[c] = fp12_post(sh.W + 3 * (i / 6), h, c);
    }
    LH_LIST(i, tid, 3 * nl, 2) {
      G2P& T = lane(i / 3).T;
      (i % 3 == 0 ? T.X : i % 3 == 1 ? T.Y : T.Z) =
          g2_add_out(sh.M + i / 3 * 30 + 12, i % 3);
    }
    LH_LIST(i, tid, nl, 3) {
      const Fp* m = sh.M + i * 30;
      lane(i).l.c[0].c[0] = fp2_sub(fp2_muls(kara_post(m), 3),
                                    fp2_muls(kara_post(m + 3), 2));
    }
  });
  coop_wave(run, 54 * nl, [&](int i, Fp& a, Fp& b) {
    const MillerLane& L = lane(i / 54);
    fp12_mul_opnd(L.f, L.l, i % 54, a, b);
  }, to_m);
  coop_fp12_post(run, sh.M, sh.V, sh.W, nl, 54,
                 [&](int q, int h, int c, const Fp2& v) {
                   lane(q).f.c[h].c[c] = v;
                 });
}

// f <- f * l_{T,Q}(P), T <- T + Q for the live lanes (miller_add).
template <class Run>
LH_NI void miller_add_group(const Run& run, MillerShared& sh) {
  const int nl = sh.nl;
  auto lane = [&](int q) -> MillerLane& { return sh.L[sh.live[q]]; };
  auto to_m = [&](int i, const Fp& r) { sh.M[i] = r; };
  coop_wave(run, 24 * nl, [&](int i, Fp& a, Fp& b) {
    const MillerLane& L = lane(i / 24);
    const int r = i % 24;
    if (r < 6) kara_opnd(r < 3 ? L.Q.Y : L.Q.X, L.T.Z, r % 3, a, b);
    else g2_add_opnd1(L.T, false, L.Q, false, r - 6, a, b);
  }, to_m);
  run([&](int tid) {  // Nn = Q.Y T.Z - T.Y, Dd = Q.X T.Z - T.X; g2_add's middle
    LH_LIST(i, tid, 2 * nl, 0) {
      MillerLane& L = lane(i / 2);
      const Fp2 v = kara_post(sh.M + i / 2 * 24 + 3 * (i % 2));
      if (i % 2) L.Dd = fp2_sub(v, L.T.X);
      else L.Nn = fp2_sub(v, L.T.Y);
    }
    LH_LIST(i, tid, 6 * nl, 1)
      lane(i / 6).mid[i % 6] = g2_add_mid(sh.M + i / 6 * 24 + 6, i % 6);
  });
  coop_wave(run, 28 * nl, [&](int i, Fp& a, Fp& b) {
    const MillerLane& L = lane(i / 28);
    const int r = i % 28;
    if (r < 6) {     // Nn Q.X, Q.Y Dd
      kara_opnd(r < 3 ? L.Nn : L.Q.Y, r < 3 ? L.Q.X : L.Dd, r % 3, a, b);
    } else if (r < 24) {
      g2_add_opnd2(L.mid, r - 6, a, b);
    } else {         // Nn xP, Dd yP
      const Fp2& v = r < 26 ? L.Nn : L.Dd;
      a = r & 1 ? v.c1 : v.c0;
      b = r < 26 ? L.xP : L.yP;
    }
  }, [&](int i, const Fp& r) {
    const int k = i % 28;
    Fp12& l = lane(i / 28).l;
    if (k < 24) sh.M[i] = r;
    else if (k < 26) (k & 1 ? l.c[0].c[1].c1 : l.c[0].c[1].c0) = fp_neg(r);
    else (k & 1 ? l.c[1].c[1].c1 : l.c[1].c[1].c0) = r;
  });
  run([&](int tid) {  // T <- T + Q; A = Nn Q.X - Q.Y Dd
    LH_LIST(i, tid, 3 * nl, 0) {
      G2P& T = lane(i / 3).T;
      (i % 3 == 0 ? T.X : i % 3 == 1 ? T.Y : T.Z) =
          g2_add_out(sh.M + i / 3 * 28 + 6, i % 3);
    }
    LH_LIST(i, tid, nl, 1) {
      const Fp* m = sh.M + i * 28;
      lane(i).l.c[0].c[0] = fp2_sub(kara_post(m), kara_post(m + 3));
    }
  });
  coop_wave(run, 54 * nl, [&](int i, Fp& a, Fp& b) {
    const MillerLane& L = lane(i / 54);
    fp12_mul_opnd(L.f, L.l, i % 54, a, b);
  }, to_m);
  coop_fp12_post(run, sh.M, sh.V, sh.W, nl, 54,
                 [&](int q, int h, int c, const Fp2& v) {
                   lane(q).f.c[h].c[c] = v;
                 });
}

// The load phase of lanes a and b (sh.L[0], sh.L[1]) of the (64, m) g1
// and (128, m) g2 planes: P, Q, T = Q, f = ONE, and the live-lane list
// (lane q is live where live(q)).
template <class Run, class Live>
LH_FN void miller_pair_load(const Run& run, MillerShared& sh,
                            const int32_t* g1, const int32_t* g2, long long m,
                            long long a, long long b, Live live) {
  run([&](int tid) {
    LH_ITEMS(q, tid, 2) {
      const long long lane = q ? b : a;
      MillerLane& L = sh.L[q];
      L.xP = load_fp(g1, m, lane, 0);
      L.yP = load_fp(g1, m, lane, 1);
      L.Q = {load_fp2(g2, m, lane, 0), load_fp2(g2, m, lane, 2), fp2_one()};
      L.T = L.Q;
      L.f = fp12_one();
      L.l = line_fp12(fp2_zero(), fp2_zero(), fp2_zero());
    }
    if (tid == 0) {
      sh.nl = 0;
      for (int q = 0; q < 2; ++q)
        if (live(q)) sh.live[sh.nl++] = q;
    }
  });
}

// The live lanes' Miller loops: a doubling step per bit of |x| below its
// top, an addition step per set bit, then the conjugation (x < 0).
template <class Run>
LH_FN void miller_pair_loop(const Run& run, MillerShared& sh) {
  if (!sh.nl) return;
#pragma unroll 1
  for (int b = (int)KC.x_bits - 2; b >= 0; --b) {
    miller_dbl_group(run, sh);
    if (exp_bit(KC.xabs, (uint32_t)b)) miller_add_group(run, sh);
  }
  run([&](int tid) {
    LH_ITEMS(i, tid, 3 * sh.nl) {
      Fp2& c = sh.L[sh.live[i / 3]].f.c[1].c[i % 3];
      c = fp2_neg(c);
    }
  });
}

// The pair ``pair`` (cell pair / 128, lane j = pair % 128) of the (64, m)
// g1, (128, m) g2 and (1, m) mask planes: both lanes' Miller values (ONE
// where the mask is 0), their product stored at column ``pair`` of the
// (384, m/2) output.
template <class Run>
LH_FN void miller_fold_body(const Run& run, MillerShared& sh,
                            const int32_t* g1, const int32_t* g2,
                            const int32_t* mask, int32_t* out, long long m,
                            long long pair) {
  const long long base = pair / LH_LANES * 2 * LH_LANES + pair % LH_LANES;
  miller_pair_load(run, sh, g1, g2, m, base, base + LH_LANES,
                   [&](int q) { return mask[base + q * LH_LANES] != 0; });
  miller_pair_loop(run, sh);
  coop_wave(run, 54, [&](int i, Fp& a, Fp& b) {
    fp12_mul_opnd(sh.L[0].f, sh.L[1].f, i, a, b);
  }, [&](int i, const Fp& r) { sh.M[i] = r; });
  coop_fp12_post(run, sh.M, sh.V, sh.W, 1, 54,
                 [&](int, int h, int c, const Fp2& v) {
                   store_fp2(out, m / 2, pair, 2 * (3 * h + c), v);
                 });
}

// The Miller loop alone: pair ``pair`` is lanes 2·pair and 2·pair + 1 of
// the (64, m) g1 and (128, m) g2 planes (m even), both live; each lane's
// conjugated Miller value stored at its own column of the (384, m)
// output, one Fq block an item.
template <class Run>
LH_FN void miller_body(const Run& run, MillerShared& sh, const int32_t* g1,
                       const int32_t* g2, int32_t* out, long long m,
                       long long pair) {
  miller_pair_load(run, sh, g1, g2, m, 2 * pair, 2 * pair + 1,
                   [](int) { return true; });
  miller_pair_loop(run, sh);
  run([&](int tid) {
    LH_ITEMS(i, tid, 24)
      store_fp(out, m, 2 * pair + i / 12, i % 12,
               fp12_block(sh.L[i / 12].f, i % 12));
  });
}

// ---------------------------------------------------------------------------
// Lane products: product_chunks and the roll butterfly
// ---------------------------------------------------------------------------
//
// Output lane ``lane`` (chunk lane / 128, j = lane % 128) of
// product_chunks' (384, m/2) output is f_a · f_{a+128}, a = chunk · 256 +
// j, each operand ONE where the mask is 0 (masked_block): a load phase of
// the 24 Fq blocks, one wave of the Fq12 product's 54 Montgomery products,
// and its post phases storing the 12 blocks (coop_fp12_muls), one group
// per output lane.  The group runs one product: latency, not issue, bounds
// it.

// Fq block ``blk`` of lane ``col`` of an Fq12 plane, or of ONE where the
// mask is 0.
LH_FN Fp masked_block(const int32_t* f, const int32_t* mask, long long m,
                      long long col, int blk) {
  return mask[col] != 0 ? load_fp(f, m, col, blk)
                        : blk == 0 ? KC.ONE : fp_zero();
}

struct PairShared {
  Fp12 A[2];         // the operands
  Fp M[54];
  Fp2 V[18];
  Fp6 W[3];
};

template <class Run>
LH_FN void product_pair_body(const Run& run, PairShared& sh, const int32_t* f,
                             const int32_t* mask, int32_t* out, long long m,
                             long long lane) {
  const long long a = lane / LH_LANES * 2 * LH_LANES + lane % LH_LANES;
  run([&](int tid) {
    LH_ITEMS(i, tid, 24) {
      const long long col = a + i / 12 * LH_LANES;
      const int blk = i % 12;
      fp12_block(sh.A[i / 12], blk) = masked_block(f, mask, m, col, blk);
    }
  });
  coop_fp12_muls(run, sh.M, sh.V, sh.W, 1, [&](int i, Fp& x, Fp& y) {
    fp12_mul_opnd(sh.A[0], sh.A[1], i, x, y);
  }, [&](int, int h, int c, const Fp2& v) {
    store_fp2(out, m / 2, lane, 2 * (3 * h + c), v);
  });
}

// The roll butterfly (lh_product_kernel): a block per residue class t mod
// 128 of the (384, M) plane, M = 128R a power of two.  Its lanes t + 128r,
// r < R, sit in shared memory, double-buffered: the masked lanes are loaded
// into buffer 0, then level v = R/2 ... 1 sets lane r to the product of
// lane r and lane (r + v) mod R of the previous level (the plain version's
// roll by w = 128v: lane r first, its partner second), read from one
// buffer and written to the other; the last level (v = 1) stores to out,
// and at R = 1 the load stores the masked input.  A class never reads
// another (every roll is a multiple of 128 lanes), so a level ends at the
// block's barrier.  The block runs ``groups`` groups of G threads; in a
// level, group g takes ``lanes`` lanes at a time (r0 = g * lanes, then r0
// + groups * lanes ...) as ONE wave of their 54 * lanes products and
// their post phases, on its own ProductWave.  A level's chain is one wave:
// log2(R) waves in all, where one thread a class ran R log2(R) Fq12
// products in a row.

#define LH_PRODUCT_G 64          // threads a group
#define LH_PRODUCT_LANES 1       // lanes of a class a group's wave takes
#define LH_PRODUCT_GROUPS_MAX 8  // groups a block (named barriers 1..8)
#define LH_PRODUCT_R_MAX 128     // lanes a class: 2 x 128 Fq12 in 227 KB

template <int K>
struct ProductWave {   // one group's wave of up to K Fq12 products
  Fp M[54 * K];
  Fp2 V[18 * K];
  Fp6 W[3 * K];
};

// R lanes a class, lanes a group's wave, groups a block, at M = m lanes
// and waves of at most K lanes (host and card).
struct ProductShape {
  int R, lanes, groups;
};
#if defined(__CUDACC__)
__host__ __device__ __forceinline__
#else
static inline
#endif
ProductShape product_shape(long long m, int K) {
  const int R = (int)(m / LH_LANES), k = R < K ? R : K, n = R / k;
  return {R, k, n < LH_PRODUCT_GROUPS_MAX ? n : LH_PRODUCT_GROUPS_MAX};
}

// Group g's share of the load: lanes g, g + groups, ... of class t.
template <class Run>
LH_FN void product_class_load(const Run& run, Fp12* buf, const int32_t* f,
                              const int32_t* mask, int32_t* out, long long m,
                              int t, const ProductShape& s, int g) {
  run([&](int tid) {
    LH_ITEMS(i, tid, 12 * (s.R / s.groups)) {
      const int r = g + s.groups * (i / 12), blk = i % 12;
      const long long col = (long long)r * LH_LANES + t;
      const Fp v = masked_block(f, mask, m, col, blk);
      if (s.R == 1)
        store_fp(out, m, col, blk, v);
      else
        fp12_block(buf[r], blk) = v;
    }
  });
}

// Group g's lanes of level v: cur holds the previous level, next (or, at v
// = 1, out) takes this one.
template <int K, class Run>
LH_FN void product_class_level(const Run& run, ProductWave<K>& sh,
                               const Fp12* cur, Fp12* next, int32_t* out,
                               long long m, int t, const ProductShape& s,
                               int g, int v) {
#pragma unroll 1
  for (int r0 = g * s.lanes; r0 < s.R; r0 += s.groups * s.lanes)
    coop_fp12_muls(run, sh.M, sh.V, sh.W, s.lanes, [&](int i, Fp& x, Fp& y) {
      const int r = r0 + i / 54;
      fp12_mul_opnd(cur[r], cur[(r + v) & (s.R - 1)], i % 54, x, y);
    }, [&](int q, int h, int c, const Fp2& val) {
      const int r = r0 + q;
      if (v == 1)
        store_fp2(out, m, (long long)r * LH_LANES + t, 2 * (3 * h + c), val);
      else
        next[r].c[h].c[c] = val;
    });
}

// Class t's butterfly: ``groups(fn)`` runs fn(g) for the block's groups g
// (on the card this thread's group, then the block's barrier), ``run`` the
// phases of a group.  buf holds 2R lanes, waves one ProductWave a group.
template <int K, class Run, class Groups>
LH_FN void product_class_body(const Run& run, const Groups& groups, Fp12* buf,
                              ProductWave<K>* waves, const int32_t* f,
                              const int32_t* mask, int32_t* out, long long m,
                              int t) {
  const ProductShape s = product_shape(m, K);
  groups([&](int g) { product_class_load(run, buf, f, mask, out, m, t, s, g); });
  int cur = 0;
#pragma unroll 1
  for (int v = s.R / 2; v >= 1; v >>= 1, cur ^= 1)
    groups([&](int g) {
      product_class_level<K>(run, waves[g], buf + cur * s.R,
                             buf + (cur ^ 1) * s.R, out, m, t, s, g, v);
    });
}

#if defined(__CUDACC__)
// Block t (blockIdx.x) of the butterfly, groups of G threads, its shared
// memory the 2R lanes and then a ProductWave<K> a group.
struct BlockGroups {
  int g;   // this thread's group
  template <class F>
  LH_MFN void operator()(F&& fn) const {
    fn(g);
    __syncthreads();
  }
};

template <int G, int K>
LH_FN void product_classes(const int32_t* f, const int32_t* mask,
                           int32_t* out, long long m) {
  extern __shared__ __align__(16) unsigned char lh_group_smem[];
  const int gi = threadIdx.x / G, groups = blockDim.x / G;
  Fp12* buf = reinterpret_cast<Fp12*>(lh_group_smem);
  product_class_body<K>(
      GroupRun<G>{(int)threadIdx.x % G, groups == 1 ? 0 : 1 + gi},
      BlockGroups{gi}, buf,
      reinterpret_cast<ProductWave<K>*>(buf + 2 * (m / LH_LANES)), f, mask,
      out, m, (int)blockIdx.x);
}

// Launch ``kernel`` (a product_classes<G, K> kernel) on the (384, m)
// plane: 128 blocks, product_shape's groups of G threads each, the dynamic
// shared memory opted in above 48 KB.  m must be a power of two with 128
// <= m <= 128 LH_PRODUCT_R_MAX.
template <int G, int K>
static int launch_product(void (*kernel)(const int32_t*, const int32_t*,
                                         int32_t*, long long),
                          const int32_t* f, const int32_t* mask, int32_t* out,
                          long long m, void* stream) {
  static_assert(G >= 32 && G * LH_PRODUCT_GROUPS_MAX <= 1024, "launch shape");
  if (m < LH_LANES || m > (long long)LH_LANES * LH_PRODUCT_R_MAX ||
      (m & (m - 1)))
    return (int)cudaErrorInvalidValue;
  const ProductShape s = product_shape(m, K);
  const int bytes = 2 * s.R * (int)sizeof(Fp12) +
                    s.groups * (int)sizeof(ProductWave<K>);
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return (int)e;
  kernel<<<LH_LANES, G * s.groups, bytes, (cudaStream_t)stream>>>(f, mask,
                                                                  out, m);
  return (int)cudaGetLastError();
}
#endif

// ---------------------------------------------------------------------------
// Hash to G2: one group per message
// ---------------------------------------------------------------------------
//
// u0 and u1 side by side through the simplified SWU map onto E' (the
// branchless 8-candidate square root; both branches of the QR select are
// computed and the right one kept) and the 3-isogeny, then q(u0) + q(u1),
// Budroni-Pintore cofactor clearing and the affine point, one wave of
// products per step.  The formulas are the plain version's
// (crypto/htc_kernel.py: k_sswu_map, k_fq2_pow_e16, k_iso_map_proj,
// k_clear_cofactor, fq2_inv) in its order.  The Fermat ladders of the two
// inversions stay one thread's serial chain.

struct HashLane {    // one u value
  Fp2 t, tt, tv1, tv2, tv1t, x1, x1sq, ax1, tv1x1, gx1, zgx1, res, base;
  Fp2 cand[8], y1, s, x, y;
  Fp2 x2, x3, xn, xd, yp, yd, yn;
  G2P q;             // its point on E, projective
  Fp ni;
  int sgn_t, d_zero, is_qr, ok[8];
};

struct HashShared {
  HashLane L[2];     // u0, u1
  G2P p, acc, t1, u;
  Fp2 mid[6], zi;
  Fp M[54];          // the products of one wave (27 a lane at most)
  Fp ni;
};

// RFC 9380 sgn0 over Fq2 from the two mont_mul(c, 1) products of an
// element (its canonical value, minus N where it is above).
LH_FN int sgn0_of(const Fp& m0, const Fp& m1) {
  const Fp c0 = fp_cond_sub(m0, KC.N), c1 = fp_cond_sub(m1, KC.N);
  const uint32_t z0 = fp_eq(c0, fp_zero()) ? 1u : 0u;
  return (int)((c0.w[0] & 1u) | (z0 & (c1.w[0] & 1u)));
}

// A wave of ``per`` products for each u lane, product r of lane q from
// opnd(L, r, a, b) into M[q*per + r]; then ``n`` items a lane,
// post(L, m, k) with m the lane's products.
template <class Run, class Opnd>
LH_FN void hash_wave(const Run& run, HashShared& sh, int per, Opnd opnd) {
  coop_wave(run, 2 * per, [&](int i, Fp& a, Fp& b) {
    opnd((const HashLane&)sh.L[i / per], i % per, a, b);
  }, [&](int i, const Fp& r) { sh.M[i] = r; });
}
template <class Run, class Post>
LH_FN void hash_post(const Run& run, HashShared& sh, int per, int n, Post post) {
  run([&](int tid) {
    LH_ITEMS(i, tid, 2 * n) post(sh.L[i / n], sh.M + i / n * per, i % n);
  });
}

// SSWU then the isogeny for both u lanes: L.t -> L.q.
template <class Run>
LH_NI void hash_map_group(const Run& run, HashShared& sh) {
  // tt = t^2; t's canonical words for sgn0(t)
  hash_wave(run, sh, 5, [](const HashLane& L, int r, Fp& a, Fp& b) {
    if (r < 3) {
      kara_opnd(L.t, L.t, r, a, b);
    } else {
      a = r == 3 ? L.t.c0 : L.t.c1;
      b = KC.RAW_ONE;
    }
  });
  hash_post(run, sh, 5, 2, [](HashLane& L, const Fp* m, int k) {
    if (k == 0) L.tt = kara_post(m);
    else L.sgn_t = sgn0_of(m[3], m[4]);
  });
  // tv1 = Z t^2
  hash_wave(run, sh, 3, [](const HashLane& L, int r, Fp& a, Fp& b) {
    kara_opnd(KC.H_Z, L.tt, r, a, b);
  });
  hash_post(run, sh, 3, 1,
            [](HashLane& L, const Fp* m, int) { L.tv1 = kara_post(m); });
  // tv2 = tv1^2 + tv1, and tv1 t
  hash_wave(run, sh, 6, [](const HashLane& L, int r, Fp& a, Fp& b) {
    kara_opnd(L.tv1, r < 3 ? L.tv1 : L.t, r % 3, a, b);
  });
  hash_post(run, sh, 6, 2, [](HashLane& L, const Fp* m, int k) {
    if (k == 0) {
      L.tv2 = fp2_add(kara_post(m), L.tv1);
      L.d_zero = fp2_is_zero(L.tv2);
    } else {
      L.tv1t = kara_post(m + 3);
    }
  });
  // 1/tv2 (fp2_inv): the norm's squares, the Fermat ladder, the products
  hash_wave(run, sh, 2, [](const HashLane& L, int r, Fp& a, Fp& b) {
    a = b = r ? L.tv2.c1 : L.tv2.c0;
  });
  run([&](int tid) {
    LH_ITEMS(q, tid, 2) sh.L[q].ni = fp_inv(fp_add(sh.M[2 * q], sh.M[2 * q + 1]));
  });
  hash_wave(run, sh, 2, [](const HashLane& L, int r, Fp& a, Fp& b) {
    a = r ? fp_neg(L.tv2.c1) : L.tv2.c0;
    b = L.ni;
  });
  hash_post(run, sh, 2, 1, [](HashLane& L, const Fp* m, int) {
    L.x1 = fp2_add(fp2_one(), Fp2{m[0], m[1]});
  });
  // x1 = NEGBA (1 + 1/tv2), the exceptional x1 where tv2 = 0
  hash_wave(run, sh, 3, [](const HashLane& L, int r, Fp& a, Fp& b) {
    kara_opnd(KC.H_NEGBA, L.x1, r, a, b);
  });
  hash_post(run, sh, 3, 1, [](HashLane& L, const Fp* m, int) {
    L.x1 = L.d_zero ? KC.H_X1EXC : kara_post(m);
  });
  // x1^2, A x1, tv1 x1
  hash_wave(run, sh, 9, [](const HashLane& L, int r, Fp& a, Fp& b) {
    kara_opnd(r < 3 ? L.x1 : r < 6 ? KC.H_A : L.tv1, L.x1, r % 3, a, b);
  });
  hash_post(run, sh, 9, 3, [](HashLane& L, const Fp* m, int k) {
    (k == 0 ? L.x1sq : k == 1 ? L.ax1 : L.tv1x1) = kara_post(m + 3 * k);
  });
  // gx1 = x1^3 + (A x1 + B)
  hash_wave(run, sh, 3, [](const HashLane& L, int r, Fp& a, Fp& b) {
    kara_opnd(L.x1sq, L.x1, r, a, b);
  });
  hash_post(run, sh, 3, 1, [](HashLane& L, const Fp* m, int) {
    L.gx1 = fp2_add(kara_post(m), fp2_add(L.ax1, KC.H_B));
    L.res = fp2_one();
    L.base = L.gx1;
  });
  // c = gx1^((p^2 + 7)/16), LSB first: res*base and base^2 in one wave
#pragma unroll 1
  for (uint32_t i = 0; i < KC.e16_bits; ++i) {
    const int bit = (int)exp_bit(KC.e16, i), per = 3 + 3 * bit;
    hash_wave(run, sh, per, [&](const HashLane& L, int r, Fp& a, Fp& b) {
      kara_opnd(r < 3 && bit ? L.res : L.base, L.base, r % 3, a, b);
    });
    hash_post(run, sh, per, 1 + bit, [&](HashLane& L, const Fp* m, int k) {
      *(k < bit ? &L.res : &L.base) = kara_post(m + 3 * k);
    });
  }
  // the candidates c E8I[k], c TK[k], and Z gx1
  hash_wave(run, sh, 27, [](const HashLane& L, int r, Fp& a, Fp& b) {
    const int k = r / 3;
    kara_opnd(k < 8 ? L.res : KC.H_Z,
              k < 4 ? KC.E8I[k] : k < 8 ? KC.TK[k - 4] : L.gx1, r % 3, a, b);
  });
  hash_post(run, sh, 27, 9, [](HashLane& L, const Fp* m, int k) {
    (k < 8 ? L.cand[k] : L.zgx1) = kara_post(m + 3 * k);
  });
  // their squares against gx1 and Z gx1; the last match wins
  hash_wave(run, sh, 24, [](const HashLane& L, int r, Fp& a, Fp& b) {
    kara_opnd(L.cand[r / 3], L.cand[r / 3], r % 3, a, b);
  });
  hash_post(run, sh, 24, 8, [](HashLane& L, const Fp* m, int k) {
    L.ok[k] = fp2_eq(kara_post(m + 3 * k), k < 4 ? L.gx1 : L.zgx1);
  });
  hash_post(run, sh, 24, 1, [](HashLane& L, const Fp*, int) {
    L.y1 = fp2_zero();
    L.s = fp2_zero();
    L.is_qr = 0;
    for (int k = 0; k < 4; ++k) {
      if (L.ok[k]) {
        L.y1 = L.cand[k];
        L.is_qr = 1;
      }
      if (L.ok[4 + k]) L.s = L.cand[4 + k];
    }
  });
  // (x, y) = (x1, y1) where gx1 is square, else (tv1 x1, (tv1 t) s)
  hash_wave(run, sh, 3, [](const HashLane& L, int r, Fp& a, Fp& b) {
    kara_opnd(L.tv1t, L.s, r, a, b);
  });
  hash_post(run, sh, 3, 1, [](HashLane& L, const Fp* m, int) {
    L.x = L.is_qr ? L.x1 : L.tv1x1;
    L.y = L.is_qr ? L.y1 : kara_post(m);
  });
  // sgn0(y) = sgn0(t)
  hash_wave(run, sh, 2, [](const HashLane& L, int r, Fp& a, Fp& b) {
    a = r ? L.y.c1 : L.y.c0;
    b = KC.RAW_ONE;
  });
  hash_post(run, sh, 2, 1, [](HashLane& L, const Fp* m, int) {
    if (L.sgn_t != sgn0_of(m[0], m[1])) L.y = fp2_neg(L.y);
  });
  // the isogeny: x^2 and the x terms; x^3 and the x^2 terms; the x^3
  // terms and XD YD; y YP and XN YD; YN XD
  hash_wave(run, sh, 15, [](const HashLane& L, int r, Fp& a, Fp& b) {
    const int k = r / 3;
    kara_opnd(k == 0 ? L.x : k == 1 ? KC.XN[1] : k == 2 ? KC.XD[1]
                     : k == 3 ? KC.YN[1] : KC.YD[1], L.x, r % 3, a, b);
  });
  hash_post(run, sh, 15, 5, [](HashLane& L, const Fp* m, int k) {
    const Fp2 v = kara_post(m + 3 * k);
    if (k == 0) L.x2 = v;
    else if (k == 1) L.xn = fp2_add(KC.XN[0], v);
    else if (k == 2) L.xd = fp2_add(fp2_add(KC.XD[0], v), kara_post(m));
    else if (k == 3) L.yp = fp2_add(KC.YN[0], v);
    else L.yd = fp2_add(KC.YD[0], v);
  });
  hash_wave(run, sh, 12, [](const HashLane& L, int r, Fp& a, Fp& b) {
    const int k = r / 3;
    kara_opnd(k == 0 ? L.x2 : k == 1 ? KC.XN[2] : k == 2 ? KC.YN[2] : KC.YD[2],
              k == 0 ? L.x : L.x2, r % 3, a, b);
  });
  hash_post(run, sh, 12, 4, [](HashLane& L, const Fp* m, int k) {
    const Fp2 v = kara_post(m + 3 * k);
    if (k == 0) L.x3 = v;
    else if (k == 1) L.xn = fp2_add(L.xn, v);
    else if (k == 2) L.yp = fp2_add(L.yp, v);
    else L.yd = fp2_add(fp2_add(L.yd, v), kara_post(m));
  });
  hash_wave(run, sh, 9, [](const HashLane& L, int r, Fp& a, Fp& b) {
    const int k = r / 3;
    kara_opnd(k == 0 ? KC.XN[3] : k == 1 ? KC.YN[3] : L.xd,
              k < 2 ? L.x3 : L.yd, r % 3, a, b);
  });
  hash_post(run, sh, 9, 3, [](HashLane& L, const Fp* m, int k) {
    const Fp2 v = kara_post(m + 3 * k);
    if (k == 0) L.xn = fp2_add(L.xn, v);
    else if (k == 1) L.yp = fp2_add(L.yp, v);
    else L.q.Z = v;
  });
  hash_wave(run, sh, 6, [](const HashLane& L, int r, Fp& a, Fp& b) {
    kara_opnd(r < 3 ? L.y : L.xn, r < 3 ? L.yp : L.yd, r % 3, a, b);
  });
  hash_post(run, sh, 6, 2, [](HashLane& L, const Fp* m, int k) {
    (k ? L.q.X : L.yn) = kara_post(m + 3 * k);
  });
  hash_wave(run, sh, 3, [](const HashLane& L, int r, Fp& a, Fp& b) {
    kara_opnd(L.yn, L.xd, r, a, b);
  });
  hash_post(run, sh, 3, 1,
            [](HashLane& L, const Fp* m, int) { L.q.Y = kara_post(m); });
}

// p <- a + b (g2_add), a and b negated where na, nb; p may be a or b.
template <class Run>
LH_NI void coop_g2_add(const Run& run, HashShared& sh, G2P& p, const G2P& a,
                       bool na, const G2P& b, bool nb) {
  coop_g2_adds(run, sh.M, sh.mid, 1,
               [&](int, const G2P*& x, bool& nx, const G2P*& y, bool& ny) {
                 x = &a;
                 nx = na;
                 y = &b;
                 ny = nb;
               },
               [&](int, int k, const Fp2& v) { g2_coord_ref(p, k) = v; });
}

// p <- psi(p) = (PSI_CX conj(X), PSI_CY conj(Y), conj(Z)).
template <class Run>
LH_NI void coop_g2_psi(const Run& run, HashShared& sh, G2P& p) {
  coop_wave(run, 6, [&](int i, Fp& x, Fp& y) {
    kara_opnd(i < 3 ? KC.PSI_CX : KC.PSI_CY, fp2_conj(i < 3 ? p.X : p.Y),
              i % 3, x, y);
  }, [&](int i, const Fp& r) { sh.M[i] = r; });
  run([&](int tid) {
    LH_ITEMS(k, tid, 3) {
      if (k < 2) (k ? p.Y : p.X) = kara_post(sh.M + 3 * k);
      else p.Z = fp2_conj(p.Z);
    }
  });
}

// acc <- [|x|] p, MSB first (p is not acc).
template <class Run>
LH_NI void coop_g2_mul_x_abs(const Run& run, HashShared& sh, G2P& acc,
                             const G2P& p) {
  run([&](int tid) {
    if (tid == 0) acc = g2_identity();
  });
#pragma unroll 1
  for (int b = (int)KC.x_bits - 1; b >= 0; --b) {
    coop_g2_add(run, sh, acc, acc, false, acc, false);
    if (exp_bit(KC.xabs, (uint32_t)b))
      coop_g2_add(run, sh, acc, acc, false, p, false);
  }
}

// Message ``msg`` (cell msg / 128, slot msg % 128) of the (64, m2) u plane:
// its affine point stored at column ``msg`` of the (128, m2/2) output.
template <class Run>
LH_FN void hash_g2_body(const Run& run, HashShared& sh, const int32_t* u,
                        int32_t* out, long long m2, long long msg) {
  const long long base = msg / LH_LANES * 2 * LH_LANES + msg % LH_LANES;
  run([&](int tid) {
    LH_ITEMS(q, tid, 2) sh.L[q].t = load_fp2(u, m2, base + q * LH_LANES, 0);
  });
  hash_map_group(run, sh);
  // p = q0 + q1, then ([x^2]p - [x]p - p) + psi([x]p - p) + psi^2([2]p)
  coop_g2_add(run, sh, sh.p, sh.L[0].q, false, sh.L[1].q, false);
  coop_g2_mul_x_abs(run, sh, sh.acc, sh.p);
  run([&](int tid) {
    if (tid == 0) sh.t1 = g2_neg(sh.acc);                 // [x]p, x < 0
  });
  coop_g2_mul_x_abs(run, sh, sh.acc, sh.t1);              // -[x^2]p
  coop_g2_add(run, sh, sh.acc, sh.acc, true, sh.t1, true);
  coop_g2_add(run, sh, sh.acc, sh.acc, false, sh.p, true);
  coop_g2_add(run, sh, sh.u, sh.t1, false, sh.p, true);
  coop_g2_psi(run, sh, sh.u);
  coop_g2_add(run, sh, sh.acc, sh.acc, false, sh.u, false);
  coop_g2_add(run, sh, sh.u, sh.p, false, sh.p, false);
  coop_g2_psi(run, sh, sh.u);
  coop_g2_psi(run, sh, sh.u);
  coop_g2_add(run, sh, sh.acc, sh.acc, false, sh.u, false);
  // affine: zi = 1/Z (fp2_inv), (X zi, Y zi)
  const G2P& p = sh.acc;
  coop_wave(run, 2, [&](int i, Fp& a, Fp& b) { a = b = i ? p.Z.c1 : p.Z.c0; },
            [&](int i, const Fp& r) { sh.M[i] = r; });
  run([&](int tid) {
    if (tid == 0) sh.ni = fp_inv(fp_add(sh.M[0], sh.M[1]));
  });
  coop_wave(run, 2, [&](int i, Fp& a, Fp& b) {
    a = i ? fp_neg(p.Z.c1) : p.Z.c0;
    b = sh.ni;
  }, [&](int i, const Fp& r) { (i ? sh.zi.c1 : sh.zi.c0) = r; });
  coop_wave(run, 6, [&](int i, Fp& a, Fp& b) {
    kara_opnd(i < 3 ? p.X : p.Y, sh.zi, i % 3, a, b);
  }, [&](int i, const Fp& r) { sh.M[i] = r; });
  run([&](int tid) {
    LH_ITEMS(k, tid, 2)
      store_fp2(out, m2 / 2, msg, 2 * k, kara_post(sh.M + 3 * k));
  });
}

// ---------------------------------------------------------------------------
// Sigma: a group per lane for the RLC ladder, a cluster per chunk for the
// butterfly
// ---------------------------------------------------------------------------
//
// The ladder (scalar_mul, LSB first): acc <- identity, base <- the lane's
// masked point; at each of the 64 bits acc + base and base + base run side
// by side as ONE pair of waves (coop_g2_adds, 36 products a wave), and acc
// takes the sum where the bit is set.  Both additions run at every bit, as
// the reference's do; only a lane with mask 0 and scalar 0 (the identity
// throughout) skips them.  The butterfly (w = 64 ... 1: lane j adds lane
// (j + w) mod 128 of the previous step, every lane keeping its own sum)
// runs as a second launch, a cluster of LH_SIGMA_CLUSTER blocks per
// 128-lane chunk: a block holds LH_SIGMA_FOLD_LANES lanes in its shared
// memory and reads the others from their blocks' (distributed shared
// memory); each step is one pair of waves over its lanes' additions, then
// the cluster's barrier.  One block per chunk would put the chunk's 7 x 128
// additions (32k products) on one SM's issue, about as long as a
// thread per lane takes.

struct SigmaLane {
  G2P acc, base;
  Fp M[36];          // the products of one wave of the two additions
  Fp2 mid[12];
};

// Lane ``lane`` of the (128, m) signature and (1, m) mask / lo / hi planes:
// c * sigma (the identity where the mask is 0) into column ``lane`` of the
// (192, m) output, projective.
template <class Run>
LH_FN void sigma_ladder_body(const Run& run, SigmaLane& sh, const int32_t* sig,
                             const int32_t* mask, const int32_t* lo,
                             const int32_t* hi, int32_t* out, long long m,
                             long long lane) {
  const uint32_t slo = (uint32_t)lo[lane], shi = (uint32_t)hi[lane];
  const bool pt = mask[lane] != 0;
  run([&](int tid) {
    LH_ITEMS(c, tid, 6) {   // acc = identity; base = (x, y, 1) or identity
      const int k = c % 3;
      const Fp2 id = k == 1 ? fp2_one() : fp2_zero();
      g2_coord_ref(c < 3 ? sh.acc : sh.base, k) =
          c < 3 || !pt ? id : k < 2 ? load_fp2(sig, m, lane, 2 * k) : fp2_one();
    }
  });
  if (pt || slo != 0 || shi != 0) {
#pragma unroll 1
    for (int i = 0; i < 64; ++i) {
      const bool bit = (((i < 32 ? slo : shi) >> (i & 31)) & 1u) != 0;
      coop_g2_adds(run, sh.M, sh.mid, 2,
                   [&](int q, const G2P*& a, bool& na, const G2P*& b, bool& nb) {
                     a = q ? &sh.base : &sh.acc;
                     b = &sh.base;
                     na = nb = false;
                   },
                   [&](int q, int k, const Fp2& v) {
                     if (q || bit) g2_coord_ref(q ? sh.base : sh.acc, k) = v;
                   });
    }
  }
  run([&](int tid) {
    LH_ITEMS(k, tid, 3) store_fp2(out, m, lane, 2 * k, g2_coord_ref(sh.acc, k));
  });
}

#define LH_SIGMA_STEPS 7   // log2(LH_LANES) butterfly steps

struct SigmaFoldShared {
  G2P P[2][LH_SIGMA_FOLD_LANES];   // step s reads P[s & 1], writes the other
  Fp M[18 * LH_SIGMA_FOLD_LANES];  // one wave of the block's additions
  Fp2 mid[6 * LH_SIGMA_FOLD_LANES];
};

// Block ``rank`` of a chunk's cluster holds lanes lane0 + l, l <
// LH_SIGMA_FOLD_LANES (lane0 = chunk * 128 + rank * LH_SIGMA_FOLD_LANES),
// of the (192, m) plane.
template <class Run>
LH_FN void sigma_fold_load(const Run& run, SigmaFoldShared& sh,
                           const int32_t* out, long long m, long long lane0) {
  run([&](int tid) {
    LH_ITEMS(i, tid, 3 * LH_SIGMA_FOLD_LANES)
      g2_coord_ref(sh.P[0][i / 3], i % 3) =
          load_fp2(out, m, lane0 + i / 3, 2 * (i % 3));
  });
}

// Butterfly step s (w = 64 >> s) of block ``rank``: its lane j adds lane
// (j + w) mod 128 of the previous step, which block peer(r) of the cluster
// holds (r = that lane / LH_SIGMA_FOLD_LANES).
template <class Run, class Peer>
LH_FN void sigma_fold_step(const Run& run, SigmaFoldShared& sh, Peer peer,
                           int rank, int s) {
  const int w = (LH_LANES / 2) >> s, cur = s & 1;
  coop_g2_adds(run, sh.M, sh.mid, LH_SIGMA_FOLD_LANES,
               [&](int l, const G2P*& a, bool& na, const G2P*& b, bool& nb) {
                 const int o = (rank * LH_SIGMA_FOLD_LANES + l + w) & (LH_LANES - 1);
                 a = &sh.P[cur][l];
                 b = &peer(o / LH_SIGMA_FOLD_LANES)->P[cur][o % LH_SIGMA_FOLD_LANES];
                 na = nb = false;
               },
               [&](int l, int k, const Fp2& v) {
                 g2_coord_ref(sh.P[cur ^ 1][l], k) = v;
               });
}

// The block's lanes after the last step, back into the (192, m) plane.
template <class Run>
LH_FN void sigma_fold_store(const Run& run, const SigmaFoldShared& sh,
                            int32_t* out, long long m, long long lane0) {
  run([&](int tid) {
    LH_ITEMS(i, tid, 3 * LH_SIGMA_FOLD_LANES) {
      const G2P& p = sh.P[LH_SIGMA_STEPS & 1][i / 3];
      store_fp2(out, m, lane0 + i / 3, 2 * (i % 3),
                i % 3 == 0 ? p.X : i % 3 == 1 ? p.Y : p.Z);
    }
  });
}

#if defined(__CUDACC__)
// The butterfly on the card: this block is block cluster.block_rank() of
// chunk blockIdx.x / LH_SIGMA_CLUSTER's cluster, its LH_SIGMA_FOLD_THREADS
// threads one group.  The cluster's barrier after each step also keeps
// every block's shared memory alive until the last step's reads are done.
LH_FN void sigma_fold_cluster(SigmaFoldShared& sh, int32_t* out, long long m) {
  cooperative_groups::cluster_group cluster = cooperative_groups::this_cluster();
  const int rank = (int)cluster.block_rank();
  const long long lane0 = (long long)(blockIdx.x / LH_SIGMA_CLUSTER) * LH_LANES +
                          rank * LH_SIGMA_FOLD_LANES;
  const GroupRun<LH_SIGMA_FOLD_THREADS> run{(int)threadIdx.x, 0};
  sigma_fold_load(run, sh, out, m, lane0);
  cluster.sync();
#pragma unroll 1
  for (int s = 0; s < LH_SIGMA_STEPS; ++s) {
    sigma_fold_step(run, sh, [&](int r) { return cluster.map_shared_rank(&sh, r); },
                    rank, s);
    cluster.sync();
  }
  sigma_fold_store(run, sh, out, m, lane0);
}
#endif

// ---------------------------------------------------------------------------
// Prepare: a sub-warp group per set
// ---------------------------------------------------------------------------
//
// Set s of chunk c reads key slot k at column (c*K + k)*128 + s of the (64,
// C*K*128) key plane: the K slots summed in k order from the identity (a
// masked slot adds the identity), each addition a pair of 6-product waves
// (coop_g1_adds) while the group fetches slot k + 1 into registers; the
// identity flag of the sum; the 64-bit RLC ladder (acc + base and base +
// base as one pair of 12-product waves a bit); the Fermat inversion of Z on
// one thread (inv(0) = 0); then X zi and Y zi as one wave.  A set with no
// live slot and scalar 0 is dead: flag 1 and (0, 0), as the plain version
// writes.  Several sets share a warp (G = 8 or 16), so the card's SMs each
// hold a few warps of sets.

#define LH_PREP_G_MAX 32
#define LH_PREP_FETCH 4    // words of a slot a thread fetches (26 over >= 8)

struct PrepShared {
  G1P acc, base;     // the ladder's acc; the key sum, then the ladder's base
  G1P key[2];        // slots k and k + 1
  Fp M[12], mid[12], zi;
  int any[LH_PREP_G_MAX];   // a live slot among each thread's slots
  int flag;
};

// A thread's words of one key slot (x then y, word indices tid + j*G < 26)
// and the slot's mask.
struct KeyFetch {
  uint32_t w[LH_PREP_FETCH];
  int live;
};

// Set ``set`` of the (64, m*K) key plane, (1, m*K) kmask and (1, m) lo / hi
// planes: its affine point into column ``set`` of the (64, m) output and
// its flag into ``flags``.
template <class Run>
LH_FN void prepare_body(const Run& run, PrepShared& sh, const int32_t* pk,
                        const int32_t* kmask, const int32_t* lo,
                        const int32_t* hi, int32_t* out, int32_t* flags,
                        long long m, int K, long long set) {
  constexpr int G = Run::G_;
  static_assert(G >= 26 / LH_PREP_FETCH && G <= LH_PREP_G_MAX, "prepare group");
  const long long mk = m * K, col0 = set / LH_LANES * K * LH_LANES + set % LH_LANES;
  const uint32_t slo = (uint32_t)lo[set], shi = (uint32_t)hi[set];
  auto col = [&](int k) { return col0 + (long long)k * LH_LANES; };
  auto fetch = [&](int tid, long long c) {
    KeyFetch f;
    f.live = kmask[c] != 0;
#pragma unroll
    for (int j = 0; j < LH_PREP_FETCH; ++j) {
      const int i = tid + j * G;
      f.w[j] = i < 26 ? load_word(pk, mk, c, i / 13, i % 13) : 0u;
    }
    return f;
  };
  // slot = (x, y, 1) where live, else the identity (0, 1, 0)
  auto keep = [&](int tid, const KeyFetch& f, G1P& key) {
    LH_ITEMS(i, tid, 39) {
      const int c = i / 13, w = i % 13;
      const uint32_t one = KC.ONE.w[w];
      g1_coord(key, c).w[w] = c == 2 ? (f.live ? one : 0u)
                            : f.live ? f.w[(i - tid) / G] : c == 1 ? one : 0u;
    }
  };
  run([&](int tid) {
    int any = 0;
    LH_ITEMS(k, tid, K) any |= kmask[col(k)] != 0;
    sh.any[tid] = any;
    keep(tid, fetch(tid, col(0)), sh.key[0]);
    const G1P id = g1_identity();
    LH_ITEMS(c, tid, 3) g1_coord(sh.acc, c) = g1_coord(sh.base, c) = g1_coord(id, c);
  });
  int live = slo != 0 || shi != 0;
  for (int t = 0; t < G; ++t) live |= sh.any[t];
  if (!live) {
    run([&](int tid) {
      LH_ITEMS(c, tid, 2) store_fp(out, m, set, c, fp_zero());
      if (tid == 0) flags[set] = 1;
    });
    return;
  }
#pragma unroll 1
  for (int k = 0; k < K; ++k) {   // base <- base + slot k; fetch slot k + 1
    const bool next = k + 1 < K;
    coop_g1_adds(run, sh.M, sh.mid, 1,
                 [&](int, const G1P*& a, const G1P*& b) {
                   a = &sh.base;
                   b = &sh.key[k & 1];
                 },
                 [&](int, int c, const Fp& v) { g1_coord(sh.base, c) = v; },
                 [&](int tid) { return fetch(tid, col(next ? k + 1 : k)); },
                 [&](int tid, const KeyFetch& f) {
                   if (next) keep(tid, f, sh.key[(k + 1) & 1]);
                 });
  }
  run([&](int tid) {
    if (tid == 0) sh.flag = fp_is_zero(sh.base.Z) ? 1 : 0;
  });
#pragma unroll 1
  for (int i = 0; i < 64; ++i) {  // acc + base and base + base, one pair of waves
    const bool bit = (((i < 32 ? slo : shi) >> (i & 31)) & 1u) != 0;
    coop_g1_adds(run, sh.M, sh.mid, 2,
                 [&](int q, const G1P*& a, const G1P*& b) {
                   a = q ? &sh.base : &sh.acc;
                   b = &sh.base;
                 },
                 [&](int q, int c, const Fp& v) {
                   if (q || bit) g1_coord(q ? sh.base : sh.acc, c) = v;
                 },
                 [](int) { return 0; }, [](int, int) {});
  }
  run([&](int tid) {
    if (tid == 0) sh.zi = fp_inv(sh.acc.Z);
  });
  coop_wave(run, 2, [&](int i, Fp& a, Fp& b) {
    a = i ? sh.acc.Y : sh.acc.X;
    b = sh.zi;
  }, [&](int i, const Fp& r) { store_fp(out, m, set, i, r); }, [&](int tid) {
    if (tid == 0) flags[set] = sh.flag;
  });
}
