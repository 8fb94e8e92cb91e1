"""Batched BLS12-381 pairing on the GPU: CUDA kernel wrappers and their
plain PyTorch versions.

Port of ``lighthouse_tpu/crypto/pairing_kernel.py``.  Its Pallas kernels
become CUDA kernels written for Hopper (``csrc/bls381.cu`` with the field
core in ``csrc/bls381_field.cuh``, built at first use by
:mod:`..ops.cuda_build`):

- :func:`prepare_kernel_call` — per set, the sum of its K affine G1 keys
  (masked slots add the identity), the identity flag, the 64-bit RLC
  ladder and the affine result (replaces ``_prepare_kernel``).  One
  sub-warp thread group per set shares each G1 addition's products;
- :func:`sigma_kernel_call` — masked G2 × 64-bit RLC ladder, then a
  128-lane roll-add butterfly (replaces ``_sigma_kernel``).  Two
  launches: one thread group per lane for the ladder, then a cluster of
  blocks per 128-lane chunk for the butterfly;
- :func:`miller_fold_kernel_call` — the 63-iteration Miller loop,
  conjugate, mask and the fold of lane j with lane j+128 (replaces
  ``_miller_fold_kernel``).  One thread group per lane pair shares each
  step's independent products; :func:`group_kernel_info` reports the
  group kernels' launch shapes;
- :func:`miller_kernel_call` — the Miller loop alone, every lane
  (replaces ``_miller_kernel``; the stage profile runs it).  One thread
  group per lane pair on Miller+fold's load phase and loop;
- :func:`product_chunks_kernel_call` — per 256-lane chunk, the masked
  product of lane j and lane j+128 (replaces ``_product_chunk_kernel``).
  One thread group per output lane runs the Fq12 product's 54 Montgomery
  products as one wave;
- :func:`product_kernel_call` — the masked roll butterfly down to the 128
  residue-class products (replaces ``_product_kernel``).  A block per
  residue class holds the class's lanes in shared memory; each level is
  one wave of its Fq12 products, a thread group per lane;
- :func:`finalize_kernel_call` — ``product_chunks`` down to 128 lanes,
  then the 128 → 1 Fq12 fold, the easy and hard parts of the cubed final
  exponentiation and ``== 1`` (replaces ``_finalize_easy_kernel`` +
  ``_finalize_hard_kernel``; the TPU split the two halves only to fit its
  scoped-VMEM budget).  One block shares each tower step: the independent
  Montgomery products of a step run on separate threads;
- :func:`sigma_combine` — the Σ over chunks of the sigma partials, the
  Fq2 inversion and the affine Miller-ready column, a thread per partial
  (replaces the reference's ``sigma_combine``, XLA glue with no
  ``pallas_call``; the H100 profile showed it as ~40k small launches).

Beside each wrapper sits its plain PyTorch version (``*_plain``).  A
wrapper runs the plain version only for a tensor on the CPU; for a CUDA
tensor it launches its kernel or raises.  :data:`LAUNCHES` counts kernel
launches.

Boundary layouts are the JAX package's: an Fq element is 26 16-bit
Montgomery limbs (R = 2^416, residues < 2N) in a 32-row block, lanes
across columns, held in int32 tensors; G1 affine is ``(64, M)``, G2
affine ``(128, M)``, G2 projective ``(192, M)``, Fq12 ``(384, M)``.

Inside the plain versions a tower element is an int64 tensor with the
limb axis first and its coefficient axes last: Fq ``(26, *S)``, Fq2
``(26, *S, 2)``, Fq6 ``(26, *S, 3, 2)``, Fq12 ``(26, *S, 2, 3, 2)``, a
projective G1 point ``(26, *S, 3)``, a projective G2 point
``(26, *S, 3, 2)``.  Every operation is the reference's, value for value
(the same Karatsuba tower, RCB complete addition, Miller steps, butterfly
orders and lazy reduction below 2N), so the plain versions agree with the
JAX package limb for limb; they batch independent products into one wide
Montgomery multiply as the reference does, and stack independent
additions too.  They run under ``torch.inference_mode`` (tens of
thousands of small ops; it trims the dispatch cost of each).
"""

from __future__ import annotations

import ctypes
from functools import lru_cache

import numpy as np
import torch

from . import fields as F
from . import hash_to_curve as H2C
from . import limb_field as LF
from . import limb_pairing as XP

LIMBS = 26
BLOCK_ROWS = 32
LANE_BLOCK = 128
PREP_S = 128                      # sets per sigma chunk
FQ12_ROWS = 12 * BLOCK_ROWS

X_BITS_MILLER = XP.X_BITS_MILLER     # 63 bits, MSB-first (implicit top 1)
X_BITS_FULL = XP.X_BITS_FULL         # 64 bits
P_MINUS_2_BITS = XP.P_MINUS_2_BITS   # 381 bits

_M16 = 0xFFFF

LAUNCHES = {"prepare": 0, "sigma": 0, "sigma_combine": 0, "miller_fold": 0,
            "miller": 0, "product_chunks": 0, "product": 0, "finalize": 0}

# Lane-products through mont_mul since the last reset: the operation
# count chip_smoke.py turns into a bound (products × instructions per
# product from SASS).
MONT_PRODUCTS = [0]


# ---------------------------------------------------------------------------
# Constants, per device
# ---------------------------------------------------------------------------

def _ints_limbs(values) -> np.ndarray:
    return np.stack([LF.int_to_limbs(v) for v in values], axis=-1)


def _limbs_plus_one(limbs) -> np.ndarray:
    out = np.asarray(limbs, np.int64).copy()
    out[0] += 1
    return out


def _fq2_mont(v) -> np.ndarray:
    """Host Fq2 → (26, 2) Montgomery limbs."""
    return np.stack([LF.to_mont(v[0] % F.P), LF.to_mont(v[1] % F.P)], -1)


def _h2c_values() -> dict:
    """The hash-to-curve constants (canonical Fq2 values), keyed as the
    JAX package's constant planes name them."""
    neg_b_over_a = F.fq2_mul(F.fq2_neg(H2C.B_TWIST), F.fq2_inv(H2C.A_TWIST))
    x1_exc = F.fq2_mul(H2C.B_TWIST,
                       F.fq2_inv(F.fq2_mul(H2C.Z_SSWU, H2C.A_TWIST)))
    out = {"A": H2C.A_TWIST, "B": H2C.B_TWIST, "Z": H2C.Z_SSWU,
           "NEGBA": neg_b_over_a, "X1EXC": x1_exc,
           "PSI_CX": H2C._PSI_CX, "PSI_CY": H2C._PSI_CY}
    for k in range(4):
        out[f"E8I{k}"] = H2C.E8_INV_POWS[k]
        out[f"T{k}"] = H2C.T_KS[k]
    for tag, coeffs in (("XN", H2C._ISO3_X_NUM), ("XD", H2C._ISO3_X_DEN),
                        ("YN", H2C._ISO3_Y_NUM), ("YD", H2C._ISO3_Y_DEN)):
        for i, cf in enumerate(coeffs):
            out[f"{tag}{i}"] = cf
    return out


H2C_VALUES = _h2c_values()


class _Consts:
    """Plane constants as int64 tensors on one device."""

    def __init__(self, dev: torch.device):
        def t(a):
            return torch.as_tensor(np.asarray(a, np.int64), device=dev)

        P = F.P
        self.dev = dev
        self.N = t(LF.N_LIMBS)
        self.NPRIME = t(LF._NPRIME_LIMBS)
        self.ONE = t(LF.ONE_MONT)
        self.RAW_ONE = t(LF.int_to_limbs(1))
        self.N2 = t(LF.N2_LIMBS)
        # R − k·N as limbs of R − 1 − k·N with the +1 in limb 0 (limb 0
        # may read 0x10000): adding it to a normalized x keeps every limb
        # below 2^17 and carries out of the top exactly when x ≥ k·N.
        self.NEG = {k: t(_limbs_plus_one(0xFFFF - LF.int_to_limbs(k * P)))
                    for k in (1, 2, 4, 8, 16)}
        # 2N + (R − 1) + 1 limb by limb: a + SUB_BIAS − b ≡ a + 2N − b
        # (mod R) with every limb nonnegative.
        self.SUB_BIAS = t(_limbs_plus_one(LF.N2_LIMBS.astype(np.int64)
                                          + 0xFFFF))
        self.ZP = t(_ints_limbs([k * P for k in range(8)]).T)  # (8, 26)
        self.GAMMA = {n: t(np.moveaxis(XP._GAMMA[n], -1, 0))   # (26,2,3,2)
                      for n in (1, 2, 3)}
        self.H2C = {k: t(_fq2_mont(v)) for k, v in H2C_VALUES.items()}
        # band index maps: column of each (i, j) limb product
        ii, jj = np.meshgrid(np.arange(LIMBS), np.arange(LIMBS), indexing="ij")
        self.BAND = t((ii + jj).reshape(-1))
        low = (ii + jj).reshape(-1) < LIMBS
        self.LOW_I = t(ii.reshape(-1)[low])
        self.LOW_J = t(jj.reshape(-1)[low])
        self.LOW_COL = t((ii + jj).reshape(-1)[low])


@lru_cache(maxsize=None)
def _consts_for(dev_str: str) -> _Consts:
    return _Consts(torch.device(dev_str))


def _K(x: torch.Tensor) -> _Consts:
    return _consts_for(str(x.device))


def _bc(c: torch.Tensor, like: torch.Tensor, tail: int) -> torch.Tensor:
    """View constant ``c`` of shape (26, *tail dims) for broadcasting
    against ``like`` of shape (26, *S, *tail dims)."""
    lead = like.ndim - 1 - tail
    return c.reshape(c.shape[0], *([1] * lead), *c.shape[1:])


# ---------------------------------------------------------------------------
# Base field on int64 limb tensors (limb axis 0)
# ---------------------------------------------------------------------------

def _carry(t: torch.Tensor, wrap: bool, lookahead=None) -> torch.Tensor:
    """Exact carry normalization of nonnegative limb columns (each below
    2^38) along axis 0, as a new tensor.  The top limb keeps the
    overflow, or is reduced mod 2^16 (``wrap``: the value mod
    2^(16·rows)).

    Two exact schemes.  On the CPU: carry passes until none is left (most
    inputs settle in one to three; a run of 0xFFFF limbs passes a carry
    on one limb per pass — the low half of T + m·N is such a run, all of
    it — so after three passes the lookahead below takes over).  On the
    GPU (or with ``lookahead=True``): three passes bring every carry to 0
    or 1, then one carry-lookahead step settles the chains — no
    data-dependent loop, so no device-to-host sync."""
    if lookahead is None:
        lookahead = t.device.type != "cpu"
    t = t.clone()
    for _ in range(3):
        c = t[:-1] >> 16
        if not lookahead and not bool(c.any()):
            break
        t[:-1] &= _M16
        t[1:] += c
    else:
        h = t[:-1] >> 16                                 # 0 or 1
        t[:-1] &= _M16
        t[1:] += h                                       # limbs ≤ 0x10000
        g = t[:-1] >> 16                                 # generates
        pos = torch.arange(g.shape[0], device=t.device).reshape(
            -1, *([1] * (t.ndim - 1)))
        last = torch.where(t[:-1] == _M16, -1, pos).cummax(0).values
        t[1:] += torch.where(last >= 0, g.gather(0, last.clamp(min=0)), 0)
        t[:-1] &= _M16
    if wrap:
        t[-1] &= _M16
    return t


def _cond_sub_raw(x: torch.Tensor, k: int) -> torch.Tensor:
    """x − k·N if x ≥ k·N else x (``_cond_sub_raw``): x + (R − k·N)
    carries out of the top limb exactly when x ≥ k·N."""
    d = _carry(x + _bc(_K(x).NEG[k], x, 0), wrap=False)
    take = (d[-1] >> 16) != 0
    d[-1] &= _M16
    return torch.where(take.unsqueeze(0), d, x)


def _reduce_2n(d: torch.Tensor, wraps: int) -> torch.Tensor:
    """Normalize the limbs ``d`` (value v + wraps·R, v < 4N) and reduce v
    below 2N: v and v + (R − 2N) normalize together, and the second
    carries out of the top limb once more than the first exactly when
    v ≥ 2N (``_cond_sub_raw(·, N2)`` after the carry)."""
    t = _carry(torch.stack([d, d + _bc(_K(d).NEG[2], d, 0)], 1), wrap=False)
    take = (t[-1, 1] >> 16) > wraps
    out = torch.where(take.unsqueeze(0), t[:, 1], t[:, 0])
    out[-1] &= _M16
    return out


def k_add(a, b):
    """a + b reduced below 2N."""
    return _reduce_2n(a + b, 0)


def k_sub(a, b):
    """a + 2N − b reduced below 2N (computed as a + 2N + (R − 1 − b) + 1,
    the R wrapped away)."""
    return _reduce_2n(a + _bc(_K(a).SUB_BIAS, a, 0) - b, 1)


def k_neg(a):
    """2N − a (no reduction: ``k_neg(0)`` is 2N, a lazy zero)."""
    return _carry(_bc(_K(a).SUB_BIAS, a, 0) - a, wrap=True)


def k_muls(a, s: int):
    """a · s for small 0 ≤ s ≤ 16, reduced below 2N."""
    if not 0 <= s <= 16:
        raise ValueError("small-scalar multiply supports 0..16")
    x = _carry(a * s, wrap=True)
    for k in (16, 8, 4, 2):
        x = _cond_sub_raw(x, k)
    return x


def _band(a: torch.Tensor, b: torch.Tensor, K: _Consts) -> torch.Tensor:
    """Column sums of the schoolbook product: (26, n) × (26, n) or a
    (26,) constant → (52, n), each column < 26·2^32."""
    if b.ndim == 1:
        prod = a.unsqueeze(1) * b.reshape(1, LIMBS, 1)
    else:
        prod = a.unsqueeze(1) * b.unsqueeze(0)
    out = torch.zeros((2 * LIMBS, a.shape[1]), dtype=torch.int64,
                      device=a.device)
    return out.index_add_(0, K.BAND, prod.reshape(LIMBS * LIMBS, -1))


def mont_mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Montgomery product a·b·R⁻¹ (``k_mont_mul``): T = a·b, m = T·N' mod
    R, (T + m·N)/R — the same value as the reference's full-width
    reduction, < 2N for inputs ≤ 2N.  Broadcasts; one call for any
    number of lanes."""
    a, b = torch.broadcast_tensors(a, b)
    shape = a.shape
    A = a.reshape(LIMBS, -1)
    B = b.reshape(LIMBS, -1)
    K = _K(A)
    MONT_PRODUCTS[0] += A.shape[1]
    T = _band(A, B, K)
    t_low = _carry(T[:LIMBS], wrap=True)
    low = t_low[K.LOW_I] * K.NPRIME[K.LOW_J].unsqueeze(1)
    m = torch.zeros((LIMBS, A.shape[1]), dtype=torch.int64, device=A.device)
    m = _carry(m.index_add_(0, K.LOW_COL, low), wrap=True)
    s = _carry(T + _band(m, K.N, K), wrap=False)
    return s[LIMBS:].reshape(shape)


def k_is_zero(a):
    """(*S) bool: a ≡ 0 mod N for lazy values < 8N (compares with k·N)."""
    zp = _K(a).ZP.reshape(8, LIMBS, *([1] * (a.ndim - 1)))
    return (a.unsqueeze(0) == zp).all(1).any(0)


def k_canonical(a):
    """Montgomery-domain lazy limbs → canonical (< N) value limbs."""
    one = _bc(_K(a).RAW_ONE, a, 0)
    return _cond_sub_raw(mont_mul(a, one), 1)


def fq_inv(a):
    """Fermat ladder a^(p−2) (``k_fq_inv``); inv(0) = 0."""
    acc = _bc(_K(a).ONE, a, 0).expand_as(a)
    for bit in P_MINUS_2_BITS:
        acc = mont_mul(acc, acc)
        if bit:
            acc = mont_mul(acc, a)
    return acc


def _sel(take: torch.Tensor, a, b):
    """``take ? a : b`` per lane; ``take`` has the lane shape *S."""
    t = take.reshape(1, *take.shape, *([1] * (a.ndim - 1 - take.ndim)))
    return torch.where(t, a, b)


# ---------------------------------------------------------------------------
# Tower: Fq2 (26, *S, 2), Fq6 (26, *S, 3, 2), Fq12 (26, *S, 2, 3, 2)
# ---------------------------------------------------------------------------

def _st(xs, dim=-1):
    return torch.stack(xs, dim)


def fq2_mul(a, b):
    """Karatsuba (``fq2_mul``): m0 = a0b0, m1 = a1b1, m2 = (a0+a1)(b0+b1);
    (m0 − m1, m2 − (m0 + m1))."""
    a, b = torch.broadcast_tensors(a, b)
    s = k_add(_st([a[..., 0], b[..., 0]]), _st([a[..., 1], b[..., 1]]))
    m = mont_mul(_st([a[..., 0], a[..., 1], s[..., 0]]),
                 _st([b[..., 0], b[..., 1], s[..., 1]]))
    m01 = k_add(m[..., 0], m[..., 1])
    return k_sub(_st([m[..., 0], m[..., 2]]), _st([m[..., 1], m01]))


def fq2_mul_schoolbook(a, b):
    """Schoolbook Fq2 product (the XLA tower's ``limb_tower.fq2_mul``,
    used by ``sigma_combine``): (a0b0 − a1b1, a0b1 + a1b0)."""
    a, b = torch.broadcast_tensors(a, b)
    p = mont_mul(_st([a[..., 0], a[..., 1], a[..., 0], a[..., 1]]),
                 _st([b[..., 0], b[..., 1], b[..., 1], b[..., 0]]))
    return _st([k_sub(p[..., 0], p[..., 1]), k_add(p[..., 2], p[..., 3])])


def fq2_conj(a):
    return _st([a[..., 0], k_neg(a[..., 1])])


def fq2_mul_by_xi(a):
    """ξ = 1 + u:  (a0 − a1) + (a0 + a1)u."""
    return _st([k_sub(a[..., 0], a[..., 1]), k_add(a[..., 0], a[..., 1])])


def fq2_mul_fq(a, s):
    """Fq2 × Fq: (a0·s, a1·s)."""
    return mont_mul(a, s.unsqueeze(-1))


def fq2_is_zero(a):
    return k_is_zero(a[..., 0]) & k_is_zero(a[..., 1])


def fq2_eq(a, b):
    """Equality mod N for lazy (< 2N) inputs."""
    return fq2_is_zero(k_sub(a, b))


def fq2_inv(a):
    """conj(a) / (a0² + a1²); inv(0) = 0."""
    sq = mont_mul(a, a)
    ni = fq_inv(k_add(sq[..., 0], sq[..., 1]))
    return mont_mul(_st([a[..., 0], k_neg(a[..., 1])]), ni.unsqueeze(-1))


def fq6_mul(a, b):
    """Karatsuba over Fq2 (``_fq6_mul_pairs`` + ``_fq6_from_parts``)."""
    a, b = torch.broadcast_tensors(a, b)
    a0, a1, a2 = a.unbind(-2)
    b0, b1, b2 = b.unbind(-2)
    s = k_add(_st([a0, a1, a0, b0, b1, b0], -2),
              _st([a1, a2, a2, b1, b2, b2], -2))
    v = fq2_mul(torch.cat([a, s[..., 0:3, :]], -2),
                torch.cat([b, s[..., 3:6, :]], -2))
    v0, v1, v2, v01, v12, v02 = v.unbind(-2)
    t = k_add(_st([v1, v0, v0], -2), _st([v2, v1, v2], -2))
    d = k_sub(_st([v12, v01, v02], -2), t)
    x = fq2_mul_by_xi(_st([d[..., 0, :], v2], -2))
    return k_add(_st([v0, d[..., 1, :], d[..., 2, :]], -2),
                 _st([x[..., 0, :], x[..., 1, :], v1], -2))


def fq6_mul_by_v(a):
    return _st([fq2_mul_by_xi(a[..., 2, :]), a[..., 0, :], a[..., 1, :]], -2)


def fq6_inv(a):
    a0, a1, a2 = a.unbind(-2)
    p = fq2_mul(_st([a0, a1, a2, a1, a0, a0], -2),
                _st([a0, a2, a2, a1, a1, a2], -2))
    a00, a12, a22, a11, a01, a02 = p.unbind(-2)
    x = fq2_mul_by_xi(_st([a12, a22], -2))
    c = k_sub(_st([a00, x[..., 1, :], a11], -2),
              _st([x[..., 0, :], a01, a02], -2))
    q = fq2_mul(_st([a0, a2, a1], -2), c)
    nrm = k_add(q[..., 0, :], fq2_mul_by_xi(k_add(q[..., 1, :], q[..., 2, :])))
    ni = fq2_inv(nrm)
    return fq2_mul(c, ni.unsqueeze(-2))


def fq12_mul(a, b):
    """Karatsuba-2 over Fq6: three Fq6 products in one wide multiply."""
    a, b = torch.broadcast_tensors(a, b)
    a0, a1 = a.unbind(-3)
    b0, b1 = b.unbind(-3)
    s = k_add(_st([a0, b0], -3), _st([a1, b1], -3))
    v = fq6_mul(_st([a0, a1, s[..., 0, :, :]], -3),
                _st([b0, b1, s[..., 1, :, :]], -3))
    v00, v11, vxx = v.unbind(-3)
    c = k_add(_st([v00, v00], -3), _st([fq6_mul_by_v(v11), v11], -3))
    return _st([c[..., 0, :, :], k_sub(vxx, c[..., 1, :, :])], -3)


def fq12_sqr(a):
    return fq12_mul(a, a)


def fq12_conj(a):
    return _st([a[..., 0, :, :], k_neg(a[..., 1, :, :])], -3)


def fq12_one_like(lanes_shape, dev) -> torch.Tensor:
    out = torch.zeros((LIMBS, *lanes_shape, 2, 3, 2), dtype=torch.int64,
                      device=dev)
    out[..., 0, 0, 0] = _consts_for(str(dev)).ONE.reshape(
        LIMBS, *([1] * len(lanes_shape)))
    return out


def fq12_frobenius(a, n: int):
    c = fq2_conj(a) if n % 2 else a
    return fq2_mul(c, _bc(_K(a).GAMMA[n], a, 3))


def fq12_inv(a):
    a0, a1 = a.unbind(-3)
    s = fq6_mul(_st([a0, a1], -3), _st([a0, a1], -3))
    nrm = k_sub(s[..., 0, :, :], fq6_mul_by_v(s[..., 1, :, :]))
    ni = fq6_inv(nrm)
    return fq6_mul(_st([a0, k_neg(a1)], -3), ni.unsqueeze(-3))


def fq12_is_one(a):
    one = fq12_one_like(a.shape[1:-3], a.device)
    return k_is_zero(k_sub(a, one)).flatten(-3).all(-1)


# ---------------------------------------------------------------------------
# Projective points, RCB complete addition (a = 0), G1 and G2
# ---------------------------------------------------------------------------

class _G1ops:
    edim = 0                       # element axes after the lanes
    mul = staticmethod(mont_mul)

    @staticmethod
    def b3(t):
        return k_muls(t, 12)


class _G2ops:
    edim = 1
    mul = staticmethod(fq2_mul)

    @staticmethod
    def b3(t):
        return k_muls(fq2_mul_by_xi(t), 12)


class _G2ops_xla(_G2ops):
    """The XLA twin's G2 law (schoolbook Fq2), for ``sigma_combine``."""
    mul = staticmethod(fq2_mul_schoolbook)


def point_add(ops, p, q):
    """Complete addition, the reference's formulas and products."""
    d = -1 - ops.edim
    p, q = torch.broadcast_tensors(p, q)
    X1, Y1, Z1 = p.unbind(d)
    X2, Y2, Z2 = q.unbind(d)
    s = k_add(_st([X1, Y1, X1, X2, Y2, X2], d),
              _st([Y1, Z1, Z1, Y2, Z2, Z2], d)).unbind(d)
    r1 = ops.mul(_st([X1, Y1, Z1, s[0], s[1], s[2]], d),
                 _st([X2, Y2, Z2, s[3], s[4], s[5]], d))
    t0, t1, t2, pxy, pyz, pxz = r1.unbind(d)
    s3, s4, s5 = k_sub(_st([pxy, pyz, pxz], d),
                       k_add(_st([t0, t1, t0], d),
                             _st([t1, t2, t2], d))).unbind(d)
    b3t2 = ops.b3(t2)
    um = k_sub(t1, b3t2)
    up = k_add(t1, b3t2)
    r2 = ops.mul(_st([s3, s4, up, t0, s4, t0], d),
                 _st([um, s5, um, s5, up, s3], d))
    a_s3um, a_s4s5, a_upum, a_t0s5, a_s4up, a_t0s3 = r2.unbind(d)
    b3s = ops.b3(_st([a_s4s5, a_t0s5], d)).unbind(d)
    m3 = k_muls(_st([b3s[1], a_t0s3], d), 3)
    X3 = k_sub(a_s3um, b3s[0])
    Y3, Z3 = k_add(_st([a_upum, a_s4up], d), m3).unbind(d)
    return _st([X3, Y3, Z3], d)


def point_identity(ops, lanes_shape, dev):
    """Projective (0 : 1 : 0)."""
    shape = (LIMBS, *lanes_shape, 3) + ((2,) if ops.edim else ())
    out = torch.zeros(shape, dtype=torch.int64, device=dev)
    one = _consts_for(str(dev)).ONE.reshape(LIMBS, *([1] * len(lanes_shape)))
    if ops.edim:
        out[..., 1, 0] = one
    else:
        out[..., 1] = one
    return out


def scalar_mul(ops, p, lo, hi, nbits: int = 64):
    """Per-lane LSB-first double-and-add; lo/hi are the scalar's u32 words
    (int64 tensors of the lane shape).  The add and the doubling of one
    step run as one batched point addition."""
    acc = point_identity(ops, p.shape[1:-1 - ops.edim], p.device)
    base = p
    for i in range(nbits):
        word = lo if i < 32 else hi
        bit = ((word >> (i % 32)) & 1) == 1
        both = point_add(ops, torch.stack([acc, base], 1),
                         torch.stack([base, base], 1))
        acc = _sel(bit, both[:, 0], acc)
        base = both[:, 1]
    return acc


# ---------------------------------------------------------------------------
# Plane packing: (32·k, M) int32 blocks ↔ (26, M, k) int64
# ---------------------------------------------------------------------------

def planes_in(x: torch.Tensor, k: int) -> torch.Tensor:
    """(32·k, M) block layout → (26, M, k) int64 limbs."""
    m = x.shape[1]
    return (x.reshape(k, BLOCK_ROWS, m)[:, :LIMBS].permute(1, 2, 0)
            .to(torch.int64))


def planes_out(t: torch.Tensor) -> torch.Tensor:
    """(26, M, k) limbs → (32·k, M) int32 blocks (pad rows zero)."""
    m, k = t.shape[1], t.shape[2]
    out = torch.zeros((k, BLOCK_ROWS, m), dtype=torch.int32, device=t.device)
    out[:, :LIMBS] = t.permute(2, 0, 1).to(torch.int32)
    return out.reshape(k * BLOCK_ROWS, m)


def _fq2_one(lanes_shape, dev):
    out = torch.zeros((LIMBS, *lanes_shape, 2), dtype=torch.int64, device=dev)
    out[..., 0] = _consts_for(str(dev)).ONE.reshape(
        LIMBS, *([1] * len(lanes_shape)))
    return out


# ---------------------------------------------------------------------------
# Prepare: per-set G1 key sum + RLC ladder + affine
# ---------------------------------------------------------------------------

def _u32(x: torch.Tensor) -> torch.Tensor:
    """int32 bit patterns → int64 u32 values."""
    return x.to(torch.int64) & 0xFFFFFFFF


@torch.inference_mode()
def prepare_plain(pk_planes, kmask, lo, hi, K: int):
    """Plain PyTorch version of :func:`prepare_kernel_call`.  Only the
    sets with a live key slot or a nonzero scalar run; every other lane
    is a dead set, whose sum stays the exact identity (0 : 1 : 0), so the
    kernel writes flag 1 and (0, 0) there, as this does."""
    m = lo.shape[1]
    dev = pk_planes.device
    xy = planes_in(pk_planes, 2).reshape(LIMBS, m // PREP_S, K, PREP_S, 2)
    xy = xy.permute(0, 2, 1, 3, 4).reshape(LIMBS, K, m, 2)   # set-major
    live = (kmask[0] != 0).reshape(m // PREP_S, K, PREP_S)
    live = live.permute(1, 0, 2).reshape(K, m)
    lo, hi = _u32(lo[0]), _u32(hi[0])
    active = torch.nonzero(live.any(0) | (lo != 0) | (hi != 0)).flatten()
    out = torch.zeros((2 * BLOCK_ROWS, m), dtype=torch.int32, device=dev)
    flags = torch.ones((1, m), dtype=torch.int32, device=dev)
    n = active.numel()
    if n:
        ident = point_identity(_G1ops, (n,), dev)
        one = _consts_for(str(dev)).ONE.reshape(LIMBS, 1, 1).expand(
            LIMBS, n, 1)
        acc = ident
        for k in range(K):
            pt = torch.cat([xy[:, k, active], one], -1)
            acc = point_add(_G1ops, acc, _sel(live[k, active], pt, ident))
        flags[0, active] = k_is_zero(acc[..., 2]).to(torch.int32)
        scaled = scalar_mul(_G1ops, acc, lo[active], hi[active])
        zi = fq_inv(scaled[..., 2])
        out[:, active] = planes_out(mont_mul(scaled[..., :2],
                                             zi.unsqueeze(-1)))
    return out, flags


def prepare_kernel_call(pk_planes, kmask, lo, hi, K: int):
    """pk (64, C·K·128) affine G1 key blocks (chunk c's key k of set s at
    column c·K·128 + k·128 + s), kmask (1, C·K·128), lo/hi (1, C·128)
    int32 (u32 RLC scalar words) → (g1_aff (64, C·128), flags (1, C·128)
    int32): lane s of chunk c holds the affine c_s·Σ_k pk, and flag 1
    where that key sum is the identity."""
    S = PREP_S
    _check_planes(pk_planes, 2 * BLOCK_ROWS, "pk", K * S)
    mk = pk_planes.shape[1]
    m = mk // K
    _check_planes(kmask, 1, "kmask")
    if kmask.shape[1] != mk or kmask.device != pk_planes.device:
        raise ValueError(f"kmask must be (1, {mk}) on {pk_planes.device}")
    for name, v in (("lo", lo), ("hi", hi)):
        _check_planes(v, 1, name)
        if v.shape[1] != m or v.device != pk_planes.device:
            raise ValueError(f"{name} must be (1, {m}) on {pk_planes.device}")
    if pk_planes.device.type == "cpu":
        return prepare_plain(pk_planes, kmask, lo, hi, K)
    _require_cuda(pk_planes)
    dev = pk_planes.device
    out = torch.empty((2 * BLOCK_ROWS, m), dtype=torch.int32, device=dev)
    flags = torch.empty((1, m), dtype=torch.int32, device=dev)
    lib = kernel_library()
    _check_rc(lib.lh_prepare(_ptr(pk_planes), _ptr(kmask), _ptr(lo), _ptr(hi),
                             out.data_ptr(), flags.data_ptr(), m, K,
                             _stream(pk_planes)), "prepare")
    LAUNCHES["prepare"] += 1
    return out, flags


# ---------------------------------------------------------------------------
# Sigma: masked G2 RLC ladder + 128-lane butterfly
# ---------------------------------------------------------------------------

@torch.inference_mode()
def sigma_plain(sig_cols, mask, lo, hi):
    """Plain PyTorch version of :func:`sigma_kernel_call`."""
    m = sig_cols.shape[1]
    xy = planes_in(sig_cols, 4).reshape(LIMBS, m, 2, 2)
    pt = torch.cat([xy, _fq2_one((m,), xy.device).unsqueeze(-2)], -2)
    ident = point_identity(_G2ops, (m,), xy.device)
    pt = _sel(mask[0] != 0, pt, ident)
    # A lane whose point is the identity and whose scalar is 0 keeps the
    # identity (0 : 1 : 0) through the ladder: only the others run it.
    lo, hi = _u32(lo[0]), _u32(hi[0])
    active = torch.nonzero((mask[0] != 0) | (lo != 0) | (hi != 0)).flatten()
    scaled = ident.clone()
    if active.numel():
        scaled[:, active] = scalar_mul(_G2ops, pt[:, active], lo[active],
                                       hi[active])
    scaled = scaled.reshape(LIMBS, m // PREP_S, PREP_S, 3, 2)
    w = PREP_S // 2
    while w >= 1:   # lane j adds lane (j + w) mod 128
        scaled = point_add(_G2ops, scaled, torch.roll(scaled, -w, dims=2))
        w //= 2
    return planes_out(scaled.reshape(LIMBS, m, 6))


def _check_planes(x, rows: int, name: str, lanes_mult: int = 1):
    if not isinstance(x, torch.Tensor) or x.dtype != torch.int32:
        raise TypeError(f"{name} must be an int32 tensor")
    if x.ndim != 2 or x.shape[0] != rows or x.shape[1] % lanes_mult:
        raise ValueError(f"{name} must be ({rows}, k·{lanes_mult}), got "
                         f"{tuple(x.shape)}")


def sigma_kernel_call(sig_cols, mask, lo, hi):
    """sig (128, C·128) affine G2 signature columns, mask/lo/hi (1, C·128)
    int32 → (192, C·128) projective per-chunk Σ c_s·σ_s (every lane of a
    chunk's block holds that chunk's full sum).  One call is two kernel
    launches (the ladder, then the butterfly in place on the output) and
    counts once in :data:`LAUNCHES`."""
    _check_planes(sig_cols, 4 * BLOCK_ROWS, "sig_cols", PREP_S)
    m = sig_cols.shape[1]
    for name, v in (("mask", mask), ("lo", lo), ("hi", hi)):
        _check_planes(v, 1, name)
        if v.shape[1] != m or v.device != sig_cols.device:
            raise ValueError(f"{name} must be (1, {m}) on {sig_cols.device}")
    if sig_cols.device.type == "cpu":
        return sigma_plain(sig_cols, mask, lo, hi)
    _require_cuda(sig_cols)
    out = torch.empty((6 * BLOCK_ROWS, m), dtype=torch.int32,
                      device=sig_cols.device)
    lib = kernel_library()
    _check_rc(lib.lh_sigma(_ptr(sig_cols), _ptr(mask), _ptr(lo), _ptr(hi),
                           out.data_ptr(), m, _stream(sig_cols)), "sigma")
    LAUNCHES["sigma"] += 1
    return out


@torch.inference_mode()
def sigma_combine_plain(*partials):
    """Plain PyTorch version of :func:`sigma_combine`.  The JAX package
    runs this as XLA glue with the XLA twin's G2 law
    (``limb_curve.point_add``, schoolbook Fq2) and affine conversion
    (``limb_pairing.g2_proj_to_affine``), which this mirrors.  Several
    partials fold side by side and share one Fermat inversion ladder."""
    m = partials[0].shape[1]
    pts = torch.stack([planes_in(p, 6)[:, ::PREP_S] for p in partials], 1)
    pts = pts.reshape(LIMBS, len(partials), m // PREP_S, 3, 2)
    acc = pts[:, :, 0]
    for c in range(1, pts.shape[2]):
        acc = point_add(_G2ops_xla, acc, pts[:, :, c])
    is_ident = fq2_is_zero(acc[..., 2, :])
    zi = fq2_inv(acc[..., 2, :])
    aff = fq2_mul_schoolbook(acc[..., :2, :], zi.unsqueeze(-2))  # (26,n,2,2)
    cols = torch.zeros((len(partials), 4, BLOCK_ROWS), dtype=torch.int32,
                       device=partials[0].device)
    cols[:, :, :LIMBS] = aff.reshape(LIMBS, -1, 4).permute(1, 2, 0).to(
        torch.int32)
    out = [(cols[i].reshape(-1), is_ident[i]) for i in range(len(partials))]
    return out[0] if len(partials) == 1 else out


def sigma_combine(*partials):
    """One or two (192, C·128) per-chunk projective partials (one per
    side of the batch equation) → for each, the affine Σ over its chunks
    as ONE Miller-ready (128,) int32 G2 column and its identity flag as a
    0-dim bool tensor on the partials' device (no host sync); one
    (col, flag) pair each, or the pair alone for one argument."""
    if len(partials) not in (1, 2):
        raise ValueError(f"sigma_combine takes 1 or 2 partials, got "
                         f"{len(partials)}")
    first = partials[0]
    for p in partials:
        _check_planes(p, 6 * BLOCK_ROWS, "partial", PREP_S)
        if p.shape != first.shape or p.device != first.device:
            raise ValueError("partials must share their shape and device")
    if first.device.type == "cpu":
        return sigma_combine_plain(*partials)
    _require_cuda(first)
    n, m = len(partials), first.shape[1]
    cols = torch.empty((n, 4 * BLOCK_ROWS), dtype=torch.int32,
                       device=first.device)
    flags = torch.empty((n,), dtype=torch.bool, device=first.device)
    _check_rc(kernel_library().lh_sigma_combine(
        _ptr(first), _ptr(partials[-1]), cols.data_ptr(), flags.data_ptr(),
        m, n, _stream(first)), "sigma_combine")
    LAUNCHES["sigma_combine"] += 1
    out = [(cols[i], flags[i]) for i in range(n)]
    return out[0] if n == 1 else out


# ---------------------------------------------------------------------------
# Miller loop + masked 256 → 128 fold
# ---------------------------------------------------------------------------

def _line_fq12(A, B, Cc):
    """((A, B, 0), (0, C, 0)) as an Fq12 tensor."""
    out = torch.zeros((*A.shape[:-1], 2, 3, 2), dtype=torch.int64,
                      device=A.device)
    out[..., 0, 0, :] = A
    out[..., 0, 1, :] = B
    out[..., 1, 1, :] = Cc
    return out


def miller_dbl_step(f, T, xP, yP):
    """f ← f²·l_{T,T}(P), T ← 2T (``_miller_dbl_step``).
    Line: A = 3X³ − 2Y²Z, B = −3X²Z·xP, C = 2YZ²·yP."""
    X, Y, Z = T.unbind(-2)
    XX, YY, ZZ = fq2_mul(T, T).unbind(-2)
    X3, Y2Z, X2Z, YZ2 = fq2_mul(_st([X, YY, XX, Y], -2),
                                _st([XX, Z, Z, ZZ], -2)).unbind(-2)
    m3 = k_muls(_st([X3, X2Z], -2), 3)
    m2 = k_muls(_st([Y2Z, YZ2], -2), 2)
    A = k_sub(m3[..., 0, :], m2[..., 0, :])
    bc = fq2_mul_fq(_st([m3[..., 1, :], m2[..., 1, :]], -2),
                    _st([xP, yP], -1))
    line = _line_fq12(A, k_neg(bc[..., 0, :]), bc[..., 1, :])
    T2 = point_add(_G2ops, T, T)
    return fq12_mul(fq12_sqr(f), line), T2


def miller_add_step(f, T2, Qx, Qy, Q, xP, yP):
    """f ← f·l_{T,Q}(P), T ← T + Q (``_miller_add_step``)."""
    X, Y, Z = T2.unbind(-2)
    r = fq2_mul(_st([Qy, Qx], -2), _st([Z, Z], -2))
    nd = k_sub(r, _st([Y, X], -2))
    Nn, Dd = nd.unbind(-2)
    r2 = fq2_mul(_st([Nn, Qy], -2), _st([Qx, Dd], -2))
    A = k_sub(r2[..., 0, :], r2[..., 1, :])
    bc = fq2_mul_fq(nd, _st([xP, yP], -1))
    line = _line_fq12(A, k_neg(bc[..., 0, :]), bc[..., 1, :])
    T3 = point_add(_G2ops, T2, Q)
    return fq12_mul(f, line), T3


def miller_loop(xP, yP, Qx, Qy):
    """Conjugated Miller loop f_{|x|,Q}(P) over lanes: xP, yP (26, L),
    Qx, Qy (26, L, 2) Montgomery affine → (26, L, 2, 3, 2)."""
    lanes = xP.shape[1:]
    Q = _st([Qx, Qy, _fq2_one(lanes, xP.device)], -2)
    f = fq12_one_like(lanes, xP.device)
    T = Q
    for bit in X_BITS_MILLER:
        f, T = miller_dbl_step(f, T, xP, yP)
        if bit:
            f, T = miller_add_step(f, T, Qx, Qy, Q, xP, yP)
    return fq12_conj(f)                  # x < 0


@torch.inference_mode()
def miller_fold_plain(g1_planes, g2_planes, mask):
    """Plain PyTorch version of :func:`miller_fold_kernel_call`.  Only the
    live lanes run the Miller loop (a dead lane is 1 whatever its loop
    gave, so the result is the kernel's)."""
    m = g1_planes.shape[1]
    dev = g1_planes.device
    f = fq12_one_like((m,), dev)
    live = torch.nonzero(mask[0] != 0).flatten()
    if live.numel():
        P = planes_in(g1_planes[:, live], 2)
        Q = planes_in(g2_planes[:, live], 4).reshape(LIMBS, -1, 2, 2)
        f[:, live] = miller_loop(P[..., 0], P[..., 1], Q[..., 0, :],
                                 Q[..., 1, :])
    f = f.reshape(LIMBS, m // (2 * LANE_BLOCK), 2, LANE_BLOCK, 2, 3, 2)
    out = fq12_mul(f[:, :, 0], f[:, :, 1])     # lane j · lane j+128
    return planes_out(out.reshape(LIMBS, m // 2, 12))


def miller_fold_kernel_call(g1_planes, g2_planes, mask):
    """g1 (64, C·256) affine blocks, g2 (128, C·256), mask (1, C·256)
    int32 → (384, C·128): per 256-lane cell, the conjugated Miller value
    of each pair (1 where the mask is 0), lane j times lane j+128."""
    _check_planes(g1_planes, 2 * BLOCK_ROWS, "g1", 2 * LANE_BLOCK)
    m = g1_planes.shape[1]
    _check_planes(g2_planes, 4 * BLOCK_ROWS, "g2", 2 * LANE_BLOCK)
    _check_planes(mask, 1, "mask")
    if g2_planes.shape[1] != m or mask.shape[1] != m:
        raise ValueError("g1, g2 and mask must have the same lanes")
    if not g1_planes.device == g2_planes.device == mask.device:
        raise ValueError("g1, g2 and mask must share a device")
    if g1_planes.device.type == "cpu":
        return miller_fold_plain(g1_planes, g2_planes, mask)
    _require_cuda(g1_planes)
    out = torch.empty((FQ12_ROWS, m // 2), dtype=torch.int32,
                      device=g1_planes.device)
    lib = kernel_library()
    _check_rc(lib.lh_miller_fold(_ptr(g1_planes), _ptr(g2_planes),
                                 _ptr(mask), out.data_ptr(), m,
                                 _stream(g1_planes)), "miller_fold")
    LAUNCHES["miller_fold"] += 1
    return out


@torch.inference_mode()
def miller_plain(g1_planes, g2_planes):
    """Plain PyTorch version of :func:`miller_kernel_call`.  Lanes with
    equal inputs give equal outputs, so each distinct (g1, g2) lane is
    computed once."""
    pairs, inv = torch.unique(torch.cat([g1_planes, g2_planes]).T, dim=0,
                              return_inverse=True)
    P = planes_in(pairs[:, :2 * BLOCK_ROWS].T, 2)
    Q = planes_in(pairs[:, 2 * BLOCK_ROWS:].T, 4).reshape(LIMBS, -1, 2, 2)
    f = miller_loop(P[..., 0], P[..., 1], Q[..., 0, :], Q[..., 1, :])
    return planes_out(f.reshape(LIMBS, -1, 12)[:, inv])


def miller_kernel_call(g1_planes, g2_planes):
    """g1 (64, M) affine blocks, g2 (128, M), M a multiple of 128 → the
    conjugated Miller value of every lane, (384, M)."""
    _check_planes(g1_planes, 2 * BLOCK_ROWS, "g1", LANE_BLOCK)
    m = g1_planes.shape[1]
    _check_planes(g2_planes, 4 * BLOCK_ROWS, "g2", LANE_BLOCK)
    if g2_planes.shape[1] != m or g2_planes.device != g1_planes.device:
        raise ValueError(f"g2 must be (128, {m}) on {g1_planes.device}")
    if g1_planes.device.type == "cpu":
        return miller_plain(g1_planes, g2_planes)
    _require_cuda(g1_planes)
    out = torch.empty((FQ12_ROWS, m), dtype=torch.int32,
                      device=g1_planes.device)
    _check_rc(kernel_library().lh_miller(_ptr(g1_planes), _ptr(g2_planes),
                                         out.data_ptr(), m,
                                         _stream(g1_planes)), "miller")
    LAUNCHES["miller"] += 1
    return out


# ---------------------------------------------------------------------------
# Lane products: the 256 → 128 chunk fold and the roll butterfly
# ---------------------------------------------------------------------------

def _fq12_masked(f_planes, mask):
    """(384, M) blocks → (26, M, 2, 3, 2) limbs, 1 where the mask is 0."""
    m = f_planes.shape[1]
    f = planes_in(f_planes, 12).reshape(LIMBS, m, 2, 3, 2)
    return _sel(mask[0] != 0, f, fq12_one_like((m,), f.device))


def _check_product_args(f_planes, mask, lanes_ok, what: str):
    _check_planes(f_planes, FQ12_ROWS, "f")
    m = f_planes.shape[1]
    if not lanes_ok(m):
        raise ValueError(f"lane count must be {what}, got {m}")
    _check_planes(mask, 1, "mask")
    if mask.shape[1] != m or mask.device != f_planes.device:
        raise ValueError(f"mask must be (1, {m}) on {f_planes.device}")
    return m


@torch.inference_mode()
def product_chunks_plain(f_planes, mask):
    """Plain PyTorch version of :func:`product_chunks_kernel_call`."""
    m = f_planes.shape[1]
    f = _fq12_masked(f_planes, mask).reshape(
        LIMBS, m // (2 * LANE_BLOCK), 2, LANE_BLOCK, 2, 3, 2)
    out = fq12_mul(f[:, :, 0], f[:, :, 1])     # lane j · lane j+128
    return planes_out(out.reshape(LIMBS, m // 2, 12))


def product_chunks_kernel_call(f_planes, mask):
    """f (384, C·256), mask (1, C·256) int32 → (384, C·128): output lane j
    of chunk c is the masked f_{c·256+j} · f_{c·256+j+128}."""
    m = _check_product_args(f_planes, mask,
                            lambda n: n > 0 and n % (2 * LANE_BLOCK) == 0,
                            "C · 256")
    if f_planes.device.type == "cpu":
        return product_chunks_plain(f_planes, mask)
    _require_cuda(f_planes)
    out = torch.empty((FQ12_ROWS, m // 2), dtype=torch.int32,
                      device=f_planes.device)
    _check_rc(kernel_library().lh_product_chunks(
        _ptr(f_planes), _ptr(mask), out.data_ptr(), m, _stream(f_planes)),
        "product_chunks")
    LAUNCHES["product_chunks"] += 1
    return out


@torch.inference_mode()
def product_plain(f_planes, mask):
    """Plain PyTorch version of :func:`product_kernel_call`."""
    m = f_planes.shape[1]
    f = _fq12_masked(f_planes, mask)
    w = m // 2
    while w >= LANE_BLOCK:      # lane j times lane (j + w) mod M
        f = fq12_mul(f, torch.roll(f, -w, dims=1))
        w //= 2
    return planes_out(f.reshape(LIMBS, m, 12))


def _pow2_lanes(n: int) -> bool:
    return n >= LANE_BLOCK and n & (n - 1) == 0


def product_kernel_call(f_planes, mask):
    """f (384, M), mask (1, M) int32, M a power of two ≥ 128 → (384, M):
    lane j holds the product of the masked lanes ≡ j (mod 128), by the
    reference's roll butterfly (w = M/2 … 128).  On the card M is at most
    16384: a block holds its class's M/128 lanes twice in shared memory
    (``LH_PRODUCT_R_MAX``), and the launch refuses larger planes."""
    m = _check_product_args(f_planes, mask, _pow2_lanes,
                            "a power of two ≥ 128")
    if f_planes.device.type == "cpu":
        return product_plain(f_planes, mask)
    _require_cuda(f_planes)
    out = torch.empty((FQ12_ROWS, m), dtype=torch.int32,
                      device=f_planes.device)
    _check_rc(kernel_library().lh_product(
        _ptr(f_planes), _ptr(mask), out.data_ptr(), m, _stream(f_planes)),
        "product")
    LAUNCHES["product"] += 1
    return out


# ---------------------------------------------------------------------------
# Finalize: 128 → 1 fold + cubed final exponentiation + == 1
# ---------------------------------------------------------------------------

def fq12_pow_x_abs(f):
    """f^|x|, MSB-first over the 64 bits of |x|."""
    acc = fq12_one_like(f.shape[1:-3], f.device)
    for bit in X_BITS_FULL:
        acc = fq12_sqr(acc)
        if bit:
            acc = fq12_mul(acc, f)
    return acc


def pow_u(f):
    """f^u for the (negative) BLS parameter — cyclotomic f only."""
    return fq12_conj(fq12_pow_x_abs(f))


def final_exp_easy(f):
    """f^((q⁶−1)(q²+1)), with the true Fq12 inverse."""
    m = fq12_mul(fq12_conj(f), fq12_inv(f))
    return fq12_mul(fq12_frobenius(m, 2), m)


def final_exp_hard(m):
    """HHT hard part ×3: m^(3·(p⁴−p²+1)/r) for cyclotomic m."""
    m1 = fq12_mul(pow_u(m), fq12_conj(m))
    k2 = fq12_mul(pow_u(m1), fq12_conj(m1))
    k3 = fq12_mul(pow_u(k2), fq12_frobenius(k2, 1))
    k4 = fq12_mul(fq12_mul(pow_u(pow_u(k3)), fq12_frobenius(k3, 2)),
                  fq12_conj(k3))
    return fq12_mul(k4, fq12_mul(fq12_sqr(m), m))


@torch.inference_mode()
def finalize_plain(f_planes, with_value: bool = False):
    """Plain PyTorch version of :func:`finalize_kernel_call`: the
    256 → 128 chunk folds down to 128 lanes, then the fold keeps only
    the lanes that lane 0's result reads (step w multiplies lane j by
    lane j + w for j < w), so lane 0 is the reference's lane 0."""
    while f_planes.shape[1] > LANE_BLOCK:
        f_planes = product_chunks_plain(f_planes, torch.ones(
            (1, f_planes.shape[1]), dtype=torch.int32,
            device=f_planes.device))
    f = planes_in(f_planes, 12).reshape(LIMBS, LANE_BLOCK, 2, 3, 2)
    w = LANE_BLOCK // 2
    while w >= 1:
        f = fq12_mul(f[:, :w], f[:, w:2 * w])
        w //= 2
    g = final_exp_hard(final_exp_easy(f))
    ok = fq12_is_one(g).to(torch.int32).reshape(1, 1)
    if with_value:
        return ok, planes_out(g.reshape(LIMBS, 1, 12))
    return ok


def finalize_kernel_call(f_planes, with_value: bool = False):
    """(384, M) residue-class products, M a power of two ≥ 128 → (1, 1)
    int32 ``∏ == 1`` flag (with ``with_value``, also the (384, 1) cubed
    final exponentiation of the product).  Above 128 lanes,
    :func:`product_chunks_kernel_call` halves the width first, as the
    reference's ``_finalize_call_body`` does."""
    _check_planes(f_planes, FQ12_ROWS, "f")
    if not _pow2_lanes(f_planes.shape[1]):
        raise ValueError("lane count must be a power of two ≥ 128, got "
                         f"{f_planes.shape[1]}")
    while f_planes.shape[1] > LANE_BLOCK:
        ones = torch.ones((1, f_planes.shape[1]), dtype=torch.int32,
                          device=f_planes.device)
        f_planes = product_chunks_kernel_call(f_planes, ones)
    if f_planes.device.type == "cpu":
        return finalize_plain(f_planes, with_value)
    _require_cuda(f_planes)
    dev = f_planes.device
    ok = torch.empty((1, 1), dtype=torch.int32, device=dev)
    g = torch.empty((FQ12_ROWS, 1), dtype=torch.int32, device=dev)
    _check_rc(kernel_library().lh_finalize(_ptr(f_planes), ok.data_ptr(),
                                           g.data_ptr(), _stream(f_planes)),
              "finalize")
    LAUNCHES["finalize"] += 1
    return (ok, g) if with_value else ok


# ---------------------------------------------------------------------------
# The CUDA library
# ---------------------------------------------------------------------------

_LIB = "bls381"
_P, _LL = ctypes.c_void_p, ctypes.c_longlong
_SIGNATURES = {
    "lh_bls_init": [_P, ctypes.c_int],
    # u, out, u lanes, stream
    "lh_hash_g2": [_P, _P, _LL, _P],
    # sig, mask, lo, hi, out, lanes, stream
    "lh_sigma": [_P, _P, _P, _P, _P, _LL, _P],
    # g1, g2, mask, out, lanes, stream
    "lh_miller_fold": [_P, _P, _P, _P, _LL, _P],
    # which kernel (GROUP_KERNELS index), info out
    "lh_group_kernel_info": [ctypes.c_int, _P],
    # f, ok, g, stream
    "lh_finalize": [_P, _P, _P, _P],
    # partial 0, partial 1 (or partial 0 again), cols, flags, lanes,
    # partials, stream
    "lh_sigma_combine": [_P, _P, _P, _P, _LL, ctypes.c_int, _P],
    # pk, kmask, lo, hi, out, flags, set lanes, K, stream
    "lh_prepare": [_P, _P, _P, _P, _P, _P, _LL, ctypes.c_int, _P],
    # f, mask, out, lanes, stream
    "lh_product_chunks": [_P, _P, _P, _LL, _P],
    # g1, g2, out, lanes, stream
    "lh_miller": [_P, _P, _P, _LL, _P],
    # f, mask, out, lanes, stream
    "lh_product": [_P, _P, _P, _LL, _P],
    # a, b, out, lanes, stream
    "lh_fp_mul": [_P, _P, _P, _LL, _P],
    # xy, out, chain length, stream
    "lh_fp_mul_chain": [_P, _P, ctypes.c_int, _P],
}
_LIB_READY = []


def _fp_words(x: int) -> list:
    return [(x >> (32 * i)) & 0xFFFFFFFF for i in range(13)]


def _fp2_words(v) -> list:
    """Host Fq2 value → Montgomery words (c0 then c1)."""
    out = []
    for c in (v[0] % F.P, v[1] % F.P):
        out += _fp_words(c * LF.R_MOD_N % F.P)
    return out


def _bits_words(e: int, nwords: int) -> list:
    return [(e >> (32 * i)) & 0xFFFFFFFF for i in range(nwords)]


def cuda_consts() -> np.ndarray:
    """The kernels' ``BlsConsts`` block (``csrc/bls381_field.cuh``), field
    by field in its declaration order, as uint32 words."""
    P = F.P
    w = []
    for k in (1, 2, 4, 8, 16):                 # N, N2, K4, K8, K16
        w += _fp_words(k * P)
    w += _fp_words(LF.R_MOD_N)                 # ONE (Montgomery 1)
    w += _fp_words(1)                          # RAW_ONE
    for k in range(8):                         # ZP[k] = k·N
        w += _fp_words(k * P)
    for n in (1, 2, 3):                        # FROB[n-1][i*3+j]
        for i in range(2):
            for j in range(3):
                for u in range(2):
                    w += _fp_words(LF.limbs_to_int(XP._GAMMA[n][i, j, u]))
    h = H2C_VALUES
    for name in ("A", "B", "Z", "NEGBA", "X1EXC"):
        w += _fp2_words(h[name])
    for tag, count in (("E8I", 4), ("T", 4), ("XN", 4), ("XD", 3),
                       ("YN", 4), ("YD", 4)):
        for i in range(count):
            w += _fp2_words(h[f"{tag}{i}"])
    w += _fp2_words(h["PSI_CX"]) + _fp2_words(h["PSI_CY"])
    w.append((-pow(P, -1, 1 << 32)) % (1 << 32))       # n0inv
    w += [len(X_BITS_FULL), len(P_MINUS_2_BITS), H2C.E16_EXP.bit_length()]
    w += _bits_words(XP.X_ABS, 2)
    w += _bits_words(P - 2, 12)
    w += _bits_words(H2C.E16_EXP, 24)
    return np.asarray(w, dtype=np.uint32)


def kernel_library() -> ctypes.CDLL:
    """The built and loaded BLS kernel library, its constant block
    uploaded (compiles at first call)."""
    from ..ops.cuda_build import load
    lib = load(_LIB, _SIGNATURES)
    if not _LIB_READY:
        consts = cuda_consts()
        _check_rc(lib.lh_bls_init(consts.ctypes.data, consts.size),
                  "bls constant upload")
        _LIB_READY.append(True)
    return lib


# The thread-group kernels, in ``lh_group_kernel_info``'s order: Miller+fold,
# hash-to-G2, the sigma ladder, prepare, the sigma butterfly (whose group
# is one block of its cluster), product_chunks and the Miller loop alone.
GROUP_KERNELS = ("miller_fold", "hash_g2", "sigma", "prepare", "sigma_fold",
                 "product_chunks", "miller", "product")


def group_kernel_info(which: str) -> dict:
    """Launch shape and ptxas resources of a group kernel (a name of
    :data:`GROUP_KERNELS`)."""
    info = np.zeros(7, np.int32)
    _check_rc(kernel_library().lh_group_kernel_info(
        GROUP_KERNELS.index(which), info.ctypes.data), "group kernel info")
    return dict(zip(("G", "groups", "shared_bytes_per_group", "registers",
                     "local_bytes", "lanes_per_group", "cluster"),
                    (int(v) for v in info)))


def _check_rc(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what} failed: CUDA error {rc}")


def _require_cuda(x: torch.Tensor) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")


def _ptr(x: torch.Tensor) -> int:
    if not x.is_contiguous():
        raise ValueError("kernel inputs must be contiguous")
    return x.data_ptr()


def _stream(x: torch.Tensor) -> int:
    return torch.cuda.current_stream(x.device).cuda_stream


def fp_mul_kernel(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """One Montgomery product per lane on the card: (32, n) × (32, n)
    int32 blocks → (32, n).  A probe of the kernels' field core for
    ``chip_smoke.py`` (its SASS prices a product); no verify path calls
    it."""
    _require_cuda(a)
    n = a.shape[1]
    out = torch.empty((BLOCK_ROWS, n), dtype=torch.int32, device=a.device)
    _check_rc(kernel_library().lh_fp_mul(_ptr(a), _ptr(b), out.data_ptr(),
                                         n, _stream(a)), "fp_mul")
    return out


def fp_mul_chain_kernel(xy: torch.Tensor, n: int) -> torch.Tensor:
    """x ← x·y, n dependent Montgomery products on ONE thread of the card:
    xy (32, 2) int32 blocks (x in lane 0, y in lane 1) → x, (32, 1).  The
    latency probe that prices the finalize's and sigma_combine's chain
    bound in ``chip_smoke.py``; no verify path calls it."""
    _require_cuda(xy)
    _check_planes(xy, BLOCK_ROWS, "xy")
    if xy.shape[1] != 2:
        raise ValueError(f"xy must be ({BLOCK_ROWS}, 2), got {tuple(xy.shape)}")
    out = torch.empty((BLOCK_ROWS, 1), dtype=torch.int32, device=xy.device)
    _check_rc(kernel_library().lh_fp_mul_chain(_ptr(xy), out.data_ptr(), n,
                                               _stream(xy)), "fp_mul_chain")
    return out


@torch.inference_mode()
def fp_mul_chain_plain(xy: torch.Tensor, n: int) -> torch.Tensor:
    """Plain PyTorch version of :func:`fp_mul_chain_kernel`."""
    t = planes_in(xy, 1)[..., 0]
    x, y = t[:, :1], t[:, 1:2]
    for _ in range(n):
        x = mont_mul(x, y)
    return planes_out(x.unsqueeze(-1))
