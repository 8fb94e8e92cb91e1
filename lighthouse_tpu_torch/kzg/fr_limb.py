"""Batched Fr (BLS12-381 scalar field) arithmetic in 16-bit limbs, as
torch ops: the plain version of the card's KZG kernel.

Port of ``lighthouse_tpu/kzg/fr_limb.py`` in its layout: little-endian
16-bit limbs on the last axis, Montgomery residues with R = 2^272 (17
limbs), lazy values < 2N, batched over the leading axes.  mont_mul's output
(T + mN)/R < 4N²/R + N < 2N because 4N/R < 2^-15.  Every operation is the
JAX package's, value for value, so the limbs equal its limbs.

Limbs are int64 tensors.  The JAX package's uint32 arithmetic never
wraps here (no product, column sum or carry reaches 2^32) and its int32
borrows are arithmetic shifts, which int64 keeps, so each value is the
JAX package's exactly.  The card's kernel (``csrc/kzg_fr.cu``) takes its
own domain (8 words, R = 2^256) and meets this module in canonical
values.
"""

from __future__ import annotations

import numpy as np
import torch

from .fr import BLS_MODULUS as N_INT

LIMB_BITS = 16
LIMBS = 17
MASK = 0xFFFF
R_BITS = LIMB_BITS * LIMBS          # 272
R_INT = 1 << R_BITS
R_MOD_N = R_INT % N_INT
R2_MOD_N = R_INT * R_INT % N_INT
RINV_INT = pow(R_INT, -1, N_INT)
NPRIME_INT = (-pow(N_INT, -1, R_INT)) % R_INT

# MSB-first exponent bits for the Fermat inversion ladder a^(N-2).
N_MINUS_2_BITS = [int(b) for b in bin(N_INT - 2)[2:]]


def int_to_limbs(x: int) -> np.ndarray:
    if not 0 <= x < R_INT:
        raise ValueError("value out of limb range")
    return np.array([(x >> (LIMB_BITS * i)) & MASK for i in range(LIMBS)],
                    dtype=np.int64)


def limbs_to_int(limbs) -> int:
    limbs = np.asarray(limbs, dtype=np.int64)
    return sum(int(v) << (LIMB_BITS * i) for i, v in enumerate(limbs))


N_LIMBS = int_to_limbs(N_INT)
N2_LIMBS = int_to_limbs(2 * N_INT)
R2_LIMBS = int_to_limbs(R2_MOD_N)
_NPRIME_LIMBS = int_to_limbs(NPRIME_INT)


def to_mont(x: int) -> np.ndarray:
    return int_to_limbs((x % N_INT) * R_MOD_N % N_INT)


def from_mont(limbs) -> int:
    return limbs_to_int(limbs) * RINV_INT % N_INT


def to_mont_array(xs) -> np.ndarray:
    """Nested sequence/array of python ints → (..., 17) Montgomery limbs
    (host; the tests' bridge to the JAX package)."""
    arr = np.asarray(xs, dtype=object)
    flat = [to_mont(int(x)) for x in arr.reshape(-1)]
    out = np.stack(flat) if flat else np.zeros((0, LIMBS), np.int64)
    return out.reshape(arr.shape + (LIMBS,))


def from_mont_array(limbs) -> np.ndarray:
    arr = np.asarray(limbs)
    flat = arr.reshape(-1, LIMBS)
    out = np.empty(flat.shape[0], dtype=object)
    for i in range(flat.shape[0]):
        out[i] = from_mont(flat[i])
    return out.reshape(arr.shape[:-1])


ONE_MONT = to_mont(1)


_CONSTS: dict = {}


def _const(limbs: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    """A limb constant on ``like``'s device, copied there once."""
    key = (limbs.tobytes(), str(like.device))
    got = _CONSTS.get(key)
    if got is None:
        got = _CONSTS[key] = torch.as_tensor(limbs, dtype=torch.int64,
                                             device=like.device)
    return got


# ---------------------------------------------------------------------------
# Batched ops (limb axis = -1): the JAX package's, op for op
# ---------------------------------------------------------------------------

def _carry(x: torch.Tensor, ncols: int, keep_carry: bool = False):
    """Sequential carry over the first ``ncols`` limbs: each becomes its
    low 16 bits, the rest moves up (an arithmetic shift, so a negative
    column borrows).  Returns the limbs and the final carry."""
    out = []
    carry = torch.zeros_like(x[..., 0])
    for i in range(ncols):
        v = x[..., i] + carry
        out.append(v & MASK)
        carry = v >> LIMB_BITS
    if keep_carry:
        out.append(carry)
    return torch.stack(out, dim=-1), carry


def _cond_sub(x: torch.Tensor, k_limbs: np.ndarray) -> torch.Tensor:
    """x - k where x >= k, else x (x normalized)."""
    d, carry = _carry(x - _const(k_limbs, x), LIMBS)
    return torch.where((carry == 0).unsqueeze(-1), d, x)


def add(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return _cond_sub(_carry(a + b, LIMBS)[0], N2_LIMBS)


def sub(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return _cond_sub(_carry(a + _const(N2_LIMBS, a) - b, LIMBS)[0],
                     N2_LIMBS)


def _band_columns(a: torch.Tensor, b: torch.Tensor, ncols: int):
    """Column sums of the limb products a_i·b_j (low halves at column
    i + j, high halves at i + j + 1), cut to ``ncols`` columns."""
    prod = a.unsqueeze(-1) * b.unsqueeze(-2)           # (..., i, j)
    lo = prod & MASK
    hi = prod >> LIMB_BITS
    shape = torch.broadcast_shapes(a.shape[:-1], b.shape[:-1]) + (ncols,)
    out = torch.zeros(shape, dtype=torch.int64, device=a.device)
    for i in range(LIMBS):
        width = min(LIMBS, ncols - i)
        if width > 0:
            out[..., i:i + width] += lo[..., i, :width]
        width = min(LIMBS, ncols - i - 1)
        if width > 0:
            out[..., i + 1:i + 1 + width] += hi[..., i, :width]
    return out


def mont_mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Batched a·b·R⁻¹ mod N; normalized < 2N in, < 2N out."""
    t = _band_columns(a, b, 2 * LIMBS)
    t_low = _carry(t[..., :LIMBS], LIMBS)[0]
    m = _carry(_band_columns(t_low, _const(_NPRIME_LIMBS, a), LIMBS),
               LIMBS)[0]
    u = _band_columns(m, _const(N_LIMBS, a), 2 * LIMBS)
    s = _carry(t + u, 2 * LIMBS, keep_carry=True)[0]
    return s[..., LIMBS:2 * LIMBS]


def select(mask: torch.Tensor, a: torch.Tensor, b: torch.Tensor):
    return torch.where(mask.unsqueeze(-1), a, b)


def is_zero(a: torch.Tensor) -> torch.Tensor:
    """Exact zero test for lazy values < 4N."""
    out = None
    for k in range(4):
        eq = torch.all(a == _const(int_to_limbs(k * N_INT), a), dim=-1)
        out = eq if out is None else (out | eq)
    return out


def inv(a: torch.Tensor) -> torch.Tensor:
    """Batched Fermat inversion a^(N-2); inv(0) = 0.  The ladder of the JAX
    package (square, then multiply on a set bit); the bits are constants,
    so the multiply runs only where the JAX program selects it."""
    acc = _const(ONE_MONT, a).expand(a.shape).clone()
    for bit in N_MINUS_2_BITS:
        acc = mont_mul(acc, acc)
        if bit:
            acc = mont_mul(acc, a)
    return acc


def canonical(a: torch.Tensor) -> torch.Tensor:
    """A lazy value < 2N reduced below N."""
    return _cond_sub(a, N_LIMBS)


def to_mont_t(x: torch.Tensor) -> torch.Tensor:
    """Canonical limbs → canonical Montgomery limbs, the JAX package's
    ``to_mont`` as torch ops (x·R² / R, then below N)."""
    return canonical(mont_mul(x, _const(R2_LIMBS, x)))


def from_mont_t(x: torch.Tensor) -> torch.Tensor:
    """Montgomery limbs < 2N → canonical limbs, the JAX package's
    ``from_mont`` as torch ops."""
    return canonical(mont_mul(x, _const(int_to_limbs(1), x)))


def words_to_limbs(words: torch.Tensor) -> torch.Tensor:
    """(..., 8) u32 words (any integer dtype holding their bit patterns)
    → (..., 17) int64 16-bit limbs."""
    w = words.to(torch.int64) & 0xFFFFFFFF
    limbs = torch.stack([w & MASK, w >> LIMB_BITS], dim=-1).flatten(-2)
    return torch.cat([limbs, torch.zeros_like(limbs[..., :1])], dim=-1)


def limbs_to_words(limbs: torch.Tensor) -> torch.Tensor:
    """(..., 17) normalized limbs of a value < 2^256 → (..., 8) int64 u32
    words."""
    pairs = limbs[..., :16].reshape(limbs.shape[:-1] + (8, 2))
    return pairs[..., 0] | (pairs[..., 1] << LIMB_BITS)
