"""Batched hash-to-curve onto G2 (RFC 9380 SSWU) on the GPU: the CUDA
kernel wrapper, its plain PyTorch version, and the host marshalling.

Port of ``lighthouse_tpu/crypto/htc_kernel.py``.  Its Pallas kernel
``_hash_g2_kernel`` becomes ``lh_hash_g2_kernel`` in ``csrc/bls381.cu``
(:func:`hash_g2_kernel_call`).  The host computes ``expand_message_xmd``
(SHA-256) and ships the two Fq2 field elements per message; the device
runs, per message,

    u → simplified SWU onto E' (branchless 8-candidate sqrt, one 758-bit
    Fq2 ladder) → 3-isogeny to E (projective) → u0 + u1 → Budroni–Pintore
    ψ cofactor clearing (two |x| ladders) → affine.

The kernel runs one thread group per message: u0 and u1 side by side,
each step's independent products as one wave.  The u layout is the JAX
package's: each 128-message cell holds 256 lanes, u0 in lanes
[g·256, g·256+128) and u1 in the next 128.
:func:`hash_g2_plain` is the plain version; the wrapper runs it only for
a tensor on the CPU.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from . import hash_to_curve as H2C
from . import limb_field as LF
from .pairing_kernel import (
    BLOCK_ROWS, LANE_BLOCK, LIMBS, X_BITS_FULL, _G2ops, _K, _bc, _check_planes,
    _check_rc, _fq2_one, _ptr, _require_cuda, _sel, _st, _stream,
    fq2_conj, fq2_eq, fq2_inv, fq2_is_zero, fq2_mul, k_add, k_canonical,
    k_neg, kernel_library, planes_in, planes_out, point_add, point_identity)

# LSB-first bits of (p²+7)/16 — the sqrt-ladder exponent (758 bits).
E16_BITS_LSB = np.array(
    [(H2C.E16_EXP >> i) & 1 for i in range(H2C.E16_EXP.bit_length())],
    dtype=np.int32)

LAUNCHES = {"hash_g2": 0}


def _kc2(name: str, like: torch.Tensor) -> torch.Tensor:
    """Fq2 constant viewed to broadcast against the Fq2 tensor ``like``."""
    return _bc(_K(like).H2C[name], like, 1)


def k_sgn0_fq2(a):
    """RFC 9380 sgn0 over Fq2 on canonical values — (*S) int64 ∈ {0, 1}."""
    c = k_canonical(a)
    s0 = c[0, ..., 0] & 1
    z0 = (c[..., 0] == 0).all(0).to(torch.int64)
    s1 = c[0, ..., 1] & 1
    return s0 | (z0 & s1)


def k_fq2_pow_e16(a):
    """a^((p²+7)/16), LSB-first: base² and res·base as one wide multiply
    per bit."""
    res = _fq2_one(a.shape[1:-1], a.device)
    base = a
    for bit in E16_BITS_LSB:
        if bit:
            prods = fq2_mul(_st([base, res], -2), _st([base, base], -2))
            base, res = prods[..., 0, :], prods[..., 1, :]
        else:
            base = fq2_mul(base, base)
    return res


def k_sswu_map(t):
    """Simplified SWU onto E' (``k_sswu_map``): t (26, *S, 2) → affine
    (x, y) on E'."""
    Zc = _kc2("Z", t)
    tt = fq2_mul(t, t)
    tv1 = fq2_mul(Zc, tt)                           # Z t²
    tv2 = k_add(fq2_mul(tv1, tv1), tv1)             # Z²t⁴ + Zt²
    d_zero = fq2_is_zero(tv2)
    x1 = fq2_mul(_kc2("NEGBA", t),
                 k_add(_fq2_one(t.shape[1:-1], t.device), fq2_inv(tv2)))
    x1 = _sel(d_zero, _kc2("X1EXC", t).expand_as(x1), x1)
    xx = fq2_mul(_st([x1, _kc2("A", t).expand_as(x1)], -2),
                 _st([x1, x1], -2))                 # x1², A·x1
    gx1 = k_add(fq2_mul(xx[..., 0, :], x1), k_add(xx[..., 1, :],
                                                   _kc2("B", t)))
    c = k_fq2_pow_e16(gx1)
    zgx1 = fq2_mul(Zc, gx1)
    # 8-candidate sqrt: the last matching candidate wins, as in the
    # reference's select chain.
    e8 = _st([_kc2(f"E8I{k}", t).expand_as(c) for k in range(4)]
             + [_kc2(f"T{k}", t).expand_as(c) for k in range(4)], -2)
    cand = fq2_mul(c.unsqueeze(-2), e8)
    sq = fq2_mul(cand, cand)
    target = _st([gx1] * 4 + [zgx1] * 4, -2)
    ok = fq2_eq(sq, target)                          # (*S, 8)
    y1 = torch.zeros_like(c)
    s = torch.zeros_like(c)
    is_qr = torch.zeros(ok.shape[:-1], dtype=torch.bool, device=t.device)
    for k in range(4):
        y1 = _sel(ok[..., k], cand[..., k, :], y1)
        is_qr = is_qr | ok[..., k]
        s = _sel(ok[..., 4 + k], cand[..., 4 + k, :], s)
    x2 = fq2_mul(tv1, x1)
    y2 = fq2_mul(fq2_mul(tv1, t), s)
    x = _sel(is_qr, x1, x2)
    y = _sel(is_qr, y1, y2)
    flip = k_sgn0_fq2(t) != k_sgn0_fq2(y)
    return x, _sel(flip, k_neg(y), y)


def k_iso_map_proj(x, y):
    """3-isogeny E' → E as projective (XN·YD, y·YN·XD, XD·YD)."""
    x_2 = fq2_mul(x, x)
    x_3 = fq2_mul(x_2, x)
    pows = (None, x, x_2, x_3)

    def poly(tag, degree, monic):
        acc = _kc2(f"{tag}0", x)
        for i in range(1, degree + 1):
            if monic and i == degree:
                continue
            acc = k_add(acc, fq2_mul(_kc2(f"{tag}{i}", x), pows[i]))
        if monic:
            acc = k_add(acc, pows[degree])
        return acc

    xn = poly("XN", 3, monic=False)
    xd = poly("XD", 2, monic=True)
    yn = fq2_mul(y, poly("YN", 3, monic=False))
    yd = poly("YD", 3, monic=True)
    return _st([fq2_mul(xn, yd), fq2_mul(yn, xd), fq2_mul(xd, yd)], -2)


def k_g2_neg(p):
    return _st([p[..., 0, :], k_neg(p[..., 1, :]), p[..., 2, :]], -2)


def k_g2_mul_x_abs(p):
    """[|x|]·P, MSB-first double-and-add over the 64 static x bits."""
    acc = point_identity(_G2ops, p.shape[1:-2], p.device)
    for bit in X_BITS_FULL:
        acc = point_add(_G2ops, acc, acc)
        if bit:
            acc = point_add(_G2ops, acc, p)
    return acc


def k_psi(p):
    """Untwist-Frobenius-twist endomorphism, projective."""
    conj = fq2_conj(p)
    xy = fq2_mul(conj[..., :2, :],
                 _st([_kc2("PSI_CX", p[..., 0, :]),
                      _kc2("PSI_CY", p[..., 0, :])], -2))
    return torch.cat([xy, conj[..., 2:, :]], -2)


def k_clear_cofactor(p):
    """Budroni–Pintore: h_eff·P = ([x²]P − [x]P − P) + ψ([x]P − P) +
    ψ²([2]P)."""
    t1 = k_g2_neg(k_g2_mul_x_abs(p))            # [x]P (x < 0)
    t2 = k_g2_neg(k_g2_mul_x_abs(t1))           # [x²]P
    acc = point_add(_G2ops, t2, k_g2_neg(t1))
    acc = point_add(_G2ops, acc, k_g2_neg(p))
    acc = point_add(_G2ops, acc,
                    k_psi(point_add(_G2ops, t1, k_g2_neg(p))))
    return point_add(_G2ops, acc, k_psi(k_psi(point_add(_G2ops, p, p))))


@torch.inference_mode()
def hash_g2_plain(u_planes):
    """Plain PyTorch version of :func:`hash_g2_kernel_call`.  Lanes with
    equal inputs give equal outputs, so each distinct u lane, and each
    distinct (u0, u1) message, is computed once (the padding lanes of a
    batch are all zero)."""
    m2 = u_planes.shape[1]
    cells = m2 // (2 * LANE_BLOCK)
    u = planes_in(u_planes, 2)                       # (26, m2, 2)
    flat = u.permute(1, 0, 2).reshape(m2, -1)
    uniq, inv = torch.unique(flat, dim=0, return_inverse=True)
    t = uniq.reshape(-1, LIMBS, 2).permute(1, 0, 2)
    q = k_iso_map_proj(*k_sswu_map(t))               # (26, U, 3, 2)
    idx = inv.reshape(cells, 2, LANE_BLOCK)
    pairs = torch.stack([idx[:, 0], idx[:, 1]], -1).reshape(-1, 2)
    upairs, pinv = torch.unique(pairs, dim=0, return_inverse=True)
    p = point_add(_G2ops, q[:, upairs[:, 0]], q[:, upairs[:, 1]])
    p = k_clear_cofactor(p)
    zi = fq2_inv(p[..., 2, :])
    aff = fq2_mul(p[..., :2, :], zi.unsqueeze(-2))   # (26, U', 2, 2)
    return planes_out(aff[:, pinv].reshape(LIMBS, -1, 4))


def hash_g2_kernel_call(u_planes):
    """u (64, C·256) int32, two Fq2 u-values per message interleaved per
    128-message cell → (128, C·128) int32 affine G2 columns (the Miller
    kernel's G2 layout)."""
    _check_planes(u_planes, 2 * BLOCK_ROWS, "u_planes", 2 * LANE_BLOCK)
    if u_planes.device.type == "cpu":
        return hash_g2_plain(u_planes)
    _require_cuda(u_planes)
    m2 = u_planes.shape[1]
    out = torch.empty((4 * BLOCK_ROWS, m2 // 2), dtype=torch.int32,
                      device=u_planes.device)
    _check_rc(kernel_library().lh_hash_g2(_ptr(u_planes), out.data_ptr(), m2,
                                          _stream(u_planes)), "hash_g2")
    LAUNCHES["hash_g2"] += 1
    return out


# -- host marshalling ---------------------------------------------------------


@lru_cache(maxsize=1 << 14)
def _u_cols(msg: bytes) -> bytes:
    """Montgomery u-value columns for one message (2 × 64 rows), memoised."""
    u0, u1 = H2C.hash_to_field_fq2(msg, 2)
    out = np.zeros((2, 2 * BLOCK_ROWS), np.uint32)
    for j, u in enumerate((u0, u1)):
        out[j, 0:26] = LF.to_mont(u[0])
        out[j, 32:58] = LF.to_mont(u[1])
    return out.tobytes()


def u_planes_for_messages(messages, n_cells: int) -> np.ndarray:
    """expand_message_xmd each message (host SHA-256) and pack the Fq2
    u-values into the kernel's interleaved Montgomery column layout.
    ``messages``: list of (cell, slot, bytes); cells beyond the list pad
    with zero (still well-defined SSWU inputs, masked downstream)."""
    out = np.zeros((2 * BLOCK_ROWS, n_cells * 2 * LANE_BLOCK), np.uint32)
    for cell, slot, msg in messages:
        cols = np.frombuffer(_u_cols(bytes(msg)), np.uint32).reshape(2, -1)
        base = cell * 2 * LANE_BLOCK
        out[:, base + slot] = cols[0]
        out[:, base + LANE_BLOCK + slot] = cols[1]
    return out
