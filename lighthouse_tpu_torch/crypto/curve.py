"""BLS12-381 G1/G2 group operations + ZCash-format serialization.

Host ground truth for the device curve kernels.  Mirrors the point/encoding
semantics of the reference's blst backend
(Lighthouse ``crypto/bls/src/impls/blst.rs``): compressed encodings with
the three ZCash flag bits, infinity handling, subgroup checks, and the
"infinity pubkey is invalid" rule
(Lighthouse ``crypto/bls/src/generic_public_key.rs:14-15``).

Points are affine tuples ``(x, y)`` with field elements per group (ints for
G1 over Fq, pairs for G2 over Fq2), and ``None`` for the point at infinity.
Internal arithmetic uses Jacobian coordinates generic over the field.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Optional, Tuple

from . import fields as F
from .fields import P, R


@dataclass(frozen=True)
class _Fld:
    """Field vtable so the Jacobian formulas are written once for Fq/Fq2."""
    add: Callable
    sub: Callable
    mul: Callable
    sqr: Callable
    neg: Callable
    inv: Callable
    muls: Callable  # multiply by small int
    zero: Any
    one: Any
    b: Any          # curve constant: y^2 = x^3 + b


FQ = _Fld(
    add=lambda a, b: (a + b) % P, sub=lambda a, b: (a - b) % P,
    mul=lambda a, b: a * b % P, sqr=lambda a: a * a % P,
    neg=lambda a: -a % P, inv=F.fq_inv,
    muls=lambda a, s: a * s % P,
    zero=0, one=1, b=4,
)

FQ2 = _Fld(
    add=F.fq2_add, sub=F.fq2_sub, mul=F.fq2_mul, sqr=F.fq2_sqr,
    neg=F.fq2_neg, inv=F.fq2_inv, muls=F.fq2_muls,
    zero=F.FQ2_ZERO, one=F.FQ2_ONE, b=(4, 4),  # 4(u + 1)
)

# Standard generators (public constants).
G1_GEN = (
    0x17F1D3A73197D7942695638C4FA9AC0FC3688C4F9774B905A14E3A3F171BAC586C55E83FF97A1AEFFB3AF00ADB22C6BB,
    0x08B3F481E3AAA0F1A09E30ED741D8AE4FCF5E095D5D00AF600DB18CB2C04B3EDD03CC744A2888AE40CAA232946C5E7E1,
)
G2_GEN = (
    (0x024AA2B2F08F0A91260805272DC51051C6E47AD4FA403B02B4510B647AE3D1770BAC0326A805BBEFD48056C8C121BDB8,
     0x13E02B6052719F607DACD3A088274F65596BD0D09920B61AB5DA61BBDC7F5049334CF11213945D57E5AC7D055D042B7E),
    (0x0CE5D527727D6E118CC9CDC6DA2E351AADFD9BAA8CBDD3A76D429A695160D12C923AC9CC3BACA289E193548608B82801,
     0x0606C4A02EA734CC32ACD2B02BC28B99CB3E287E85A763AF267492AB572E99AB3F370D275CEC1DA1AAA9075FF05F79BE),
)


# ---------------------------------------------------------------------------
# Jacobian arithmetic, generic over the field
# ---------------------------------------------------------------------------
# Jacobian (X, Y, Z): affine x = X/Z^2, y = Y/Z^3.  Infinity: Z = 0.

def _jac_from_affine(f: _Fld, p):
    if p is None:
        return (f.one, f.one, f.zero)
    return (p[0], p[1], f.one)


def _jac_is_inf(f: _Fld, p) -> bool:
    return p[2] == f.zero


def _jac_double(f: _Fld, p):
    X, Y, Z = p
    if _jac_is_inf(f, p) or Y == f.zero:
        return (f.one, f.one, f.zero)
    A = f.sqr(X)
    B = f.sqr(Y)
    C = f.sqr(B)
    D = f.muls(f.sub(f.sub(f.sqr(f.add(X, B)), A), C), 2)
    E = f.muls(A, 3)
    X3 = f.sub(f.sqr(E), f.muls(D, 2))
    Y3 = f.sub(f.mul(E, f.sub(D, X3)), f.muls(C, 8))
    Z3 = f.muls(f.mul(Y, Z), 2)
    return (X3, Y3, Z3)


def _jac_add(f: _Fld, p, q):
    if _jac_is_inf(f, p):
        return q
    if _jac_is_inf(f, q):
        return p
    X1, Y1, Z1 = p
    X2, Y2, Z2 = q
    Z1Z1 = f.sqr(Z1)
    Z2Z2 = f.sqr(Z2)
    U1 = f.mul(X1, Z2Z2)
    U2 = f.mul(X2, Z1Z1)
    S1 = f.mul(f.mul(Y1, Z2), Z2Z2)
    S2 = f.mul(f.mul(Y2, Z1), Z1Z1)
    if U1 == U2:
        if S1 == S2:
            return _jac_double(f, p)
        return (f.one, f.one, f.zero)
    H = f.sub(U2, U1)
    I = f.sqr(f.muls(H, 2))
    J = f.mul(H, I)
    rr = f.muls(f.sub(S2, S1), 2)
    V = f.mul(U1, I)
    X3 = f.sub(f.sub(f.sqr(rr), J), f.muls(V, 2))
    Y3 = f.sub(f.mul(rr, f.sub(V, X3)), f.muls(f.mul(S1, J), 2))
    Z3 = f.muls(f.mul(f.mul(Z1, Z2), H), 2)
    return (X3, Y3, Z3)


def _jac_to_affine(f: _Fld, p):
    if _jac_is_inf(f, p):
        return None
    zi = f.inv(p[2])
    zi2 = f.sqr(zi)
    return (f.mul(p[0], zi2), f.mul(p[1], f.mul(zi2, zi)))


def _affine_add(f: _Fld, p, q):
    return _jac_to_affine(
        f, _jac_add(f, _jac_from_affine(f, p), _jac_from_affine(f, q)))


def _affine_mul(f: _Fld, p, k: int):
    k %= R
    acc = (f.one, f.one, f.zero)
    base = _jac_from_affine(f, p)
    while k:
        if k & 1:
            acc = _jac_add(f, acc, base)
        base = _jac_double(f, base)
        k >>= 1
    return _jac_to_affine(f, acc)


def _affine_neg(f: _Fld, p):
    return None if p is None else (p[0], f.neg(p[1]))


def _on_curve(f: _Fld, p) -> bool:
    if p is None:
        return True
    return f.sqr(p[1]) == f.add(f.mul(f.sqr(p[0]), p[0]), f.b)


# Public, per-group API ------------------------------------------------------

def g1_add(p, q):
    return _affine_add(FQ, p, q)


def g1_mul(p, k: int):
    return _affine_mul(FQ, p, k)


def g1_neg(p):
    return _affine_neg(FQ, p)


def g1_on_curve(p) -> bool:
    return _on_curve(FQ, p)


def g1_subgroup_check(p) -> bool:
    return g1_on_curve(p) and g1_mul_full(p, R) is None


def g2_add(p, q):
    return _affine_add(FQ2, p, q)


def g2_mul(p, k: int):
    return _affine_mul(FQ2, p, k)


def g2_neg(p):
    return _affine_neg(FQ2, p)


def g2_on_curve(p) -> bool:
    return _on_curve(FQ2, p)


def g1_mul_full(p, k: int):
    """Scalar mul WITHOUT reduction mod R (for cofactor/order checks)."""
    acc = (FQ.one, FQ.one, FQ.zero)
    base = _jac_from_affine(FQ, p)
    while k:
        if k & 1:
            acc = _jac_add(FQ, acc, base)
        base = _jac_double(FQ, base)
        k >>= 1
    return _jac_to_affine(FQ, acc)


def g2_mul_full(p, k: int):
    acc = (FQ2.one, FQ2.one, FQ2.zero)
    base = _jac_from_affine(FQ2, p)
    while k:
        if k & 1:
            acc = _jac_add(FQ2, acc, base)
        base = _jac_double(FQ2, base)
        k >>= 1
    return _jac_to_affine(FQ2, acc)


def g2_subgroup_check(p) -> bool:
    return g2_on_curve(p) and g2_mul_full(p, R) is None


# ---------------------------------------------------------------------------
# ZCash serialization (48-byte G1 / 96-byte G2 compressed)
# ---------------------------------------------------------------------------
# Flag bits in the most significant byte: 0x80 = compressed, 0x40 = infinity,
# 0x20 = y is the lexicographically larger root.

def _fq_from_bytes(b: bytes) -> int:
    v = int.from_bytes(b, "big")
    if v >= P:
        raise ValueError("field element >= modulus")
    return v


def _y_is_larger_fq(y: int) -> bool:
    return y > P - y


def _y_is_larger_fq2(y) -> bool:
    # Lexicographic with the u-coefficient (c1) most significant.
    ny = F.fq2_neg(y)
    if y[1] != ny[1]:
        return y[1] > ny[1]
    return y[0] > ny[0]


def g1_compress(p: Optional[Tuple[int, int]]) -> bytes:
    if p is None:
        return bytes([0xC0]) + b"\x00" * 47
    out = bytearray(p[0].to_bytes(48, "big"))
    out[0] |= 0x80
    if _y_is_larger_fq(p[1]):
        out[0] |= 0x20
    return bytes(out)


def g1_decompress(b: bytes) -> Optional[Tuple[int, int]]:
    if len(b) != 48:
        raise ValueError("G1 compressed point must be 48 bytes")
    flags = b[0]
    if not flags & 0x80:
        raise ValueError("uncompressed encoding not accepted here")
    if flags & 0x40:
        if flags & 0x20 or any(b[1:]) or (flags & 0x1F):
            raise ValueError("malformed infinity encoding")
        return None
    x = _fq_from_bytes(bytes([flags & 0x1F]) + b[1:])
    y = F.fq_sqrt((x * x % P * x + 4) % P)
    if y is None:
        raise ValueError("x not on curve")
    if bool(flags & 0x20) != _y_is_larger_fq(y):
        y = P - y
    return (x, y)


def g2_compress(p) -> bytes:
    if p is None:
        return bytes([0xC0]) + b"\x00" * 95
    (x0, x1), y = p[0], p[1]
    out = bytearray(x1.to_bytes(48, "big") + x0.to_bytes(48, "big"))
    out[0] |= 0x80
    if _y_is_larger_fq2(y):
        out[0] |= 0x20
    return bytes(out)


def g2_decompress(b: bytes):
    if len(b) != 96:
        raise ValueError("G2 compressed point must be 96 bytes")
    flags = b[0]
    if not flags & 0x80:
        raise ValueError("uncompressed encoding not accepted here")
    if flags & 0x40:
        if flags & 0x20 or any(b[1:]) or (flags & 0x1F):
            raise ValueError("malformed infinity encoding")
        return None
    x1 = _fq_from_bytes(bytes([flags & 0x1F]) + b[1:48])
    x0 = _fq_from_bytes(b[48:])
    x = (x0, x1)
    y = F.fq2_sqrt(F.fq2_add(F.fq2_mul(F.fq2_sqr(x), x), FQ2.b))
    if y is None:
        raise ValueError("x not on curve")
    if bool(flags & 0x20) != _y_is_larger_fq2(y):
        y = F.fq2_neg(y)
    return (x, y)
