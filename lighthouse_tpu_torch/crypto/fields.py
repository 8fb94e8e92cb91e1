"""BLS12-381 field towers in pure Python integers (host ground truth).

Tower (the standard one blst/milagro use, cf. the backends wrapped by
Lighthouse ``crypto/bls/src/lib.rs:8-21``):

    Fq2  = Fq [u] / (u^2 + 1)
    Fq6  = Fq2[v] / (v^3 - xi),  xi = u + 1
    Fq12 = Fq6[w] / (w^2 - v)

Elements are immutable tuples of ints; all Frobenius constants are computed
at import from the tower structure (no memorised magic constants beyond the
curve parameters themselves).
"""

from __future__ import annotations

# Base field modulus and curve parameters (public BLS12-381 constants).
P = 0x1A0111EA397FE69A4B1BA7B6434BACD764774B84F38512BF6730D2A0F6B0F6241EABFFFEB153FFFFB9FEFFFFFFFFAAAB
# Subgroup order r (also the scalar field).
R = 0x73EDA753299D7D483339D80809A1D80553BDA402FFFE5BFEFFFFFFFF00000001
# BLS parameter: the curve family's generator polynomial variable, x < 0.
BLS_X = -0xD201000000010000


# ---------------------------------------------------------------------------
# Fq — integers mod P
# ---------------------------------------------------------------------------

def fq_inv(a: int) -> int:
    return pow(a, P - 2, P)


def fq_sqrt(a: int) -> int | None:
    """Square root in Fq (P ≡ 3 mod 4), or None if not a QR."""
    a %= P
    r = pow(a, (P + 1) // 4, P)
    return r if r * r % P == a else None


def fq_sgn0(a: int) -> int:
    """RFC 9380 sgn0 for Fq: parity of the canonical representative."""
    return a % 2


# ---------------------------------------------------------------------------
# Fq2 — (c0, c1) = c0 + c1*u, u^2 = -1
# ---------------------------------------------------------------------------

Fq2 = tuple  # (int, int)

FQ2_ZERO = (0, 0)
FQ2_ONE = (1, 0)


def fq2_add(a, b):
    return ((a[0] + b[0]) % P, (a[1] + b[1]) % P)


def fq2_sub(a, b):
    return ((a[0] - b[0]) % P, (a[1] - b[1]) % P)


def fq2_neg(a):
    return (-a[0] % P, -a[1] % P)


def fq2_mul(a, b):
    # Karatsuba: (a0+a1u)(b0+b1u) = a0b0 - a1b1 + ((a0+a1)(b0+b1) - a0b0 - a1b1)u
    t0 = a[0] * b[0]
    t1 = a[1] * b[1]
    t2 = (a[0] + a[1]) * (b[0] + b[1])
    return ((t0 - t1) % P, (t2 - t0 - t1) % P)


def fq2_sqr(a):
    # (a0+a1u)^2 = (a0+a1)(a0-a1) + 2a0a1 u
    t0 = (a[0] + a[1]) * (a[0] - a[1])
    t1 = 2 * a[0] * a[1]
    return (t0 % P, t1 % P)


def fq2_muls(a, s: int):
    return (a[0] * s % P, a[1] * s % P)


def fq2_conj(a):
    return (a[0], -a[1] % P)


def fq2_inv(a):
    # 1/(a0+a1u) = conj(a)/(a0^2+a1^2)
    d = fq_inv((a[0] * a[0] + a[1] * a[1]) % P)
    return (a[0] * d % P, -a[1] * d % P)


def fq2_pow(a, e: int):
    out, base = FQ2_ONE, a
    while e:
        if e & 1:
            out = fq2_mul(out, base)
        base = fq2_sqr(base)
        e >>= 1
    return out


def fq2_sqrt(a):
    """Square root in Fq2 via the complex method (u^2 = -1), or None.

    For a = a0 + a1*u:  with n = a0^2 + a1^2 (the norm), a root exists iff
    sqrt(n) exists in Fq and one of (a0 ± sqrt(n))/2 is a QR.
    """
    a0, a1 = a[0] % P, a[1] % P
    if a1 == 0:
        r = fq_sqrt(a0)
        if r is not None:
            return (r, 0)
        # a0 is a non-residue: sqrt(a0) = sqrt(-a0)*u since u^2 = -1.
        r = fq_sqrt(-a0 % P)
        return None if r is None else (0, r)
    n = fq_sqrt((a0 * a0 + a1 * a1) % P)
    if n is None:
        return None
    inv2 = (P + 1) // 2
    for cand in ((a0 + n) * inv2 % P, (a0 - n) * inv2 % P):
        x0 = fq_sqrt(cand)
        if x0 is not None and x0 != 0:
            x1 = a1 * inv2 % P * fq_inv(x0) % P
            root = (x0, x1)
            if fq2_sqr(root) == (a0, a1):
                return root
    return None


def fq2_sgn0(a) -> int:
    """RFC 9380 sgn0 for Fq2 (little-endian over coefficients)."""
    s0 = a[0] % 2
    z0 = a[0] == 0
    s1 = a[1] % 2
    return s0 | (z0 & s1)


def fq2_is_zero(a) -> bool:
    return a[0] % P == 0 and a[1] % P == 0


# Fq6 non-residue xi = u + 1 (v^3 = xi).
XI = (1, 1)


# ---------------------------------------------------------------------------
# Fq6 — (c0, c1, c2) over Fq2, v^3 = XI
# ---------------------------------------------------------------------------

FQ6_ZERO = (FQ2_ZERO, FQ2_ZERO, FQ2_ZERO)
FQ6_ONE = (FQ2_ONE, FQ2_ZERO, FQ2_ZERO)


def _mul_by_xi(a):
    # (a0 + a1 u)(1 + u) = (a0 - a1) + (a0 + a1) u
    return ((a[0] - a[1]) % P, (a[0] + a[1]) % P)


def fq6_add(a, b):
    return tuple(fq2_add(x, y) for x, y in zip(a, b))


def fq6_sub(a, b):
    return tuple(fq2_sub(x, y) for x, y in zip(a, b))


def fq6_neg(a):
    return tuple(fq2_neg(x) for x in a)


def fq6_mul(a, b):
    a0, a1, a2 = a
    b0, b1, b2 = b
    t0, t1, t2 = fq2_mul(a0, b0), fq2_mul(a1, b1), fq2_mul(a2, b2)
    c0 = fq2_add(t0, _mul_by_xi(fq2_sub(fq2_mul(fq2_add(a1, a2), fq2_add(b1, b2)),
                                        fq2_add(t1, t2))))
    c1 = fq2_add(fq2_sub(fq2_mul(fq2_add(a0, a1), fq2_add(b0, b1)), fq2_add(t0, t1)),
                 _mul_by_xi(t2))
    c2 = fq2_add(fq2_sub(fq2_mul(fq2_add(a0, a2), fq2_add(b0, b2)), fq2_add(t0, t2)), t1)
    return (c0, c1, c2)


def fq6_sqr(a):
    return fq6_mul(a, a)


def fq6_mul_by_v(a):
    # v * (a0 + a1 v + a2 v^2) = xi*a2 + a0 v + a1 v^2
    return (_mul_by_xi(a[2]), a[0], a[1])


def fq6_inv(a):
    a0, a1, a2 = a
    c0 = fq2_sub(fq2_sqr(a0), _mul_by_xi(fq2_mul(a1, a2)))
    c1 = fq2_sub(_mul_by_xi(fq2_sqr(a2)), fq2_mul(a0, a1))
    c2 = fq2_sub(fq2_sqr(a1), fq2_mul(a0, a2))
    t = fq2_inv(fq2_add(fq2_mul(a0, c0),
                        _mul_by_xi(fq2_add(fq2_mul(a2, c1), fq2_mul(a1, c2)))))
    return (fq2_mul(c0, t), fq2_mul(c1, t), fq2_mul(c2, t))


# ---------------------------------------------------------------------------
# Fq12 — (c0, c1) over Fq6, w^2 = v
# ---------------------------------------------------------------------------

FQ12_ONE = (FQ6_ONE, FQ6_ZERO)


def fq12_add(a, b):
    return (fq6_add(a[0], b[0]), fq6_add(a[1], b[1]))


def fq12_sub(a, b):
    return (fq6_sub(a[0], b[0]), fq6_sub(a[1], b[1]))


def fq12_mul(a, b):
    a0, a1 = a
    b0, b1 = b
    t0 = fq6_mul(a0, b0)
    t1 = fq6_mul(a1, b1)
    c0 = fq6_add(t0, fq6_mul_by_v(t1))
    c1 = fq6_sub(fq6_mul(fq6_add(a0, a1), fq6_add(b0, b1)), fq6_add(t0, t1))
    return (c0, c1)


def fq12_sqr(a):
    return fq12_mul(a, a)


def fq12_inv(a):
    a0, a1 = a
    t = fq6_inv(fq6_sub(fq6_sqr(a0), fq6_mul_by_v(fq6_sqr(a1))))
    return (fq6_mul(a0, t), fq6_neg(fq6_mul(a1, t)))


def fq12_conj(a):
    """Conjugate over Fq6 (the w -> -w involution, = Frobenius^6)."""
    return (a[0], fq6_neg(a[1]))


def fq12_pow(a, e: int):
    if e < 0:
        return fq12_pow(fq12_conj(a), -e)  # valid for cyclotomic elements
    out, base = FQ12_ONE, a
    while e:
        if e & 1:
            out = fq12_mul(out, base)
        base = fq12_sqr(base)
        e >>= 1
    return out


# Frobenius constants, computed from the tower structure:
#   frob^n on Fq6 coefficients:  a_i -> conj^n(a_i) * XI^(i*(P^n-1)/3)
#   frob^n on the Fq12 w-part:   b1  -> b1' * XI^((P^n-1)/6)
_FROB_XI_3 = [fq2_pow(XI, (pow(P, n) - 1) // 3) for n in range(4)]
_FROB_XI_3_SQ = [fq2_sqr(c) for c in _FROB_XI_3]
_FROB_XI_6 = [fq2_pow(XI, (pow(P, n) - 1) // 6) for n in range(4)]


def _fq2_frob(a, n):
    return a if n % 2 == 0 else fq2_conj(a)


def _fq6_frob(a, n):
    return (_fq2_frob(a[0], n),
            fq2_mul(_fq2_frob(a[1], n), _FROB_XI_3[n]),
            fq2_mul(_fq2_frob(a[2], n), _FROB_XI_3_SQ[n]))


def fq12_frobenius(a, n: int = 1):
    """a^(P^n) for n in 1..3 (enough for the final exponentiation)."""
    assert 1 <= n <= 3
    c0 = _fq6_frob(a[0], n)
    c1 = _fq6_frob(a[1], n)
    gamma = _FROB_XI_6[n]
    c1 = tuple(fq2_mul(x, gamma) for x in c1)
    return (c0, c1)
