"""Optimal ate pairing on BLS12-381 (host ground truth).

e: G1 x G2 -> GT = mu_r in Fq12.  Miller loop over |x| (the BLS parameter,
``fields.BLS_X``) with a conjugation at the end (x < 0), then the standard
BLS12 final exponentiation: easy part (q^6-1)(q^2+1), hard part via the
Karabina/Scott x-power ladder.

The device kernel batches the Miller loops and shares one final
exponentiation across a product of pairings — the same product-of-pairings
trick blst's ``verify_multiple_aggregate_signatures`` uses
(Lighthouse ``crypto/bls/src/impls/blst.rs:110-119``); this module is
the semantics oracle for it.
"""

from __future__ import annotations

from typing import Iterable, Optional, Tuple

from . import fields as F
from .fields import P, BLS_X

_X_ABS = -BLS_X  # positive 0xd201000000010000
_X_BITS = bin(_X_ABS)[3:]  # MSB-first, top bit dropped (implicit leading 1)


# Line evaluations.  G2 points in affine (x, y) over Fq2; the G1 point (px,
# py) over Fq embeds via the twist: we evaluate the line at the G1 point and
# sparse-multiply into the Fq12 accumulator.
#
# With the M-twist layout (Fq12 = Fq6[w], v^3 = xi, w^2 = v) a line
# l(P) = y_p * c0 + (c1 * x_p) * w^2-part + c3 * w^3-part ... rather than
# tracking sparse positions symbolically, we lift G2 points to Fq12 via the
# untwist map and use plain (slow, obviously-correct) Fq12 arithmetic:
#
#   untwist(x, y) = (x / w^2, y / w^3)   with x, y in Fq2 ⊂ Fq12.
#
# Then the chord/tangent line through untwisted points evaluated at the
# (embedded) G1 point is an Fq12 element.  This is the py_ecc-style formulation:
# slow but a faithful oracle for the optimized device kernel.

def _fq12_from_fq2(a) -> tuple:
    """Embed c0 + c1*u in Fq2 into Fq12 (constant coefficient)."""
    return ((a, F.FQ2_ZERO, F.FQ2_ZERO), F.FQ6_ZERO)


def _fq12_from_int(a: int) -> tuple:
    return _fq12_from_fq2((a % P, 0))


# w^2 = v in Fq6 embedded in Fq12; w^-2 = v^-1 = v^2/xi.
_W2 = ((F.FQ2_ZERO, F.FQ2_ONE, F.FQ2_ZERO), F.FQ6_ZERO)          # v
_W3 = (F.FQ6_ZERO, (F.FQ2_ZERO, F.FQ2_ONE, F.FQ2_ZERO))          # v*w
_W2_INV = F.fq12_inv(_W2)
_W3_INV = F.fq12_inv(_W3)


def _untwist(q) -> Tuple[tuple, tuple]:
    """G2 affine (Fq2 pair) -> point on E(Fq12)."""
    x = F.fq12_mul(_fq12_from_fq2(q[0]), _W2_INV)
    y = F.fq12_mul(_fq12_from_fq2(q[1]), _W3_INV)
    return (x, y)


def _line(a, b, pt) -> tuple:
    """Evaluate the line through Fq12 points a, b at pt (all on E(Fq12))."""
    ax, ay = a
    bx, by = b
    px, py = pt
    if ax != bx:
        # chord
        m = F.fq12_mul(F.fq12_sub(by, ay), F.fq12_inv(F.fq12_sub(bx, ax)))
        return F.fq12_sub(F.fq12_sub(py, ay), F.fq12_mul(m, F.fq12_sub(px, ax)))
    if ay == by:
        # tangent
        m = F.fq12_mul(F.fq12_mul(_fq12_from_int(3), F.fq12_mul(ax, ax)),
                       F.fq12_inv(F.fq12_mul(_fq12_from_int(2), ay)))
        return F.fq12_sub(F.fq12_sub(py, ay), F.fq12_mul(m, F.fq12_sub(px, ax)))
    # vertical
    return F.fq12_sub(px, ax)


def _ell_add(a, b):
    """Affine addition on E(Fq12) (no exceptional doubling input)."""
    ax, ay = a
    bx, by = b
    if ax == bx and ay == by:
        m = F.fq12_mul(F.fq12_mul(_fq12_from_int(3), F.fq12_mul(ax, ax)),
                       F.fq12_inv(F.fq12_mul(_fq12_from_int(2), ay)))
    else:
        m = F.fq12_mul(F.fq12_sub(by, ay), F.fq12_inv(F.fq12_sub(bx, ax)))
    x3 = F.fq12_sub(F.fq12_sub(F.fq12_mul(m, m), ax), bx)
    y3 = F.fq12_sub(F.fq12_mul(m, F.fq12_sub(ax, x3)), ay)
    return (x3, y3)


def miller_loop(p, q) -> tuple:
    """f_{|x|,Q}(P) with the x<0 conjugation folded in.  p in G1, q in G2
    (affine, not infinity)."""
    pt = (_fq12_from_int(p[0]), _fq12_from_int(p[1]))
    Q = _untwist(q)
    T = Q
    f = F.FQ12_ONE
    for bit in _X_BITS:
        f = F.fq12_mul(F.fq12_sqr(f), _line(T, T, pt))
        T = _ell_add(T, T)
        if bit == "1":
            f = F.fq12_mul(f, _line(T, Q, pt))
            T = _ell_add(T, Q)
    # x < 0: f_{-|x|} = 1/f_{|x|} (up to final exp) = conjugate in the
    # cyclotomic subgroup — applied after the easy part; conjugating here on
    # the raw Miller value is equivalent post-final-exp.
    return F.fq12_conj(f)


def final_exponentiation(f: tuple) -> tuple:
    """f^((q^12-1)/r), easy part + BLS12 hard part (exact exponent)."""
    # Easy part: f^(q^6 - 1) then ^(q^2 + 1).
    f = F.fq12_mul(F.fq12_conj(f), F.fq12_inv(f))
    f = F.fq12_mul(F.fq12_frobenius(f, 2), f)
    # Hard part (exact integer exponent — slow, unambiguous oracle):
    # (q^4 - q^2 + 1)/r expanded in q with no polynomial tricks.
    e = (pow(P, 4) - pow(P, 2) + 1) // F.R
    return F.fq12_pow(f, e)


def _pow_u(g: tuple) -> tuple:
    """g^u for the (negative) BLS parameter u — cyclotomic g only."""
    return F.fq12_conj(F.fq12_pow(g, _X_ABS))


def final_exponentiation_cubed(f: tuple) -> tuple:
    """f^(3·(q¹²−1)/r) via the Hayashida–Hayasaka–Teruya x-ladder:

        3·(p⁴−p²+1)/r = (u−1)²·(u+p)·(u²+p²−1) + 3

    (identity asserted in tests).  ~400 Fq12 host multiplies instead of a
    2700-bit exponentiation — the fast shared tail for the device pairing
    kernels, whose ``== 1`` semantics are unchanged by the cube (GT has
    prime order r ≠ 3).  Matches the device
    :func:`..limb_pairing.final_exponentiation_cubed` exactly.
    """
    f1 = F.fq12_mul(F.fq12_conj(f), F.fq12_inv(f))
    m = F.fq12_mul(F.fq12_frobenius(f1, 2), f1)
    m1 = F.fq12_mul(_pow_u(m), F.fq12_conj(m))
    k2 = F.fq12_mul(_pow_u(m1), F.fq12_conj(m1))
    k3 = F.fq12_mul(_pow_u(k2), F.fq12_frobenius(k2, 1))
    k4 = F.fq12_mul(F.fq12_mul(_pow_u(_pow_u(k3)), F.fq12_frobenius(k3, 2)),
                    F.fq12_conj(k3))
    return F.fq12_mul(k4, F.fq12_mul(F.fq12_sqr(m), m))


def pairing(p, q) -> tuple:
    """Full pairing e(p, q); identities map to 1."""
    if p is None or q is None:
        return F.FQ12_ONE
    return final_exponentiation(miller_loop(p, q))


def multi_pairing(pairs: Iterable[Tuple[Optional[tuple], Optional[tuple]]]) -> tuple:
    """prod_i e(p_i, q_i) with ONE shared final exponentiation."""
    acc = F.FQ12_ONE
    for p, q in pairs:
        if p is None or q is None:
            continue
        acc = F.fq12_mul(acc, miller_loop(p, q))
    return final_exponentiation(acc)


def multi_pairing_is_one(
        pairs: Iterable[Tuple[Optional[tuple], Optional[tuple]]]) -> bool:
    """prod_i e(p_i, q_i) == 1 — the verification predicate.  Identity
    pairs are dropped (e(P, O) = 1); the rest go through the native C++
    pairing once it is built, else the pure-Python one
    (``LIGHTHOUSE_TPU_NO_NATIVE=1`` forces Python)."""
    from . import native

    live = [(p, q) for p, q in pairs if p is not None and q is not None]
    if native.ready():
        if not live:
            return True
        return native.multi_pairing_is_one(live)
    return multi_pairing(live) == F.FQ12_ONE
