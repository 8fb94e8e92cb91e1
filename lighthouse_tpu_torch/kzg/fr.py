"""Host arithmetic over Fr, the BLS12-381 scalar field — the KZG
"polynomial side" of consensus-specs ``polynomial-commitments.md``.

Port of ``lighthouse_tpu/kzg/fr.py``.  Fr is also the subgroup order r
the pairing code already carries (:data:`..crypto.fields.R`), so the
modulus is imported, not re-stated.  Everything here is exact python
ints: the host oracle for the card's barycentric kernel
(:func:`.device.eval_blobs`) and the reference semantics for challenges,
roots of unity and field (de)serialization.
"""

from __future__ import annotations

import hashlib
from typing import List, Sequence

from ..crypto.fields import R as BLS_MODULUS

BYTES_PER_FIELD_ELEMENT = 32

# Generator of Fr's multiplicative group (consensus-specs
# PRIMITIVE_ROOT_OF_UNITY); 7 generates because r - 1 = 2^32 · odd and
# 7^((r-1)/2) == -1.
PRIMITIVE_ROOT_OF_UNITY = 7


class FrError(ValueError):
    pass


def bytes_to_bls_field(b: bytes) -> int:
    """Big-endian 32 bytes → canonical Fr element; non-canonical (≥ r)
    encodings are rejected (spec ``bytes_to_bls_field``)."""
    if len(b) != BYTES_PER_FIELD_ELEMENT:
        raise FrError("field element must be 32 bytes")
    v = int.from_bytes(b, "big")
    if v >= BLS_MODULUS:
        raise FrError("non-canonical field element")
    return v


def bls_field_to_bytes(x: int) -> bytes:
    return (x % BLS_MODULUS).to_bytes(BYTES_PER_FIELD_ELEMENT, "big")


def hash_to_bls_field(data: bytes) -> int:
    """SHA-256 → Fr by modular reduction (spec ``hash_to_bls_field``; the
    ~2^-126 bias is part of the spec's Fiat-Shamir definition)."""
    return int.from_bytes(hashlib.sha256(data).digest(), "big") % BLS_MODULUS


def compute_powers(x: int, n: int) -> List[int]:
    """[1, x, x², …, x^(n-1)] mod r (spec ``compute_powers``)."""
    out, acc = [], 1
    for _ in range(n):
        out.append(acc)
        acc = acc * x % BLS_MODULUS
    return out


def _bit_reversal_permutation(seq: Sequence[int]) -> List[int]:
    """Reorder a power-of-two sequence by bit-reversed index (spec
    ``bit_reversal_permutation``) — the order blob evaluations live in."""
    n = len(seq)
    if n & (n - 1):
        raise FrError("length must be a power of two")
    bits = n.bit_length() - 1
    return [seq[int(format(i, f"0{bits}b")[::-1], 2) if bits else 0]
            for i in range(n)]


def compute_roots_of_unity(width: int) -> List[int]:
    """The ``width`` roots of x^width = 1, in BIT-REVERSAL order — blob
    element i is the polynomial's evaluation at ``roots[i]``."""
    if width & (width - 1) or width == 0:
        raise FrError("width must be a power of two")
    if (BLS_MODULUS - 1) % width:
        raise FrError("width does not divide r - 1")
    omega = pow(PRIMITIVE_ROOT_OF_UNITY, (BLS_MODULUS - 1) // width,
                BLS_MODULUS)
    roots, acc = [], 1
    for _ in range(width):
        roots.append(acc)
        acc = acc * omega % BLS_MODULUS
    return _bit_reversal_permutation(roots)


def evaluate_polynomial_in_evaluation_form(evals: Sequence[int], z: int,
                                           roots: Sequence[int]) -> int:
    """Barycentric evaluation p(z) from evaluations over the roots-of-unity
    domain (spec ``evaluate_polynomial_in_evaluation_form``):

        p(z) = (z^W - 1)/W · Σ_i  f_i · ω_i / (z - ω_i)

    with the in-domain special case p(ω_i) = f_i.  This is the exact host
    oracle the device kernel (:func:`.device.eval_blobs`) is checked
    against.
    """
    width = len(evals)
    if width != len(roots):
        raise FrError("evaluations/domain length mismatch")
    z %= BLS_MODULUS
    for f, w in zip(evals, roots):
        if z == w:
            return f % BLS_MODULUS
    inv_width = pow(width, BLS_MODULUS - 2, BLS_MODULUS)
    acc = 0
    for f, w in zip(evals, roots):
        acc += f * w % BLS_MODULUS * pow(z - w, BLS_MODULUS - 2, BLS_MODULUS)
    factor = (pow(z, width, BLS_MODULUS) - 1) * inv_width
    return acc * factor % BLS_MODULUS
