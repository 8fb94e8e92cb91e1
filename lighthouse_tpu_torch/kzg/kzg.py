"""Host KZG commit/prove/verify — the semantics oracle for the card's path
(port of ``lighthouse_tpu/kzg/kzg.py``).

Follows consensus-specs ``polynomial-commitments.md`` (Deneb): blobs are
W·32 bytes of big-endian canonical Fr elements (the polynomial in
evaluation form over the bit-reversal roots-of-unity domain), commitments
and proofs are compressed G1.  Verification is the pairing identity

    e(C - [y]·G1, [1]·G2) == e(Q, [tau - z]·G2)

checked as a 2-pairing product through
:func:`..crypto.pairing.multi_pairing_is_one` (which routes to the
native C++ pairing of :mod:`..crypto.native` once it is built).  The batch
form draws Fiat-Shamir powers r^i and folds every blob into ONE pairing
product; :mod:`.device` runs the same claims as lanes of the card's
Miller+fold and finalize kernels.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

from ..crypto import curve as C
from ..crypto import pairing as HP
from .fr import (
    BLS_MODULUS,
    BYTES_PER_FIELD_ELEMENT,
    bls_field_to_bytes,
    bytes_to_bls_field,
    compute_powers,
    evaluate_polynomial_in_evaluation_form,
    hash_to_bls_field,
)
from .trusted_setup import TrustedSetup

# Fiat-Shamir domain separators (spec constants).
FIAT_SHAMIR_PROTOCOL_DOMAIN = b"FSBLOBVERIFY_V1_"
RANDOM_CHALLENGE_KZG_BATCH_DOMAIN = b"RCKZGBATCH___V1_"

G1_POINT_AT_INFINITY = b"\xc0" + b"\x00" * 47


class KzgError(ValueError):
    pass


# -- blob plumbing -----------------------------------------------------------

def validate_blob(blob: bytes, width: int) -> None:
    """Every 32-byte chunk must be a canonical Fr element (spec
    ``validate_blob`` via bytes_to_bls_field's range check)."""
    if len(blob) != width * BYTES_PER_FIELD_ELEMENT:
        raise KzgError(f"blob must be {width * 32} bytes, got {len(blob)}")
    for i in range(width):
        v = int.from_bytes(blob[32 * i:32 * (i + 1)], "big")
        if v >= BLS_MODULUS:
            raise KzgError(f"blob element {i} is non-canonical")


def blob_to_polynomial(blob: bytes, width: int) -> List[int]:
    validate_blob(blob, width)
    return [int.from_bytes(blob[32 * i:32 * (i + 1)], "big")
            for i in range(width)]


def polynomial_to_blob(evals: Sequence[int]) -> bytes:
    return b"".join(bls_field_to_bytes(int(v)) for v in evals)


def bytes_to_kzg_commitment(data: bytes):
    """48-byte compressed G1 → affine point with SUBGROUP check (spec
    ``bytes_to_kzg_commitment`` / ``validate_kzg_g1``); identity allowed
    (the commitment to the zero polynomial)."""
    if len(data) != 48:
        raise KzgError("commitment/proof must be 48 bytes")
    try:
        p = C.g1_decompress(bytes(data))
    except ValueError as e:
        raise KzgError(f"bad G1 encoding: {e}") from None
    if p is not None and not C.g1_subgroup_check(p):
        raise KzgError("G1 point not in the r-order subgroup")
    return p


bytes_to_kzg_proof = bytes_to_kzg_commitment


# -- commit / prove (Lagrange MSM; width-sized, host) ------------------------

def _g1_lincomb(points, scalars) -> Optional[Tuple[int, int]]:
    acc = None
    for p, s in zip(points, scalars):
        s %= BLS_MODULUS
        if s == 0 or p is None:
            continue
        acc = C.g1_add(acc, C.g1_mul(p, s))
    return acc


def blob_to_kzg_commitment(blob: bytes, setup: TrustedSetup) -> bytes:
    """[p(tau)]·G1 as Σ f_i·[L_i(tau)]G1 (spec ``blob_to_kzg_commitment``).

    On an insecure setup (known tau) the MSM collapses to ONE scalar-mul
    via p(tau) — same point, width-independent cost; bench/tests use this
    to build mainnet-width fixtures without a 4096-point MSM per blob.
    """
    evals = blob_to_polynomial(blob, setup.width)
    if setup.tau is not None:
        p_tau = evaluate_polynomial_in_evaluation_form(
            evals, setup.tau, setup.roots)
        return C.g1_compress(None if p_tau == 0
                             else C.g1_mul(C.G1_GEN, p_tau))
    if not setup.g1_lagrange:
        raise KzgError("setup has no G1 Lagrange points (verify-only)")
    return C.g1_compress(_g1_lincomb(setup.g1_lagrange, evals))


def compute_challenge(blob: bytes, commitment: bytes, width: int) -> int:
    """Fiat-Shamir evaluation point z (spec ``compute_challenge``)."""
    # Length fields use KZG_ENDIANNESS = big (spec constant) — matching
    # c-kzg-4844 transcripts byte-for-byte.
    data = (FIAT_SHAMIR_PROTOCOL_DOMAIN
            + width.to_bytes(16, "big")
            + blob + bytes(commitment))
    return hash_to_bls_field(data)


def compute_blob_kzg_proof(blob: bytes, commitment: bytes,
                           setup: TrustedSetup) -> bytes:
    """Proof for the blob's own Fiat-Shamir challenge (spec
    ``compute_blob_kzg_proof``): Q = [q(tau)]·G1 with
    q(X) = (p(X) - y)/(X - z) built in evaluation form.

    Insecure-setup fast path: q(tau) = (p(tau) - y)/(tau - z) directly.
    """
    width = setup.width
    evals = blob_to_polynomial(blob, width)
    z = compute_challenge(blob, commitment, width)
    roots = setup.roots
    y = evaluate_polynomial_in_evaluation_form(evals, z, roots)
    if setup.tau is not None:
        q_tau = (evaluate_polynomial_in_evaluation_form(
            evals, setup.tau, roots) - y) \
            * pow(setup.tau - z, BLS_MODULUS - 2, BLS_MODULUS) % BLS_MODULUS
        return C.g1_compress(None if q_tau == 0
                             else C.g1_mul(C.G1_GEN, q_tau))
    if not setup.g1_lagrange:
        raise KzgError("setup has no G1 Lagrange points (verify-only)")
    if z in roots:
        raise KzgError("challenge landed in the domain")  # ~2^-250
    # q_i = (f_i - y)/(ω_i - z) plus no correction terms since z ∉ domain.
    q = [(f - y) * pow(w - z, BLS_MODULUS - 2, BLS_MODULUS) % BLS_MODULUS
         for f, w in zip(evals, roots)]
    return C.g1_compress(_g1_lincomb(setup.g1_lagrange, q))


# -- verify ------------------------------------------------------------------

def _proof_pairs(commitment_pt, z: int, y: int, proof_pt, setup, r: int = 1):
    """The two pairing pairs for one (C, z, y, Q) claim, with the G2 sides
    FIXED (G2 and X2) so batch lanes share them:

        e(r·(C - y·G1 + z·Q), -G2) · e(r·Q, X2) == 1

    — the z term moved from G2 to G1 by bilinearity; ``r`` is the batch
    RLC power (1 for a single verify)."""
    x2 = setup.g2_monomial[1]
    a = commitment_pt
    if y % BLS_MODULUS:
        a = C.g1_add(a, C.g1_neg(C.g1_mul(C.G1_GEN, y)))
    if proof_pt is not None and z % BLS_MODULUS:
        a = C.g1_add(a, C.g1_mul(proof_pt, z))
    if r != 1:
        a = None if a is None else C.g1_mul(a, r)
    b = None if proof_pt is None else C.g1_mul(proof_pt, r % BLS_MODULUS)
    return [(a, C.g2_neg(C.G2_GEN)), (b, x2)]


def verify_kzg_proof_impl(commitment_pt, z: int, y: int, proof_pt,
                          setup: TrustedSetup) -> bool:
    return HP.multi_pairing_is_one(
        _proof_pairs(commitment_pt, z, y, proof_pt, setup))


def verify_blob_kzg_proof(blob: bytes, commitment: bytes, proof: bytes,
                          setup: TrustedSetup) -> bool:
    """Spec ``verify_blob_kzg_proof``.  Malformed inputs raise
    :class:`KzgError`; a well-formed-but-wrong proof returns False."""
    width = setup.width
    evals = blob_to_polynomial(blob, width)
    cpt = bytes_to_kzg_commitment(commitment)
    qpt = bytes_to_kzg_proof(proof)
    z = compute_challenge(blob, commitment, width)
    y = evaluate_polynomial_in_evaluation_form(evals, z, setup.roots)
    return verify_kzg_proof_impl(cpt, z, y, qpt, setup)


def _batch_challenges(blobs, commitments, setup):
    """Per-blob (z_i, y_i) plus the RLC powers r^i (spec
    ``verify_blob_kzg_proof_batch`` Fiat-Shamir)."""
    width = setup.width
    zs, ys = [], []
    for blob, commitment in zip(blobs, commitments):
        evals = blob_to_polynomial(blob, width)
        z = compute_challenge(blob, commitment, width)
        zs.append(z)
        ys.append(evaluate_polynomial_in_evaluation_form(
            evals, z, setup.roots))
    return zs, ys


def _rlc_powers(commitments, zs, ys, proofs, width: int) -> List[int]:
    data = (RANDOM_CHALLENGE_KZG_BATCH_DOMAIN
            + width.to_bytes(8, "big")
            + len(commitments).to_bytes(8, "big"))
    for c, z, y, q in zip(commitments, zs, ys, proofs):
        data += bytes(c) + bls_field_to_bytes(z) + bls_field_to_bytes(y) \
            + bytes(q)
    return compute_powers(hash_to_bls_field(data), len(commitments))


def verify_blob_kzg_proof_batch_host(blobs, commitments, proofs,
                                     setup: TrustedSetup) -> bool:
    """Host batch verify: RLC-fold every claim into ONE 2-pairing check
    (the spec's ``verify_kzg_proof_batch`` shape — G1 MSM on the host,
    two pairings total), via the native pairing when built."""
    if not (len(blobs) == len(commitments) == len(proofs)):
        raise KzgError("batch length mismatch")
    if not blobs:
        return True
    cpts = [bytes_to_kzg_commitment(c) for c in commitments]
    qpts = [bytes_to_kzg_proof(q) for q in proofs]
    zs, ys = _batch_challenges(blobs, commitments, setup)
    rs = _rlc_powers(commitments, zs, ys, proofs, setup.width)
    pairs = []
    for cpt, z, y, qpt, r in zip(cpts, zs, ys, qpts, rs):
        pairs.extend(_proof_pairs(cpt, z, y, qpt, setup, r=r))
    # Fold the shared-G2 lanes: Σ lanes with -G2, Σ lanes with X2.
    a = b = None
    for (pa, _), (pb, _) in zip(pairs[0::2], pairs[1::2]):
        a = C.g1_add(a, pa)
        b = C.g1_add(b, pb)
    return HP.multi_pairing_is_one(
        [(a, C.g2_neg(C.G2_GEN)), (b, setup.g2_monomial[1])])


def verify_blob_kzg_proof_batch(blobs, commitments, proofs,
                                setup: TrustedSetup) -> bool:
    """The framework entry point.  With the port's device on a GPU
    (:func:`..device.on_cuda`) the batch takes the card's route
    (:func:`.device.verify_blob_kzg_proof_batch_device`: the barycentric
    kernel, then two Miller+fold lanes a blob and finalize), and a kernel
    that fails raises; on the CPU device it takes the host RLC fold.  The
    route has no option: tests hold the card's route on the CPU by calling
    :func:`.device.verify_blob_kzg_proof_batch_device` there, which runs
    the kernels' plain versions."""
    from .. import device as DEV
    if DEV.on_cuda():
        from . import device as D
        return D.verify_blob_kzg_proof_batch_device(
            blobs, commitments, proofs, setup)
    return verify_blob_kzg_proof_batch_host(blobs, commitments, proofs,
                                            setup)
