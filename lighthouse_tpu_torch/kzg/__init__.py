"""EIP-4844 / Deneb KZG polynomial commitments (port of
``lighthouse_tpu/kzg``).

The data-availability crypto of the Deneb fork (consensus-specs
``polynomial-commitments.md``; the reference consumes it through
``crypto/kzg`` wrapping c-kzg-4844): blobs are polynomials in evaluation
form over the BLS12-381 scalar field Fr, commitments and proofs are G1
points under a powers-of-tau trusted setup, and verification is two
pairings per blob — the pairing family the BLS backend already runs on the
card, so ``verify_blob_kzg_proof_batch`` reduces to lanes of the Miller+fold
and finalize kernels.

Layer map:

- :mod:`.fr`            host Fr arithmetic, roots of unity, Fiat-Shamir.
- :mod:`.fr_limb`       Fr in 16-bit Montgomery limbs as torch ops (the
                        plain version of the evaluation kernel).
- :mod:`.trusted_setup` setup loader + embedded minimal-width setup.
- :mod:`.kzg`           host commit/prove/verify (the semantics oracle).
- :mod:`.device`        the evaluation kernel (``csrc/kzg_fr.cu``) and the
                        card's batch verification.
- :mod:`.inclusion`     BlobSidecar commitment inclusion proofs.
"""

from .fr import (
    BLS_MODULUS,
    BYTES_PER_FIELD_ELEMENT,
    bytes_to_bls_field,
    bls_field_to_bytes,
    compute_roots_of_unity,
    evaluate_polynomial_in_evaluation_form,
)
from .trusted_setup import TrustedSetup, load_trusted_setup
from .kzg import (
    KzgError,
    blob_to_kzg_commitment,
    blob_to_polynomial,
    compute_blob_kzg_proof,
    compute_challenge,
    validate_blob,
    verify_blob_kzg_proof,
    verify_blob_kzg_proof_batch,
)
from .inclusion import (
    blob_sidecar_inclusion_proof,
    verify_blob_sidecar_inclusion_proof,
)

__all__ = [
    "BLS_MODULUS", "BYTES_PER_FIELD_ELEMENT", "bytes_to_bls_field",
    "bls_field_to_bytes", "compute_roots_of_unity",
    "evaluate_polynomial_in_evaluation_form", "TrustedSetup",
    "load_trusted_setup", "KzgError", "blob_to_kzg_commitment",
    "blob_to_polynomial", "compute_blob_kzg_proof", "compute_challenge",
    "validate_blob", "verify_blob_kzg_proof",
    "verify_blob_kzg_proof_batch", "blob_sidecar_inclusion_proof",
    "verify_blob_sidecar_inclusion_proof",
]
