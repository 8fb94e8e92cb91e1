"""Block/attestation rejection reasons — the typed error surface of the
verification pipelines (``BlockError`` in
``beacon_node/beacon_chain/src/block_verification.rs:95``
and ``Error`` in ``attestation_verification.rs``)."""

from __future__ import annotations


class BlockError(ValueError):
    """Base class; subclasses say which pipeline stage rejected."""


class BlockIsAlreadyKnown(BlockError):
    pass


class FutureSlot(BlockError):
    pass


class ParentUnknown(BlockError):
    pass


class IncorrectProposer(BlockError):
    pass


class ProposalSignatureInvalid(BlockError):
    pass


class InvalidSignatures(BlockError):
    pass


class StateRootMismatch(BlockError):
    pass


class InvalidBlock(BlockError):
    """The state transition rejected the block (non-signature reason)."""


class RepeatProposal(BlockError):
    pass


class PayloadInvalid(BlockError):
    pass


class BlobsUnavailable(BlockError):
    """Deneb availability gate: the block's KZG commitments have no
    matching verified blob sidecars yet (retryable — blobs may still
    arrive over gossip or by-root requests)."""


class BlobSidecarError(ValueError):
    """A blob sidecar failed verification (bad index, inclusion proof,
    or KZG proof)."""


class AttestationError(ValueError):
    pass


class PriorAttestationKnown(AttestationError):
    pass


class AttestationSlotOutOfWindow(AttestationError):
    pass


class AttestationSignatureInvalid(AttestationError):
    pass


class UnknownHeadBlock(AttestationError):
    pass
