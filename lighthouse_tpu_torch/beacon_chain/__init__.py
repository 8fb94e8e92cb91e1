"""Chain runtime of the port: the ``BeaconChain`` orchestrator and its
staged verification pipelines (counterpart of ``beacon_node/beacon_chain``;
port of ``lighthouse_tpu/beacon_chain``).  The streaming verification
service and light-client updates are not ported yet."""

from .chain import BeaconChain, CanonicalHead
from .block_verification import (
    ExecutedBlock,
    GossipVerifiedBlock,
    SignatureVerifiedBlock,
)
from .attestation_verification import (
    VerifiedAttestation,
    batch_verify_attestations,
)
from .data_availability import DataAvailabilityChecker, build_blob_sidecars
from .errors import (
    AttestationError,
    BlobSidecarError,
    BlobsUnavailable,
    BlockError,
    BlockIsAlreadyKnown,
    FutureSlot,
    IncorrectProposer,
    InvalidBlock,
    InvalidSignatures,
    ParentUnknown,
    ProposalSignatureInvalid,
    RepeatProposal,
    StateRootMismatch,
)
from .observed import (
    ObservedAggregators,
    ObservedAttesters,
    ObservedBlockProducers,
)

__all__ = [
    "BeaconChain", "CanonicalHead", "GossipVerifiedBlock",
    "SignatureVerifiedBlock", "ExecutedBlock", "VerifiedAttestation",
    "batch_verify_attestations", "BlockError", "AttestationError",
    "BlockIsAlreadyKnown", "FutureSlot", "ParentUnknown",
    "IncorrectProposer", "InvalidBlock", "ProposalSignatureInvalid",
    "InvalidSignatures", "StateRootMismatch", "RepeatProposal",
    "BlobsUnavailable", "BlobSidecarError", "DataAvailabilityChecker",
    "build_blob_sidecars", "ObservedAttesters", "ObservedAggregators",
    "ObservedBlockProducers",
]
