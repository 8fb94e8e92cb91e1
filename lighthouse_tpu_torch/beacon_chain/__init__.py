"""Chain runtime of the port: the staged block-verification pipeline and
its typed errors (counterpart of ``beacon_node/beacon_chain``).  The
``BeaconChain`` orchestrator (fork choice, store, op pool, data
availability) is not ported yet: the stages take any object with the
attributes they read as their ``chain``."""

from .block_verification import (
    ExecutedBlock,
    GossipVerifiedBlock,
    SignatureVerifiedBlock,
)
from .errors import (
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
from .observed import ObservedBlockProducers

__all__ = [
    "ExecutedBlock", "GossipVerifiedBlock", "SignatureVerifiedBlock",
    "BlockError", "BlockIsAlreadyKnown", "FutureSlot", "IncorrectProposer",
    "InvalidBlock", "InvalidSignatures", "ParentUnknown",
    "ProposalSignatureInvalid", "RepeatProposal", "StateRootMismatch",
    "ObservedBlockProducers",
]
