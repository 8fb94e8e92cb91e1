"""Pure state-transition layer.

Port of ``lighthouse_tpu/state_transition`` (counterpart of
``consensus/state_processing``): spec ``per_slot`` / ``per_epoch`` /
``per_block`` functions over the SoA state, with signature sets
accumulated for one batched device verify per block, and the serial and
epoch-batched block replayers (``block_replayer``, ``batch_replay``) the
store rebuilds states with.  The phase0 epoch transition is not ported
yet.
"""

from .helpers import (
    compute_domain,
    compute_epoch_at_slot,
    compute_signing_root,
    compute_start_slot_at_epoch,
    current_epoch,
    get_active_validator_indices,
)
from .per_block import (
    BlockProcessingError,
    SignatureStrategy,
    process_block,
)
from .batch_replay import (
    EpochReplayer,
    WindowBlockInvalid,
    WindowError,
    WindowRootMismatch,
    WindowSignaturesInvalid,
    batch_replay_enabled,
    known_roots_fn,
    replay_states,
)
from .per_epoch import process_epoch
from .per_slot import (
    SlotProcessingError,
    process_slot,
    process_slots,
    state_transition,
)
from .committees import (
    get_attesting_indices,
    get_beacon_committee,
    get_beacon_proposer_index,
)
from .genesis import interop_genesis_state, interop_keypairs, interop_secret_key

__all__ = [
    "BlockProcessingError", "SignatureStrategy", "SlotProcessingError",
    "process_block", "process_epoch", "process_slot", "process_slots",
    "state_transition", "get_attesting_indices", "get_beacon_committee",
    "get_beacon_proposer_index", "interop_genesis_state", "interop_keypairs",
    "interop_secret_key", "compute_domain", "compute_epoch_at_slot",
    "compute_signing_root", "compute_start_slot_at_epoch", "current_epoch",
    "get_active_validator_indices",
    "EpochReplayer", "WindowBlockInvalid", "WindowError",
    "WindowRootMismatch", "WindowSignaturesInvalid",
    "batch_replay_enabled", "known_roots_fn", "replay_states",
]
