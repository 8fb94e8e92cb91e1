"""Slot processing and the whole-state transition entry points.

Counterpart of ``consensus/state_processing/src/
per_slot_processing.rs`` and the ``state_transition`` composition: cache the
state root, roll the block/state root vectors, run epoch processing at
boundaries, apply fork upgrades at activation epochs.
"""

from __future__ import annotations

from ..common.tracing import TRACER
from ..types.chain_spec import ForkName
from .per_block import SignatureStrategy, process_block
from .per_epoch import process_epoch
from .upgrade import upgrade_state


class SlotProcessingError(ValueError):
    pass


def process_slot(state, preset, known_root: bytes | None = None) -> bytes:
    """One ``process_slot``: record state root, backfill header state root,
    record block root.  Returns the cached state root.

    ``known_root`` short-circuits the state-root computation when the
    caller already has it (store replay via ``BlockReplayer`` —
    ``block_replayer.rs`` ``state_root_iter``)."""
    state_root = known_root if known_root is not None \
        else state.tree_hash_root()
    state.state_roots.set(state.slot % preset.SLOTS_PER_HISTORICAL_ROOT,
                          state_root)
    if state.latest_block_header.state_root == b"\x00" * 32:
        state.latest_block_header.state_root = state_root
    block_root = state.latest_block_header.tree_hash_root()
    state.block_roots.set(state.slot % preset.SLOTS_PER_HISTORICAL_ROOT,
                          block_root)
    return state_root


def process_slots(state, target_slot: int, preset, spec, T,
                  state_root_fn=None):
    """Advance ``state`` to ``target_slot`` (epoch processing + fork
    upgrades on the way).  Returns the (possibly upgraded) state — upgrades
    change the state's class, mirroring ``per_slot_processing``'s
    ``Option<EpochProcessingSummary>`` + upgrade handling.

    ``state_root_fn(slot) -> bytes | None`` supplies known state roots to
    skip hashing during replay."""
    if target_slot < state.slot:
        raise SlotProcessingError(
            f"cannot rewind state from {state.slot} to {target_slot}")
    while state.slot < target_slot:
        known = state_root_fn(int(state.slot)) if state_root_fn else None
        process_slot(state, preset, known_root=known)
        if (state.slot + 1) % preset.SLOTS_PER_EPOCH == 0:
            fork = spec.fork_name_at_epoch(
                state.slot // preset.SLOTS_PER_EPOCH)
            with TRACER.span("epoch_transition", cat="state_transition",
                             epoch=int(state.slot)
                             // preset.SLOTS_PER_EPOCH + 1):
                process_epoch(state, fork, preset, spec, T)
        state.slot += 1
        if state.slot % preset.SLOTS_PER_EPOCH == 0:
            epoch = state.slot // preset.SLOTS_PER_EPOCH
            state = upgrade_state(state, epoch, preset, spec, T)
    return state


def state_transition(state, signed_block, preset, spec, T,
                     strategy: SignatureStrategy = SignatureStrategy.VERIFY_BULK,
                     validate_state_root: bool = True,
                     pubkey_cache=None, payload_verifier=None):
    """Full spec ``state_transition``: slots → block → state-root check.
    Returns the post-state (upgraded class if a fork activated)."""
    block = signed_block.message
    state = process_slots(state, block.slot, preset, spec, T)
    fork = spec.fork_name_at_epoch(state.slot // preset.SLOTS_PER_EPOCH)
    process_block(state, signed_block, fork, preset, spec, T,
                  strategy=strategy, pubkey_cache=pubkey_cache,
                  payload_verifier=payload_verifier)
    if validate_state_root:
        root = state.tree_hash_root()
        if root != block.state_root:
            raise SlotProcessingError(
                f"post-state root {root.hex()} != block.state_root "
                f"{block.state_root.hex()}")
    return state
