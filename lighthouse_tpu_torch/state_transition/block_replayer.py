"""Block-range replay with hooks — the ``BlockReplayer`` pattern
(``consensus/state_processing/src/block_replayer.rs:86-305``).

Re-applies a range of blocks to a base state for state reconstruction
(store replay from ``HotStateSummary``/restore points), analytics, and the
profiling CLI.  Signature verification defaults OFF (replayed blocks were
already verified on import) and state-root computation is skipped wherever
a known root can be supplied (``state_root_fn`` — the store feeds roots it
already has on disk), matching the reference's ``state_root_iter``.
"""

from __future__ import annotations

from typing import Callable, Iterable, Optional

from .per_block import SignatureStrategy, process_block
from .per_slot import process_slots


class BlockReplayer:
    """Builder-style replayer: configure, then :meth:`apply_blocks`."""

    def __init__(self, state, preset, spec, T,
                 strategy: SignatureStrategy = SignatureStrategy.NO_VERIFICATION,
                 state_root_fn: Optional[Callable[[int], Optional[bytes]]] = None):
        self.state = state
        self.preset = preset
        self.spec = spec
        self.T = T
        self.strategy = strategy
        self.state_root_fn = state_root_fn
        self.pre_block_hook: Optional[Callable] = None
        self.post_block_hook: Optional[Callable] = None
        self.pre_slot_hook: Optional[Callable] = None

    def apply_blocks(self, blocks: Iterable, target_slot: Optional[int] = None):
        """Apply ``blocks`` in order (advancing slots between them), then
        optionally advance to ``target_slot``.  Returns the final state."""
        state = self.state
        for signed in blocks:
            block = signed.message
            if int(block.slot) <= int(state.slot):
                raise ValueError(
                    f"replay block slot {int(block.slot)} not after state "
                    f"slot {int(state.slot)}")
            if self.pre_slot_hook is not None:
                self.pre_slot_hook(state)
            state = process_slots(state, int(block.slot), self.preset,
                                  self.spec, self.T,
                                  state_root_fn=self.state_root_fn)
            if self.pre_block_hook is not None:
                self.pre_block_hook(state, signed)
            fork = self.spec.fork_name_at_epoch(
                int(state.slot) // self.preset.SLOTS_PER_EPOCH)
            process_block(state, signed, fork, self.preset, self.spec,
                          self.T, strategy=self.strategy)
            if self.post_block_hook is not None:
                self.post_block_hook(state, signed)
        if target_slot is not None and target_slot > int(state.slot):
            state = process_slots(state, target_slot, self.preset, self.spec,
                                  self.T, state_root_fn=self.state_root_fn)
        self.state = state
        return state
