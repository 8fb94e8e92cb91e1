"""Anti-spam observation cache of the block pipeline
(``beacon_node/beacon_chain/src/observed_block_producers.rs``): a bounded
per-slot map remembering which proposer already sent which block, so a
gossip flood cannot re-enter the pipeline.  The attester and aggregator
caches of ``lighthouse_tpu/beacon_chain/observed.py`` are not ported
yet (attestation verification is not)."""

from __future__ import annotations

import threading
from typing import Dict


class ObservedBlockProducers:
    """Per-slot proposer dedup (`observed_block_producers.rs`).

    Keyed by (slot, proposer) → block root: seeing the SAME root again is
    a retry (e.g. a Deneb block re-processed once its blobs arrive), not
    an equivocation — only a DIFFERENT root from the same proposer at the
    same slot trips the repeat-proposal rejection (the spec gossip rule
    keys "first block" by root; identical re-delivery is deduped by the
    already-known check upstream)."""

    def __init__(self, horizon_slots: int = 64):
        self.horizon = horizon_slots
        # Atomic observe-if-fresh: concurrent callers racing the
        # check-then-set would let two DIFFERENT roots from one proposer
        # both pass.
        self._by_slot: Dict[int, Dict[int, bytes]] = {}  # guarded-by: _lock
        self._lock = threading.Lock()

    def observe(self, slot: int, proposer_index: int,
                block_root: bytes = b"") -> bool:
        with self._lock:
            seen = self._by_slot.setdefault(slot, {})
            if proposer_index in seen and seen[proposer_index] != block_root:
                return False
            seen[proposer_index] = block_root
            return True

    def has_been_observed(self, slot: int, proposer_index: int,
                          block_root: bytes = b"") -> bool:
        """Peek without recording — the gossip pipeline checks early but
        only records AFTER the proposal signature verifies, so unsigned
        junk cannot censor an honest proposer
        (`observed_block_producers.rs` proposer_has_been_observed vs
        observe_proposer two-phase)."""
        with self._lock:
            seen = self._by_slot.get(slot, {})
            return proposer_index in seen \
                and seen[proposer_index] != block_root

    def prune(self, current_slot: int) -> None:
        with self._lock:
            for s in [s for s in self._by_slot
                      if s + self.horizon < current_slot]:
                del self._by_slot[s]
