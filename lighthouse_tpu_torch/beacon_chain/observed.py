"""Anti-spam observation caches
(``beacon_node/beacon_chain/src/observed_{attesters,
block_producers}.rs``; port of ``lighthouse_tpu/beacon_chain/observed.py``):
bounded per-epoch/per-slot bitsets remembering who
we have already seen, so gossip floods cannot re-enter the pipelines."""

from __future__ import annotations

import threading
from typing import Dict, Set


class ObservedAttesters:
    """Per-(epoch, validator) seen-bits, pruned by epoch horizon
    (`observed_attesters.rs` EpochBitfield)."""

    def __init__(self, horizon_epochs: int = 2):
        self.horizon = horizon_epochs
        # observe() is the streaming path's atomic observe-if-fresh
        # primitive: concurrent completion callbacks (different pump
        # threads finishing duplicate gossip copies) race through the
        # check-then-add, and the GIL does not make that pair atomic.
        self._by_epoch: Dict[int, Set[int]] = {}  # guarded-by: _lock
        self._lock = threading.Lock()

    def observe(self, epoch: int, validator_index: int) -> bool:
        """Returns True if NEW (and records it); False if already seen.
        Atomic: exactly one of N concurrent callers gets True."""
        with self._lock:
            seen = self._by_epoch.setdefault(epoch, set())
            if validator_index in seen:
                return False
            seen.add(validator_index)
            return True

    def has_attested(self, epoch: int, validator_index: int) -> bool:
        """Peek (no recording) — the doppelganger liveness probe."""
        with self._lock:
            return validator_index in self._by_epoch.get(epoch, set())

    def prune(self, current_epoch: int) -> None:
        # Same lock as observe(): a prune racing two concurrent observes
        # of duplicate copies could delete the epoch set between them,
        # letting BOTH win the observe — the exact double-registration
        # the lock exists to prevent.
        with self._lock:
            for e in [e for e in self._by_epoch
                      if e + self.horizon < current_epoch]:
                del self._by_epoch[e]


class ObservedAggregators(ObservedAttesters):
    """Same shape, keyed per (epoch, aggregator)."""


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
        # Same atomic observe-if-fresh contract as ObservedAttesters:
        # concurrent completion callbacks racing the check-then-set
        # would let two DIFFERENT roots from one proposer both pass.
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
