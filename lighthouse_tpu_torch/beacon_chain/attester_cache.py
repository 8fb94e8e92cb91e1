"""Attester caches + block timing — the hot-path caches around
attestation production (VERDICT r4 #8):

- :class:`AttesterCache` — ``beacon_chain/src/attester_cache.rs``: the
  values attestation DATA needs for a (head block, target epoch) pair —
  the justified (source) checkpoint and the target root — computed once
  from a state and served thereafter with ZERO state work.  Producing
  attestation data previously copied + slot-advanced the head state per
  call; at registry scale that copy is ~100 MB.
- :class:`EarlyAttesterCache` — ``early_attester_cache.rs``: primed at
  block IMPORT time from the just-computed post-state, so attestations
  for a block can be produced the moment it lands, before any head
  recompute or state lookup.
- :class:`BlockTimesCache` — ``block_times_cache.rs``: per-root
  observed / imported / set-as-head timestamps feeding delay metrics and
  the validator monitor.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import Dict, Optional, Tuple


@dataclass(frozen=True)
class AttesterCacheEntry:
    """What attestation data needs beyond (slot, index, head_root)."""
    source_epoch: int
    source_root: bytes
    target_root: bytes          # block root at the target epoch's start


class AttesterCache:
    """(head_root, epoch) → :class:`AttesterCacheEntry` (bounded LRU).

    Entries are derived from any state whose slot lies in the target
    epoch on the head's chain: the justified checkpoint and the
    epoch-boundary root are constant across the epoch for a fixed head
    (`attester_cache.rs` AttesterCacheKey reasoning)."""

    MAX_ENTRIES = 16

    def __init__(self):
        self._map: Dict[Tuple[bytes, int], AttesterCacheEntry] = {}
        self._lock = threading.Lock()

    def get(self, head_root: bytes, epoch: int
            ) -> Optional[AttesterCacheEntry]:
        with self._lock:
            key = (bytes(head_root), int(epoch))
            entry = self._map.get(key)
            if entry is not None:  # LRU touch
                self._map.pop(key)
                self._map[key] = entry
            return entry

    def put(self, head_root: bytes, epoch: int,
            entry: AttesterCacheEntry) -> None:
        with self._lock:
            self._map[(bytes(head_root), int(epoch))] = entry
            while len(self._map) > self.MAX_ENTRIES:
                self._map.pop(next(iter(self._map)))

    def prime_from_state(self, head_root: bytes, state, preset) -> None:
        """Fill the entry for ``state``'s current epoch (the state must
        be on ``head_root``'s chain, at or after the epoch start — e.g.
        a block post-state or the slot-advance timer's product)."""
        from ..state_transition.helpers import get_block_root

        spe = preset.SLOTS_PER_EPOCH
        epoch = int(state.slot) // spe
        if int(state.slot) % spe == 0:
            # At the boundary slot the epoch-start block IS the head
            # (nothing later exists in this epoch yet).
            target_root = bytes(head_root)
        else:
            target_root = bytes(get_block_root(state, epoch, preset))
        src = state.current_justified_checkpoint
        self.put(head_root, epoch, AttesterCacheEntry(
            source_epoch=int(src.epoch), source_root=bytes(src.root),
            target_root=target_root))


class EarlyAttesterCache:
    """The imported-this-instant block's attestation parameters
    (`early_attester_cache.rs`): one slot's worth of state, replaced on
    every import.  Entries are EPOCH-scoped: source/target change at the
    epoch boundary, so a block imported in epoch e must not serve
    attestations for e+1 (the reference rejects cross-epoch requests
    the same way)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._root: Optional[bytes] = None
        self._slot = 0
        self._epoch = -1
        self._entry: Optional[AttesterCacheEntry] = None

    def add(self, block_root: bytes, slot: int, epoch: int,
            entry: AttesterCacheEntry) -> None:
        with self._lock:
            self._root = bytes(block_root)
            self._slot = int(slot)
            self._epoch = int(epoch)
            self._entry = entry

    def try_attest(self, head_root: bytes, slot: int, epoch: int
                   ) -> Optional[AttesterCacheEntry]:
        with self._lock:
            if (self._root == bytes(head_root) and self._slot <= int(slot)
                    and self._epoch == int(epoch)):
                return self._entry
            return None


@dataclass
class BlockTimes:
    observed: Optional[float] = None
    imported: Optional[float] = None
    set_as_head: Optional[float] = None


class BlockTimesCache:
    """Per-root gossip→import→head latency (`block_times_cache.rs`)."""

    MAX_ENTRIES = 64

    def __init__(self):
        self._map: Dict[bytes, BlockTimes] = {}
        self._lock = threading.Lock()

    def _entry(self, root: bytes) -> BlockTimes:
        root = bytes(root)
        e = self._map.get(root)
        if e is None:
            e = self._map[root] = BlockTimes()
            while len(self._map) > self.MAX_ENTRIES:
                self._map.pop(next(iter(self._map)))
        return e

    def observed(self, root: bytes) -> None:
        with self._lock:
            e = self._entry(root)
            if e.observed is None:
                e.observed = time.monotonic()

    def imported(self, root: bytes) -> None:
        with self._lock:
            self._entry(root).imported = time.monotonic()

    def set_as_head(self, root: bytes) -> None:
        with self._lock:
            self._entry(root).set_as_head = time.monotonic()

    def times(self, root: bytes) -> Optional[BlockTimes]:
        with self._lock:
            return self._map.get(bytes(root))

    def import_to_head_ms(self, root: bytes) -> Optional[float]:
        t = self.times(root)
        if t is None or t.imported is None or t.set_as_head is None:
            return None
        return (t.set_as_head - t.imported) * 1e3
