"""Deneb data-availability gate — the ``data_availability_checker`` of the
reference (``beacon_node/beacon_chain/src/data_availability_checker.rs``;
port of ``lighthouse_tpu/beacon_chain/data_availability.py``): blob
sidecars arrive over gossip/req-resp, are verified (structure, commitment
inclusion proof, KZG proof), and cached per block root; block import is
gated on every commitment in the block body having a matching verified
sidecar.

KZG is not ported yet.  Every path that needs a KZG check — sidecar
verification, and the import gate of a block that carries commitments —
raises :class:`KzgNotPorted`; such a block is never treated as
available.  Blocks without commitments (every pre-Deneb block) pass the
gate as before.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional, Tuple

from ..common.metrics import REGISTRY


class KzgNotPorted(NotImplementedError):
    """A blob needs a KZG check, and the port has no KZG yet."""


def _kzg_missing(what: str):
    raise KzgNotPorted(
        f"{what} needs KZG verification, which lighthouse_tpu_torch does "
        f"not port yet (the JAX package's lighthouse_tpu/kzg has no "
        f"counterpart here); the block is not treated as available")


class DataAvailabilityChecker:
    """Pending-blob cache + the import-time availability predicate."""

    # Parked executed blocks (verified, awaiting blobs) expire: a block
    # whose blobs never arrive must not hold its full post-state forever
    # — blobs may simply never exist (an equivocating proposer withheld
    # them), and the slot-window prune only advances with the clock.  An
    # expired block is re-fetchable: dropping the parked entry costs a
    # re-verification on retry, never the block.  Wall-clock TTL + count
    # cap bound memory even on a stalled chain.
    PARKED_BLOCK_TTL_S = 60.0
    MAX_PARKED_BLOCKS = 16

    def __init__(self, preset, T, clock=time.monotonic):
        self.preset = preset
        self.T = T
        self._clock = clock
        self._lock = threading.Lock()
        # block_root → {index: verified BlobSidecar} (filled once KZG is
        # ported; until then no sidecar verifies)
        self._pending: Dict[bytes, Dict[int, object]] = {}
        # block_root → (ExecutedBlock awaiting blobs, parked_at) (retries
        # skip re-verification/re-execution — `pending_components` role).
        self._pending_blocks: Dict[bytes, Tuple[object, float]] = {}
        self._expired = REGISTRY.counter(
            "parked_blocks_expired_total",
            "Parked executed blocks dropped by TTL/cap")

    def put_sidecars(self, sidecars) -> None:
        """Batch insert: nothing to verify is a no-op; anything else
        needs the KZG port."""
        if sidecars:
            _kzg_missing("blob sidecar verification")

    # -- the import gate ------------------------------------------------------

    def check_availability(self, signed_block, block_root: bytes) -> None:
        """Pass a block without blob commitments; a block with any raises
        :class:`KzgNotPorted` (`data_availability_checker.rs`
        put_pending_executed_block → Availability::Available needs every
        commitment's sidecar KZG-verified)."""
        commitments = getattr(signed_block.message.body,
                              "blob_kzg_commitments", None)
        if not commitments:
            return
        _kzg_missing(f"block {block_root.hex()[:16]} with "
                     f"{len(commitments)} blob commitments")

    def hold_executed_block(self, block_root: bytes, executed) -> None:
        """Park a fully-verified-but-blobless block for cheap resume.
        Re-parking refreshes the TTL (a retry with still-missing blobs
        is live interest, not a leak)."""
        with self._lock:
            self._pending_blocks[block_root] = (executed, self._clock())
            self._expire_parked_locked()

    def pop_executed_block(self, block_root: bytes):
        with self._lock:
            self._expire_parked_locked()
            got = self._pending_blocks.pop(block_root, None)
            return None if got is None else got[0]

    def _expire_parked_locked(self) -> None:
        """Caller holds the lock.  Drop parked blocks past the TTL, then
        oldest-first beyond the count cap — bounded memory even when the
        slot clock (and therefore :meth:`prune`) is stalled."""
        now = self._clock()
        dead = [root for root, (_ex, t0) in self._pending_blocks.items()
                if now - t0 > self.PARKED_BLOCK_TTL_S]
        for root in dead:
            del self._pending_blocks[root]
        while len(self._pending_blocks) > self.MAX_PARKED_BLOCKS:
            oldest = min(self._pending_blocks,
                         key=lambda r: self._pending_blocks[r][1])
            del self._pending_blocks[oldest]
            dead.append(oldest)
        if dead:
            self._expired.inc(len(dead))

    def take_sidecars(self, block_root: bytes) -> List:
        """Drain the cached sidecars for an imported block (persisted to
        the store by the chain)."""
        with self._lock:
            have = self._pending.pop(block_root, {})
        return [have[i] for i in sorted(have)]

    def prune(self, before_slot: int,
              horizon_slot: Optional[int] = None) -> None:
        """Drop pending sidecars outside [before_slot, horizon_slot]
        (driven by the chain's per-slot task).  The UPPER bound matters
        as much as the lower: sidecar headers are attacker-chosen, so a
        claimed slot of 2^60 must not grant permanent residency."""
        with self._lock:
            def live(slot: int) -> bool:
                return slot >= before_slot and (
                    horizon_slot is None or slot <= horizon_slot)

            self._pending = {
                root: scs for root, scs in self._pending.items()
                if any(live(int(sc.signed_block_header.message.slot))
                       for sc in scs.values())}
            self._pending_blocks = {
                root: (ex, t0)
                for root, (ex, t0) in self._pending_blocks.items()
                if live(int(ex.signed_block.message.slot))}
            self._expire_parked_locked()
