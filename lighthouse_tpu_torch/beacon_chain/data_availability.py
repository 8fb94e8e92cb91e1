"""Deneb data-availability gate — the ``data_availability_checker`` of the
reference (``beacon_node/beacon_chain/src/data_availability_checker.rs``;
port of ``lighthouse_tpu/beacon_chain/data_availability.py``): blob
sidecars arrive over gossip/req-resp, are verified (structure, commitment
inclusion proof against the header's body root, KZG proof), and cached
per block root; block import is gated on every commitment in the block
body having a matching verified sidecar.

The KZG check routes through :mod:`lighthouse_tpu_torch.kzg`
(``verify_blob_kzg_proof_batch``): on the card when the port's device is a
GPU (the evaluation kernel, Miller+fold and finalize), the host RLC fold
on the CPU device.  Only the VERIFIER side of the trusted setup is needed,
so the checker never materializes the width-sized G1 Lagrange table
(:func:`~lighthouse_tpu_torch.kzg.trusted_setup.verification_setup`).
"""

from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional, Tuple

from ..common.metrics import REGISTRY
from .errors import BlobSidecarError, BlobsUnavailable


class DataAvailabilityChecker:
    """Pending-blob cache + the import-time availability predicate."""

    # Hard bound on distinct block roots in the pending map: sidecar
    # verification does NOT check the header's proposer signature, so an
    # attacker can fabricate self-consistent sidecars for invented blocks
    # at arbitrary (even far-future) slots — without a cap that is a
    # memory-exhaustion vector on every node (all nodes subscribe to all
    # blob subnets).  Honest traffic needs a handful of roots in flight;
    # eviction is oldest-insertion-first.
    MAX_PENDING_ROOTS = 64

    # Parked executed blocks (verified, awaiting blobs) expire: a block
    # whose blobs never arrive must not hold its full post-state forever
    # — blobs may simply never exist (an equivocating proposer withheld
    # them), and the slot-window prune only advances with the clock.  An
    # expired block is re-fetchable: dropping the parked entry costs a
    # re-verification on retry, never the block.  Wall-clock TTL + count
    # cap bound memory even on a stalled chain.
    PARKED_BLOCK_TTL_S = 60.0
    MAX_PARKED_BLOCKS = 16

    def __init__(self, preset, T, setup=None, clock=time.monotonic):
        self.preset = preset
        self.T = T
        self._setup = setup
        self._clock = clock
        self._lock = threading.Lock()
        # block_root → {index: verified BlobSidecar}
        self._pending: Dict[bytes, Dict[int, object]] = {}
        # block_root → (ExecutedBlock awaiting blobs, parked_at) (retries
        # skip re-verification/re-execution — `pending_components` role).
        self._pending_blocks: Dict[bytes, Tuple[object, float]] = {}
        # Resilient-dispatch seam for the chain's streaming verification
        # service (not ported yet, so None): when set, batched KZG proof
        # checks route through it.  Same signature as
        # `kzg.verify_blob_kzg_proof_batch(b, c, p, setup)`.
        self.verify_batch_fn = None
        self._verified = REGISTRY.counter(
            "blob_sidecars_verified_total", "Blob sidecars verified")
        self._rejected = REGISTRY.counter(
            "blob_sidecars_rejected_total", "Blob sidecars rejected")
        self._expired = REGISTRY.counter(
            "parked_blocks_expired_total",
            "Parked executed blocks dropped by TTL/cap")

    def _verify_batch(self, blobs, commitments, proofs) -> bool:
        """One batched KZG verification, through the resilient service
        when attached (raises ``kzg.KzgError`` on malformed data either
        way)."""
        from ..common.tracing import TRACER
        with TRACER.span("kzg_batch_verify", cat="da_kzg",
                         blobs=len(blobs)) as _sp:
            if TRACER.enabled:
                # A host-path verify leaves the device stage dict
                # untouched; clear it so stale stages from a PREVIOUS
                # device batch can't attach to this span.
                from ..kzg.device import reset_stage_timings
                reset_stage_timings()
            if self.verify_batch_fn is not None:
                ok = self.verify_batch_fn(blobs, commitments, proofs,
                                          self.setup)
            else:
                from .. import kzg as KZ
                ok = KZ.verify_blob_kzg_proof_batch(
                    blobs, commitments, proofs, self.setup)
            # Device-stage attribution: the per-stage split the device
            # path left in LAST_KZG_TIMINGS becomes child spans.
            TRACER.record_stages("kzg", cat="da_kzg")
            _sp.set(verdict=bool(ok))
            return ok

    @property
    def setup(self):
        if self._setup is None:
            from ..kzg.trusted_setup import verification_setup
            self._setup = verification_setup(
                self.preset.FIELD_ELEMENTS_PER_BLOB)
        return self._setup

    # -- sidecar verification (gossip rules subset,
    #    `blob_verification.rs` GossipVerifiedBlob) ---------------------------

    def _structural_check(self, sidecar) -> bytes:
        """The cheap per-sidecar checks shared by single and batch
        insertion: index bound + commitment inclusion proof.  Returns the
        bound block root.  The header's proposer signature is NOT checked
        here — availability is later asserted against the
        proposer-signature-verified block's own commitments, so a forged
        header cannot satisfy the gate for a real block."""
        from .. import kzg as KZ
        idx = int(sidecar.index)
        if idx >= self.preset.MAX_BLOBS_PER_BLOCK:
            self._rejected.inc()
            raise BlobSidecarError(f"blob index {idx} out of range")
        if not KZ.verify_blob_sidecar_inclusion_proof(sidecar, self.preset):
            self._rejected.inc()
            raise BlobSidecarError("commitment inclusion proof invalid")
        return sidecar.signed_block_header.message.tree_hash_root()

    def verify_blob_sidecar(self, sidecar) -> bytes:
        """Full sidecar verification (structure + KZG proof); returns the
        bound block root."""
        from .. import kzg as KZ
        block_root = self._structural_check(sidecar)
        try:
            ok = self._verify_batch(
                [bytes(sidecar.blob)], [bytes(sidecar.kzg_commitment)],
                [bytes(sidecar.kzg_proof)])
        except KZ.KzgError as e:
            self._rejected.inc()
            raise BlobSidecarError(f"malformed blob/commitment: {e}") from e
        if not ok:
            self._rejected.inc()
            raise BlobSidecarError("KZG proof verification failed")
        self._verified.inc()
        return block_root

    def put_sidecar(self, sidecar) -> bytes:
        """Verify + cache one sidecar; returns its block root."""
        block_root = self.verify_blob_sidecar(sidecar)
        with self._lock:
            self._pending.setdefault(block_root, {})[
                int(sidecar.index)] = sidecar
            self._bound_pending()
        return block_root

    def _bound_pending(self) -> None:
        """Caller holds the lock.  Evict oldest roots beyond the cap
        (dict preserves insertion order)."""
        while len(self._pending) > self.MAX_PENDING_ROOTS:
            self._pending.pop(next(iter(self._pending)))

    def put_sidecars(self, sidecars) -> None:
        """Batch insert: ONE batched KZG verification for the group (the
        per-block gossip burst / by-root response shape), after the cheap
        per-sidecar structural checks."""
        from .. import kzg as KZ
        roots = [self._structural_check(sc) for sc in sidecars]
        if not sidecars:
            return
        try:
            ok = self._verify_batch(
                [bytes(sc.blob) for sc in sidecars],
                [bytes(sc.kzg_commitment) for sc in sidecars],
                [bytes(sc.kzg_proof) for sc in sidecars])
        except KZ.KzgError as e:
            self._rejected.inc(len(sidecars))
            raise BlobSidecarError(f"malformed blob batch: {e}") from e
        if not ok:
            self._rejected.inc(len(sidecars))
            raise BlobSidecarError("batched KZG verification failed")
        self._verified.inc(len(sidecars))
        with self._lock:
            for sc, root in zip(sidecars, roots):
                self._pending.setdefault(root, {})[int(sc.index)] = sc
            self._bound_pending()

    # -- the import gate ------------------------------------------------------

    def check_availability(self, signed_block, block_root: bytes) -> None:
        """Raise :class:`BlobsUnavailable` unless every commitment in the
        block has a verified sidecar with the SAME commitment at the same
        index (`data_availability_checker.rs` put_pending_executed_block →
        Availability::Available)."""
        commitments = getattr(signed_block.message.body,
                              "blob_kzg_commitments", None)
        if not commitments:
            return
        with self._lock:
            have = dict(self._pending.get(block_root, {}))
        missing = []
        for i, c in enumerate(commitments):
            sc = have.get(i)
            if sc is None or bytes(sc.kzg_commitment) != bytes(c):
                missing.append(i)
        if missing:
            raise BlobsUnavailable(
                f"block {block_root.hex()[:16]} missing verified blobs "
                f"for commitment indices {missing}")

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

    def peek_executed_block(self, block_root: bytes):
        with self._lock:
            self._expire_parked_locked()
            got = self._pending_blocks.get(block_root)
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

    def expire_parked(self) -> int:
        """Public expiry sweep (the chain's per-slot task); returns the
        parked-block count after expiry."""
        with self._lock:
            self._expire_parked_locked()
            return len(self._pending_blocks)

    def take_sidecars(self, block_root: bytes) -> List:
        """Drain the cached sidecars for an imported block (persisted to
        the store by the chain)."""
        with self._lock:
            have = self._pending.pop(block_root, {})
        return [have[i] for i in sorted(have)]

    def missing_indices(self, signed_block, block_root: bytes) -> List[int]:
        commitments = getattr(signed_block.message.body,
                              "blob_kzg_commitments", None) or []
        with self._lock:
            have = self._pending.get(block_root, {})
        return [i for i, c in enumerate(commitments)
                if i not in have
                or bytes(have[i].kzg_commitment) != bytes(c)]

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


def build_blob_sidecars(signed_block, blobs, setup, preset, T,
                        proofs=None) -> List:
    """Assemble spec BlobSidecars for a block's blobs (the proposer/test
    side — ``get_blob_sidecars`` in the validator flow): computes KZG
    proofs (unless given) and the commitment inclusion branches."""
    from .. import kzg as KZ
    body = signed_block.message.body
    commitments = [bytes(c) for c in body.blob_kzg_commitments]
    if len(blobs) != len(commitments):
        raise BlobSidecarError("one blob per commitment required")
    msg = signed_block.message
    header = T.SignedBeaconBlockHeader(
        message=T.BeaconBlockHeader(
            slot=msg.slot, proposer_index=msg.proposer_index,
            parent_root=msg.parent_root, state_root=msg.state_root,
            body_root=body.tree_hash_root()),
        signature=signed_block.signature)
    out = []
    for i, blob in enumerate(blobs):
        proof = (proofs[i] if proofs is not None
                 else KZ.compute_blob_kzg_proof(bytes(blob), commitments[i],
                                                setup))
        out.append(T.BlobSidecar(
            index=i, blob=bytes(blob), kzg_commitment=commitments[i],
            kzg_proof=bytes(proof), signed_block_header=header,
            kzg_commitment_inclusion_proof=KZ.blob_sidecar_inclusion_proof(
                body, i, preset)))
    return out
