"""The chain orchestrator — ``BeaconChain``
(``beacon_node/beacon_chain/src/beacon_chain.rs``; port of
``lighthouse_tpu/beacon_chain/chain.py``).

Holds the store, fork choice, op pool, slot clock and observation caches;
drives the staged block pipeline (``process_block`` —
``beacon_chain.rs:2599``), the batched attestation path
(``apply_attestation_to_fork_choice`` — ``:1858``), head recomputation
(``canonical_head.rs`` — an immutable cached snapshot so readers never
lock), block production from the op pool (``produce_block`` —
``:3526``) and the per-slot task (``:5322``).

Not ported yet: the streaming verification service and light-client
updates — the ``lc_*`` attributes stay ``None``.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import List

import numpy as np

from ..common import tracing
from ..common.metrics import Histogram, observe
from ..common.tracing import TRACER
from ..fork_choice import ForkChoice
from ..op_pool import OperationPool
from ..state_transition import signature_sets as sigs
from ..state_transition.committees import get_beacon_proposer_index
from ..state_transition.per_slot import process_slots
from ..store import DBColumn, HotColdDB
from .attestation_verification import (
    ATTESTATION_PROPAGATION_SLOT_RANGE,
    batch_verify_attestations,
)
from .block_verification import (
    ExecutedBlock,
    GossipVerifiedBlock,
    SignatureVerifiedBlock,
)
from .errors import BlockError
from .events import EventBus
from .observed import (
    ObservedAggregators,
    ObservedAttesters,
    ObservedBlockProducers,
)

# Stage dict for the `production` tracing source: the last production's
# state copy and slot advance (nothing to advance when it adopted the
# pre-advanced state).
LAST_PRODUCTION_TIMINGS: dict = {}

tracing.register_stage_source("production", lambda: LAST_PRODUCTION_TIMINGS)


@dataclass
class CanonicalHead:
    """Immutable head snapshot (`canonical_head.rs:85-238`): hot readers
    never take the fork-choice lock."""
    root: bytes
    slot: int
    state: object


class DutyCache:
    """Pre-materialized proposer/committee duties for ONE
    (head root, epoch) — the shuffle/lookahead cache behind the duties
    endpoints and block assembly (`beacon_proposer_cache.rs` +
    `validator/duties` recompute avoidance).

    ``proposers[slot - first_slot]`` is the proposer index;
    attester duties resolve through a vectorized inverse-shuffle map
    (validator → position in the epoch's shuffled column) built ONCE
    per epoch per head, so a duties request for millions of keys is a
    numpy gather, not a per-request committee walk."""

    def __init__(self, head_root: bytes, epoch: int, first_slot: int,
                 proposers: List[int], committees) -> None:
        self.head_root = head_root
        self.epoch = epoch
        self.first_slot = first_slot
        self.proposers = proposers
        self.committees = committees          # CommitteeCache
        self._inv = None                      # validator → shuffled pos

    def proposer_at(self, slot: int) -> int:
        return self.proposers[int(slot) - self.first_slot]

    def _inverse(self, n_validators: int) -> np.ndarray:
        if self._inv is None or self._inv.shape[0] < n_validators:
            inv = np.full(n_validators, -1, np.int64)
            shuffled = self.committees.shuffled
            inv[shuffled] = np.arange(shuffled.shape[0], dtype=np.int64)
            self._inv = inv
        return self._inv

    def attester_duty(self, validator_index: int, n_validators: int):
        """``(slot, committee_index, position, committee_length)`` for
        one validator, or ``None`` (inactive this epoch)."""
        vi = int(validator_index)
        if vi >= n_validators:
            return None
        j = int(self._inverse(n_validators)[vi])
        if j < 0:
            return None
        cc = self.committees
        n = cc.shuffled.shape[0]
        count = cc.committees_per_slot * cc.slots_per_epoch
        # committee i owns shuffled[n*i//count : n*(i+1)//count]; invert
        # the slice arithmetic: i is the last committee starting at or
        # before j.
        i = (j * count) // n
        while n * i // count > j:
            i -= 1
        while n * (i + 1) // count <= j:
            i += 1
        start = n * i // count
        end = n * (i + 1) // count
        slot = self.first_slot + i // cc.committees_per_slot
        return (slot, i % cc.committees_per_slot, j - start, end - start)


class SyncMessagePool:
    """Naive per-slot aggregation of sync-committee messages
    (`naive_aggregation_pool.rs`, sync flavour): votes keyed by
    (slot, beacon_block_root), bits by committee position, signatures
    G2-aggregated on read."""

    def __init__(self, preset):
        self.preset = preset
        # (slot, root) → {position: signature_bytes}
        self._votes: dict = {}

    def insert(self, slot: int, block_root: bytes, positions, signature:
               bytes) -> None:
        entry = self._votes.setdefault((slot, bytes(block_root)), {})
        for pos in positions:
            entry.setdefault(int(pos), bytes(signature))

    def aggregate(self, slot: int, block_root: bytes, T):
        """SyncAggregate over the collected votes (empty if none)."""
        from ..crypto import bls
        entry = self._votes.get((slot, bytes(block_root)), {})
        bits = [False] * self.preset.SYNC_COMMITTEE_SIZE
        sigs_ = []
        for pos, sig in entry.items():
            if pos < len(bits):
                bits[pos] = True
                # One signature instance PER SET BIT: a validator holding
                # several committee positions contributes its signature
                # once per position (spec SyncAggregate semantics).
                sigs_.append(bls.Signature.deserialize(sig))
        agg = (bls.aggregate_signatures(sigs_).serialize() if sigs_
               else b"\xc0" + b"\x00" * 95)
        return T.SyncAggregate(sync_committee_bits=bits,
                               sync_committee_signature=agg)

    def prune(self, before_slot: int) -> None:
        self._votes = {k: v for k, v in self._votes.items()
                       if k[0] >= before_slot}


class BeaconChain:
    """Single-process chain runtime."""

    def __init__(self, *, store: HotColdDB, genesis_state, genesis_block_root,
                 preset, spec, T, slot_clock=None):
        self.store = store
        self.preset = preset
        self.spec = spec
        self.T = T
        self.slot_clock = slot_clock
        self.pubkey_cache = sigs.PubkeyCache()
        self.op_pool = OperationPool(preset, spec)
        self.observed_attesters = ObservedAttesters()
        self.observed_aggregators = ObservedAggregators()
        self.observed_block_producers = ObservedBlockProducers()
        self.payload_verifier = None  # execution-layer seam
        self.slasher = None  # opt-in: attach_slasher()
        self.sync_message_pool = SyncMessagePool(preset)
        self.event_bus = EventBus()
        self.validator_monitor = None  # opt-in: set a ValidatorMonitor
        from .data_availability import DataAvailabilityChecker
        self.data_availability = DataAvailabilityChecker(preset, T)
        self.verification_service = None  # not ported: streaming verify
        self.genesis_block_root = genesis_block_root
        self.fork_choice = ForkChoice(
            preset, spec, genesis_root=genesis_block_root,
            genesis_state=genesis_state.copy())
        genesis_state_root = genesis_state.tree_hash_root()
        self.genesis_state_root = genesis_state_root
        store.put_state(genesis_state_root, genesis_state.copy(),
                        genesis_block_root)
        self._states_by_block: dict[bytes, object] = {
            genesis_block_root: genesis_state.copy()}
        self._advanced_states: dict = {}
        self._duty_caches: dict = {}
        self._duty_prime_errors: dict = {}
        from .attester_cache import (
            AttesterCache, BlockTimesCache, EarlyAttesterCache)
        self.attester_cache = AttesterCache()
        self.early_attester_cache = EarlyAttesterCache()
        self.block_times_cache = BlockTimesCache()
        self.lc_optimistic_update = None
        self.lc_finality_update = None
        self.lc_period_update = None
        self.head = CanonicalHead(root=genesis_block_root,
                                  slot=int(genesis_state.slot),
                                  state=genesis_state.copy())
        self.last_recovery = None
        self._init_slo()
        # Anchor snapshot: a process killed before its first finalization
        # must still find a resumable chain in the datadir; every later
        # import's journal entry replays on top of this.
        self._persisted_finalized = self.fork_choice.finalized_checkpoint
        self.persist()

    def _init_slo(self) -> None:
        """SLO engine + node health (common/slo.py): objectives
        evaluated from record-time aggregates at every slot tick.
        Shared by ``__init__`` and the ``resume`` restart path (which
        builds via ``__new__``).  The import histogram is chain-LOCAL
        (unregistered) so a multi-node test process never mixes peers'
        imports into one node's objective; bucket bounds bracket the
        150 ms block budget exactly."""
        from ..common.device_ledger import LEDGER
        from ..common.slo import (SloEngine, default_objectives,
                                  wire_chain_feeds)
        # Device-ledger Prometheus families ride chain construction
        # (both __init__ and the resume path land here) — a bare
        # library import never touches the registry.
        LEDGER.register_metrics()
        self._slo_import_hist = Histogram(
            "block_import_seconds_local", "",
            buckets=(0.005, 0.01, 0.025, 0.05, 0.075, 0.1, 0.15, 0.25,
                     0.5, 1.0, 2.5, 5.0))
        # import_failure_rate feed: a latency histogram only sees
        # SUCCESSFUL imports — a node whose every import dies would
        # read healthy on an empty window.  Plain ints (GIL-atomic
        # increments; the feed reads them racily by design).
        self._slo_import_attempts = 0
        self._slo_import_failures = 0
        # block_production_ms feed: one observation per assembled block
        # (the proposer's adopt → pack → assemble wall).  Bucket bounds
        # bracket the slot/3 budgets this repo actually runs (0.333 s
        # compressed drill, 2 s MINIMAL, 4 s mainnet).
        self._slo_production_hist = Histogram(
            "block_production_seconds_local", "",
            buckets=(0.005, 0.01, 0.025, 0.05, 0.1, 0.167, 0.25, 0.333,
                     0.5, 1.0, 2.0, 4.0))
        # Pre-advance adoption counters (GIL-atomic ints): adopted =
        # production found the pre-advanced state for the unchanged head;
        # serial = it advanced at production time (cold start or a head
        # change since the advance).
        self._produce_adopted = 0
        self._produce_serial = 0
        slot_seconds = getattr(self.spec, "seconds_per_slot", 12)
        # Evaluation cadence ≈ slot cadence: hysteresis counts
        # EVALUATIONS, and the HTTP routes also tick — without this a
        # 1 Hz scraper would step the debounce 6-12x faster than the
        # slot ticks it was sized for (and flip /health's 503 drain
        # signal on a transient stall two slot ticks would smooth).
        # HALF a slot, not a full one: a timer tick arriving a few ms
        # early against an exact-slot interval would be dropped,
        # silently halving the cadence on jitter.
        self.slo_engine = SloEngine(
            default_objectives(slot_seconds),
            min_eval_interval_s=slot_seconds / 2.0)
        wire_chain_feeds(self.slo_engine, self)
        # Device proof serving (ops/proof_engine.ProofServer) is lazy:
        # a chain that never serves a proof never builds a field tree.
        # The proof_serve SLO feed and the /lighthouse/device panel read
        # the raw attribute so a scrape can't instantiate it.
        self._proof_server = None

    @property
    def proof_server(self):
        """The chain's :class:`~..ops.proof_engine.ProofServer`
        (constructed on first use; serves state proofs and the re-homed
        light-client branches)."""
        if self._proof_server is None:
            from ..ops.proof_engine import ProofServer
            self._proof_server = ProofServer(self)
        return self._proof_server

    # -- restart persistence -------------------------------------------------

    def persist(self) -> None:
        """Persist fork choice + op pool + chain metadata so a restarted
        process resumes with the identical head and pending operations
        (`persisted_fork_choice.rs`, `operation_pool/src/persistence.rs`,
        `persisted_beacon_chain.rs`).  ONE atomic batch that also clears
        the import journal: after a successful persist the journal holds
        exactly the imports newer than this snapshot — the restart
        replay window."""
        from ..common.metrics import REGISTRY
        from ..fork_choice.persistence import encode_fork_choice
        from ..op_pool.persistence import encode_op_pool
        ops = [
            self.store.item_put_op(DBColumn.ForkChoice, b"fork_choice",
                                   encode_fork_choice(self.fork_choice)),
            self.store.item_put_op(DBColumn.OpPool, b"op_pool",
                                   encode_op_pool(self.op_pool, self.T)),
            self.store.item_put_op(DBColumn.BeaconChain, b"genesis",
                                   self.genesis_block_root
                                   + self.genesis_state_root),
        ]
        ops.extend(self.store.journal_clear_ops())
        self.store.do_atomically(ops)
        REGISTRY.counter(
            "store_persist_total",
            "fork-choice/op-pool snapshot persists").inc()

    @classmethod
    def resume(cls, *, store: HotColdDB, preset, spec, T, slot_clock=None):
        """Rebuild a chain from a persisted store (restart path — the
        `ClientBuilder.build_beacon_chain` resume branch,
        `client/src/builder.rs:850`), self-healing: the store is
        CRC-verified (corrupt rows quarantined), the persisted
        fork-choice snapshot is reconciled against the block columns,
        and every import journaled after the snapshot replays — so a
        SIGKILL'd node restarts on exactly the head it died with
        (:mod:`..store.recovery`)."""
        from ..common.metrics import REGISTRY
        from ..fork_choice import ForkChoice
        from ..fork_choice.persistence import decode_fork_choice
        from ..op_pool.persistence import decode_op_pool
        from ..store import StoreCorruption
        from ..store.recovery import reconcile, verify_and_quarantine

        report = verify_and_quarantine(store)
        meta = store.get_item(DBColumn.BeaconChain, b"genesis")
        if meta is None:
            if any(q.column is DBColumn.BeaconChain
                   for q in report.quarantined):
                raise StoreCorruption(
                    "the persisted chain metadata is corrupt — this "
                    "datadir cannot be resumed; restore from a backup or "
                    "boot from a checkpoint", DBColumn.BeaconChain,
                    b"genesis")
            raise BlockError("store holds no persisted chain")
        genesis_root, genesis_state_root = meta[:32], meta[32:64]
        fc_blob = store.get_item(DBColumn.ForkChoice, b"fork_choice")
        pool_blob = store.get_item(DBColumn.OpPool, b"op_pool")

        def _post_state_of(block_root: bytes):
            if block_root == genesis_root:
                return store.get_state(genesis_state_root)
            block = store.get_block(block_root)
            if block is None:
                return None
            return store.get_state(bytes(block.message.state_root))

        if fc_blob is None:
            # The snapshot itself was lost/quarantined: rebuild fork
            # choice from the genesis anchor and let the reconciliation
            # pass replay every stored block (cold + hot) in slot order.
            genesis_state = store.get_state(genesis_state_root)
            if genesis_state is None:
                raise StoreCorruption(
                    "fork-choice snapshot AND genesis state are gone — "
                    "restore the datadir from a backup or resync",
                    DBColumn.BeaconState, genesis_state_root)
            fc = ForkChoice(preset, spec, genesis_root=genesis_root,
                            genesis_state=genesis_state.copy())
            report.rebuilt_fork_choice = True
            report.notes.append("fork-choice blob missing/corrupt: "
                                "rebuilt by full block replay")
        else:
            fc = decode_fork_choice(fc_blob, preset=preset, spec=spec,
                                    justified_state=None)
            jstate = _post_state_of(fc.justified_checkpoint[1])
            if jstate is None:
                raise StoreCorruption(
                    "justified state missing from store — restore the "
                    "datadir from a backup or resync",
                    DBColumn.BeaconState, fc.justified_checkpoint[1])
            fc.justified_state = jstate

        chain = cls.__new__(cls)
        chain.store = store
        chain.preset = preset
        chain.spec = spec
        chain.T = T
        chain.slot_clock = slot_clock
        chain.pubkey_cache = sigs.PubkeyCache()
        chain.op_pool = (decode_op_pool(pool_blob, preset, spec, T)
                         if pool_blob is not None
                         else OperationPool(preset, spec))
        chain.observed_attesters = ObservedAttesters()
        chain.observed_aggregators = ObservedAggregators()
        chain.observed_block_producers = ObservedBlockProducers()
        chain.payload_verifier = None
        chain.slasher = None
        chain.sync_message_pool = SyncMessagePool(preset)
        chain.event_bus = EventBus()
        chain.validator_monitor = None
        from .data_availability import DataAvailabilityChecker
        chain.data_availability = DataAvailabilityChecker(preset, T)
        chain.verification_service = None
        chain.genesis_block_root = genesis_root
        chain.genesis_state_root = genesis_state_root
        chain.fork_choice = fc
        chain._states_by_block = {}
        chain._advanced_states = {}
        chain._duty_caches = {}
        chain._duty_prime_errors = {}
        from .attester_cache import (
            AttesterCache, BlockTimesCache, EarlyAttesterCache)
        chain.attester_cache = AttesterCache()
        chain.early_attester_cache = EarlyAttesterCache()
        chain.block_times_cache = BlockTimesCache()
        chain.lc_optimistic_update = None
        chain.lc_finality_update = None
        chain.lc_period_update = None
        chain.last_recovery = None
        chain._init_slo()
        chain._persisted_finalized = fc.finalized_checkpoint
        # Reconcile snapshot vs store and replay the post-snapshot
        # import window BEFORE computing the head.
        reconcile(store, chain, report, genesis_root=genesis_root)
        chain.last_recovery = report
        if report.replayed:
            REGISTRY.counter(
                "store_recovery_replayed_blocks",
                "journaled imports replayed on restart").inc(
                    len(report.replayed))
        head_root = fc.get_head()
        head_state = _post_state_of(head_root)
        if head_state is None:
            # NOT BlockError: cli.py treats BlockError as "virgin
            # datadir" and would construct a fresh chain whose __init__
            # persist() overwrites the snapshot + clears the journal —
            # destroying the very bytes a restore needs.
            raise StoreCorruption(
                "head state missing from store (quarantined or lost) — "
                "restore the datadir from a backup or resync from a "
                "checkpoint", DBColumn.BeaconState, head_root)
        chain._states_by_block[head_root] = head_state.copy()
        # Post-state slot == block slot (and covers a genesis head, which
        # has no stored block).
        chain.head = CanonicalHead(root=head_root,
                                   slot=int(head_state.slot),
                                   state=head_state)
        return chain

    # Reference-style name for the restart path (`from_store` in the
    # survey's nomenclature): identical to :meth:`resume`.
    from_store = resume

    @classmethod
    def from_checkpoint(cls, *, store: HotColdDB, anchor_state,
                        anchor_block, preset, spec, T, slot_clock=None):
        """Checkpoint (weak-subjectivity) sync boot: start the chain from a
        trusted finalized state + its block instead of genesis
        (`client/src/builder.rs:209-391` weak_subjectivity_state).  The
        anchor acts as the fork-choice root; historical blocks below it
        arrive later via backfill (:mod:`..network.backfill`)."""
        anchor_root = anchor_block.message.tree_hash_root()
        expect = bytes(anchor_block.message.state_root)
        got = anchor_state.tree_hash_root()
        if got != expect:
            raise BlockError(
                f"anchor state root {got.hex()} does not match the anchor "
                f"block's {expect.hex()} — refusing untrusted checkpoint")
        chain = cls(store=store, genesis_state=anchor_state,
                    genesis_block_root=anchor_root, preset=preset,
                    spec=spec, T=T, slot_clock=slot_clock)
        store.put_block(anchor_root, anchor_block)
        return chain

    # -- time ----------------------------------------------------------------

    def current_slot(self) -> int:
        if self.slot_clock is not None:
            return self.slot_clock.now()
        return self.fork_choice.current_slot

    def per_slot_task(self, slot: int) -> None:
        """`timer` service hook (`beacon_chain.rs:5322`)."""
        TRACER.set_slot(slot)  # ambient slot scope for this tick's spans
        # Ledger slot boundary: close the previous slot's device-transfer
        # delta (the /lighthouse/device per-slot view, keyed like the
        # trace ring; idempotent when several nodes tick the same slot).
        from ..common.device_ledger import LEDGER
        LEDGER.mark_slot(slot)
        # SLO evaluation rides the timer tick (rate-limited inside) —
        # off the import/verify hot paths by construction.
        self.slo_engine.tick()
        self.fork_choice.on_tick(slot)
        self._drain_slasher(slot)
        self.observed_attesters.prune(slot // self.preset.SLOTS_PER_EPOCH)
        self.observed_block_producers.prune(slot)
        # Sync votes are only read for the previous slot's aggregate.
        self.sync_message_pool.prune(slot - 1)
        # Pending (never-imported) sidecars die with the gossip window —
        # both directions: stale ones behind it AND fabricated far-future
        # headers ahead of it.
        self.data_availability.prune(
            slot - ATTESTATION_PROPAGATION_SLOT_RANGE,
            horizon_slot=slot + ATTESTATION_PROPAGATION_SLOT_RANGE)
        # State-advance timer (`state_advance_timer.rs`): pre-advance the
        # head state to the new slot so the first block/attestation of the
        # slot finds its committees without paying the epoch transition on
        # the hot path.  Epoch boundaries are exactly where the advance is
        # expensive AND where the shuffling changes, so warming it here
        # moves that cost off the gossip deadline.
        if slot > self.head.slot:
            self._advance_and_prime(slot)

    def _advance_and_prime(self, target_slot: int) -> None:
        """Pre-advance the head state to ``target_slot`` (memoised) and
        prime the attester cache for its epoch while the state is hot.

        Reads ``self.head`` ONCE: CanonicalHead is an immutable snapshot,
        so a concurrent head swap (the timer runs on its own thread in
        the real-time node) can at worst waste this advance — it can
        never mix the new head's root with the old head's state."""
        head = self.head
        key = (head.root, target_slot)
        if key in self._advanced_states:
            return
        try:
            advanced = process_slots(head.state.copy(), target_slot,
                                     self.preset, self.spec, self.T)
        except Exception:
            return  # advance failure must never kill the timer tick
        self._bound_advanced_states()
        self._advanced_states[key] = advanced
        self.attester_cache.prime_from_state(head.root, advanced,
                                             self.preset)
        # Duty lookahead rides the same idle-tail advance: proposer +
        # committee duties for the advanced epoch materialize here, so
        # production and the duties endpoints find them without a
        # per-request shuffle (tentpole (c)).
        self._prime_duties(head.root, advanced,
                           target_slot // self.preset.SLOTS_PER_EPOCH)

    def on_three_quarters_slot(self, slot: int) -> None:
        """`state_advance_timer.rs:94-106`: at 3/4 of slot N, pre-advance
        the head state to N+1 and prime the attester cache, so the FIRST
        attestation/block work of N+1 finds committees, source, and
        target without touching a state.  Called by the real-time node's
        slot loop (`cli.py` beacon-node) and the simulator's slot loop;
        tests call it explicitly."""
        if slot + 1 > self.head.slot:
            self._advance_and_prime(slot + 1)

    def attestation_data_parts(self, slot: int):
        """Source checkpoint + target root for an attestation at ``slot``
        on the current head — the CACHED hot path: early-attester cache
        first (a block imported this slot, same epoch), then the attester
        cache (primed by the 3/4-slot timer or a previous call), then one
        cache-filling computation (the only path that copies a state, and
        only when the epoch is AHEAD of the head state's)."""
        spe = self.preset.SLOTS_PER_EPOCH
        epoch = int(slot) // spe
        head_root = self.head.root
        entry = self.early_attester_cache.try_attest(head_root, slot, epoch)
        if entry is None:
            entry = self.attester_cache.get(head_root, epoch)
        if entry is None:
            state = self.head.state
            head_epoch = int(state.slot) // spe
            if epoch == head_epoch:
                self.attester_cache.prime_from_state(head_root, state,
                                                     self.preset)
            elif epoch < head_epoch:
                # Catch-up duty for a PAST epoch: the head state still
                # holds that epoch's boundary root and the justified
                # checkpoint only moves forward — serve without rewind
                # (the pre-cache code path did the same).
                from ..state_transition.helpers import get_block_root
                from .attester_cache import AttesterCacheEntry
                src = state.current_justified_checkpoint
                self.attester_cache.put(head_root, epoch, AttesterCacheEntry(
                    source_epoch=int(src.epoch),
                    source_root=bytes(src.root),
                    target_root=bytes(
                        get_block_root(state, epoch, self.preset))))
            else:
                advanced = self._advanced_states.get((head_root, slot))
                if advanced is None:
                    advanced = process_slots(
                        state.copy(), epoch * spe, self.preset, self.spec,
                        self.T)
                self.attester_cache.prime_from_state(head_root, advanced,
                                                     self.preset)
            entry = self.attester_cache.get(head_root, epoch)
        return entry

    # -- duty caches ---------------------------------------------------------

    DUTY_CACHE_SIZE = 4

    def _prime_duties(self, head_root: bytes, state, epoch: int) -> None:
        """Materialize the (head, epoch) :class:`DutyCache` from an
        already-hot state (best-effort: duty priming must never kill a
        timer tick)."""
        key = (head_root, int(epoch))
        if key in self._duty_caches:
            return
        from ..state_transition.committees import get_committee_cache
        spe = self.preset.SLOTS_PER_EPOCH
        first = int(epoch) * spe
        try:
            cc = get_committee_cache(state, int(epoch), self.preset)
            proposers = [
                get_beacon_proposer_index(state, self.preset, slot=s)
                for s in range(first, first + spe)]
        except Exception as e:  # noqa: BLE001 — must not kill a timer tick
            # Remember WHY so duty_cache can surface the cause — a
            # server-side bug here must not masquerade as a plain
            # out-of-range 400 with no trace of the real failure.
            while len(self._duty_prime_errors) >= self.DUTY_CACHE_SIZE:
                self._duty_prime_errors.pop(
                    next(iter(self._duty_prime_errors)))
            self._duty_prime_errors[key] = repr(e)
            return
        self._duty_prime_errors.pop(key, None)
        while len(self._duty_caches) >= self.DUTY_CACHE_SIZE:
            self._duty_caches.pop(next(iter(self._duty_caches)))
        self._duty_caches[key] = DutyCache(head_root, int(epoch), first,
                                           proposers, cc)

    def duty_cache(self, epoch: int) -> DutyCache:
        """The (current head, ``epoch``) duty cache, built on demand —
        the serving path of ``/eth/v1/validator/duties/*`` and the
        production pipeline's proposer feed.  For a FUTURE epoch the
        build memoises through ``_advanced_states`` (the speculative
        pre-advance usually got there first, making this a lookup)."""
        head = self.head
        key = (head.root, int(epoch))
        hit = self._duty_caches.get(key)
        if hit is not None:
            return hit
        spe = self.preset.SLOTS_PER_EPOCH
        first = int(epoch) * spe
        state = head.state
        now_epoch = max(self.current_slot(), int(head.slot)) // spe
        if int(epoch) > now_epoch + 1:
            # Same amplification gate as the HTTP duties routes — bound
            # by the WALL-CLOCK epoch, not the head's: when the head
            # lags the clock (quiet chain, syncing) current-epoch duties
            # must still be served or the VC never learns it proposes
            # (the head-gated deadlock the route docstring warns about).
            # A lagging head pays one memoized process_slots advance
            # below, not a shuffle per request.
            raise ValueError(
                f"duties unavailable for epoch {epoch}: wall-clock "
                f"epoch {now_epoch} (served: ≤ {now_epoch + 1})")
        if int(state.slot) < first:
            akey = (head.root, first)
            advanced = self._advanced_states.get(akey)
            if advanced is None:
                advanced = process_slots(state.copy(), first, self.preset,
                                         self.spec, self.T)
                self._bound_advanced_states()
                self._advanced_states[akey] = advanced
            state = advanced
        self._prime_duties(head.root, state, int(epoch))
        cache = self._duty_caches.get(key)
        if cache is None:  # prime failed — surface the recorded cause
            cause = self._duty_prime_errors.get(key)
            raise ValueError(
                f"duties unavailable for epoch {epoch} at head slot "
                f"{int(state.slot)}"
                + (f" ({cause})" if cause else ""))
        return cache

    # -- state lookup --------------------------------------------------------

    # Reference DEFAULT_SNAPSHOT_CACHE_SIZE (`snapshot_cache.rs`) — at
    # registry scale each post-state is ~100 MB of columns, so the cache
    # must be bounded; everything else reloads/replays from the store.
    SNAPSHOT_CACHE_SIZE = 4

    def state_at_block_root(self, block_root: bytes):
        """Post-state of an imported block (snapshot cache role,
        `snapshot_cache.rs`), falling back to the store."""
        state = self._states_by_block.get(block_root)
        if state is not None:
            # LRU touch: re-insert at the end so hot fork tips survive.
            self._states_by_block.pop(block_root)
            self._states_by_block[block_root] = state
            return state.copy()
        block = self.store.get_block(block_root)
        if block is None:
            raise BlockError(f"unknown block {block_root.hex()}")
        state = self.store.get_state(bytes(block.message.state_root))
        if state is None:
            raise BlockError("state unavailable for block")
        return state

    def state_for_attestation(self, att):
        """A state able to compute the attestation's committee, resolved
        from the attestation's OWN chain (``beacon_block_root``) — an
        attestation on a non-head fork may have a different shuffling, so
        the head state would verify it against the wrong committee (the
        reference resolves committees from the attestation's target chain,
        ``attestation_verification.rs``).  Memoised per (root, slot) so a
        64-item gossip batch advances once (shuffling/attester cache role);
        bounded to a few entries like the reference's shuffling cache."""
        slot = int(att.data.slot)
        block_root = bytes(att.data.beacon_block_root)
        base = self.head.state if block_root == self.head.root else None
        if base is not None and int(base.slot) >= slot:
            return base
        key = (block_root, slot)
        cached = self._advanced_states.get(key)
        if cached is None:
            src = base if base is not None \
                else self.state_at_block_root(block_root)
            # Bound the advance: this runs on UNVERIFIED gossip input, and
            # an attacker naming an ancient fork block would otherwise buy
            # thousands of slots of state processing per message.  One
            # epoch beyond the propagation window covers every honest
            # shuffling lookup (committees depend on the target epoch).
            max_advance = (ATTESTATION_PROPAGATION_SLOT_RANGE
                           + self.preset.SLOTS_PER_EPOCH)
            if slot - int(src.slot) > max_advance:
                raise BlockError(
                    f"attestation slot {slot} too far beyond its chain's "
                    f"state at {int(src.slot)}")
            cached = (src if int(src.slot) >= slot
                      else process_slots(src.copy(), slot, self.preset,
                                         self.spec, self.T))
            self._bound_advanced_states()
            self._advanced_states[key] = cached
        return cached

    def _bound_advanced_states(self) -> None:
        while len(self._advanced_states) >= 4:
            self._advanced_states.pop(next(iter(self._advanced_states)))

    # -- block import pipeline ----------------------------------------------

    def process_block(self, signed_block, *, is_timely: bool = False,
                      blob_sidecars=None) -> bytes:
        """Full pipeline: gossip → bulk signatures → execution →
        availability gate → fork choice import → persistence → head
        update.  Returns the block root (`beacon_chain.rs:2599` +
        `import_execution_pending_block:2679`).

        ``blob_sidecars`` optionally carries the block's sidecars inline
        (the block-publish path, where proposer and blobs arrive
        together); gossip-delivered sidecars land in
        ``self.data_availability`` beforehand.  A fully-verified Deneb
        block whose commitments lack verified blobs raises
        :class:`~.errors.BlobsUnavailable` and is NOT imported — the
        network layer retries after fetching the blobs.
        """
        t_import = time.perf_counter()
        try:
            out = self._process_block_inner(signed_block, t_import,
                                            is_timely=is_timely,
                                            blob_sidecars=blob_sidecars)
        except BlockError:
            # Peer-protocol rejections (invalid block, unknown parent,
            # blobs pending, repeat proposal) are the NETWORK's fault —
            # normal during sync and under hostile gossip: excluded
            # from BOTH sides of the failure rate, or mesh-duplicate /
            # junk deliveries would dilute the denominator and an
            # import-dead node under hostile gossip would read healthy.
            raise
        except Exception:
            # Infrastructure death (store corruption, wedged device,
            # logic error): THIS is what the import_failure_rate
            # objective drains the node on.
            self._slo_import_attempts += 1
            self._slo_import_failures += 1
            raise
        self._slo_import_attempts += 1
        return out

    def _process_block_inner(self, signed_block, t_import: float, *,
                             is_timely: bool, blob_sidecars) -> bytes:
        with TRACER.span("block_import", cat="block_import",
                         slot=int(signed_block.message.slot)) as _sp:
            g = GossipVerifiedBlock.new(self, signed_block)
            self.block_times_cache.observed(g.block_root)
            if blob_sidecars:
                self.data_availability.put_sidecars(list(blob_sidecars))
            ex = self.data_availability.pop_executed_block(g.block_root)
            if ex is None:
                sv = SignatureVerifiedBlock.from_gossip_verified(self, g)
                ex = ExecutedBlock.from_signature_verified(self, sv)
            # Availability is asserted AFTER full verification (the
            # reference gates between execution and fork-choice import):
            # only blocks whose proposer signature and transition are
            # already proven wait on blobs, so an attacker cannot park
            # junk in the pending map under a real block's root and stall
            # it.  A stalled block is parked; its retry (same root — NOT
            # a repeat proposal) resumes from the executed stage.
            try:
                with TRACER.span("availability_check", cat="da_kzg"):
                    self.data_availability.check_availability(
                        signed_block, g.block_root)
            except BlockError:
                self.data_availability.hold_executed_block(g.block_root,
                                                           ex)
                raise
            self._import_block(ex, is_timely=is_timely)
            # Record-time SLO aggregate: one observation per successful
            # import (chain-local histogram for the block_import
            # objective + the process-global family for /metrics).
            dt = time.perf_counter() - t_import
            self._slo_import_hist.observe(dt)
            observe("block_import_seconds", dt,
                    "block import wall (gossip verify → head update)")
            _sp.set(root=ex.block_root.hex())
            return ex.block_root

    def _import_block(self, ex: ExecutedBlock, *, is_timely: bool) -> None:
        block_root = ex.block_root
        state = ex.post_state
        state_root = bytes(ex.signed_block.message.state_root)
        with TRACER.span("store_put", cat="block_import"):
            # ONE atomic batch per import: block + state/summary + the
            # availability-gate sidecars (served by blob_sidecars_by_
            # range/by_root + the HTTP API) + a journal entry bounding
            # the restart replay window.  A crash anywhere leaves either
            # the whole import or none of it — never a block without its
            # state or a state without its journal record.
            ops = self.store.block_put_ops(block_root, ex.signed_block)
            ops += self.store.state_put_ops(state_root, state.copy(),
                                            block_root)
            for sc in self.data_availability.take_sidecars(block_root):
                ops += self.store.blob_put_ops(block_root, int(sc.index),
                                               sc)
            ops.append(self.store.journal_put_op(
                block_root, int(ex.signed_block.message.slot),
                bytes(ex.signed_block.message.parent_root)))
            self.store.do_atomically(ops)
            TRACER.record_stages("store")
        with TRACER.span("fork_choice_on_block", cat="fork_choice"):
            self.fork_choice.on_block(ex.signed_block, block_root, state,
                                      is_timely=is_timely)
        self._states_by_block[block_root] = state
        self.block_times_cache.imported(block_root)
        # Prime the attester caches from the post-state we already hold:
        # attestations for THIS block can be produced before any head
        # recompute or state lookup (`early_attester_cache.rs`).
        with TRACER.span("attester_cache_prime", cat="block_import"):
            self.attester_cache.prime_from_state(block_root, state,
                                                 self.preset)
            blk_epoch = int(state.slot) // self.preset.SLOTS_PER_EPOCH
            entry = self.attester_cache.get(block_root, blk_epoch)
            if entry is not None:
                self.early_attester_cache.add(
                    block_root, int(ex.signed_block.message.slot),
                    blk_epoch, entry)
        # Feed block attestations to fork choice (`beacon_chain.rs:
        # apply_attestation_to_fork_choice` via import).
        with TRACER.span("fork_choice_attestations", cat="fork_choice"):
            resolved = self._feed_block_attestations(ex.signed_block, state)
        if self.validator_monitor is not None:
            self.validator_monitor.process_block(
                ex.signed_block.message, resolved, state)
        self.event_bus.publish("block", {
            "slot": str(int(ex.signed_block.message.slot)),
            "block": "0x" + block_root.hex()})
        self.recompute_head()
        # Bound the snapshot cache (weak #10: between finalizations this
        # otherwise held EVERY post-state — up to 2 epochs × ~100 MB at
        # registry scale).  Evicted states remain loadable from the store.
        survivors = list(self._states_by_block)
        for root in survivors[:-self.SNAPSHOT_CACHE_SIZE]:
            if root != self.head.root:
                del self._states_by_block[root]
        # Finalization housekeeping: prune pool + migrate store.
        fin_epoch, fin_root = self.fork_choice.finalized_checkpoint
        if fin_root != b"\x00" * 32 and self.fork_choice.contains_block(fin_root):
            fin_slot = self.fork_choice.block_slot(fin_root)
            with TRACER.span("migrate_to_cold", cat="store"):
                self.store.migrate_to_cold(fin_slot, fin_root)
            for root in [r for r, s in self._states_by_block.items()
                         if int(s.slot) < fin_slot - 1]:
                del self._states_by_block[root]
        # Fork-choice/op-pool snapshots persist on EVERY finalization
        # advance (not only at shutdown): the crash-replay window is
        # bounded to the imports since the last finalized checkpoint.
        if self.fork_choice.finalized_checkpoint != \
                getattr(self, "_persisted_finalized", None):
            self._persisted_finalized = self.fork_choice.finalized_checkpoint
            with TRACER.span("persist", cat="store"):
                self.persist()
        self.op_pool.prune(state)

    def _feed_block_attestations(self, signed_block, state) -> List:
        """Apply a block's carried attestations to fork choice (and the
        slasher) — shared by the import pipeline and the restart
        recovery replay, so a replayed block has exactly the
        fork-choice-visible effects of its original import."""
        from .attestation_verification import attesting_indices
        resolved = []
        for att in signed_block.message.body.attestations:
            try:
                idx, _committee = attesting_indices(state, att, self.preset)
                resolved.append((int(att.data.slot), idx.tolist()))
                indexed = _Indexed(att.data, idx.tolist())
                # Slasher BEFORE fork choice: an attestation naming an
                # unknown head block (orphaned branch — the very shape a
                # double vote takes) raises below, and must still be
                # ingested for detection.
                if self.slasher is not None:
                    self.slasher.accept_attestation(indexed)
                self.fork_choice.on_attestation(indexed,
                                                is_from_block=True)
            except Exception:
                pass  # block attestations are best-effort for fork choice
        return resolved

    def _replay_imported_block(self, signed_block, block_root: bytes,
                               state) -> None:
        """Restart-recovery replay of one journaled import
        (:func:`..store.recovery.reconcile`): re-run the fork-choice
        effects of `_import_block` from the store's copy of the block
        and its post-state."""
        self.fork_choice.on_block(signed_block, block_root, state)
        self._feed_block_attestations(signed_block, state)

    # -- slasher seam --------------------------------------------------------

    def attach_slasher(self, slasher) -> None:
        """Attach a slasher (``lighthouse_tpu.slasher.Slasher``): verified
        attestations stream into its ingest queue, and the per-slot task
        drains detected offences into fork choice — each double-vote's
        equivocating indices land in the vote buffer and are zeroed in
        the next batched delta pass (host ``on_attester_slashing``
        semantics)."""
        self.slasher = slasher

    def _drain_slasher(self, slot: int) -> None:
        if self.slasher is None:
            return
        epoch = slot // self.preset.SLOTS_PER_EPOCH
        try:
            detections = self.slasher.process_queued(epoch)
        except Exception:
            return  # detection is best-effort; never kills the slot timer
        for det in detections:
            # Slashing carries the two conflicting indexed attestations —
            # exactly the on_attester_slashing shape (intersection of
            # attesting indices loses fork-choice weight forever).
            try:
                self.fork_choice.on_attester_slashing(det)
            except Exception:
                pass

    # -- EL invalidation (optimistic-sync revert) ----------------------------

    def on_invalid_execution_payload(self, block_root: bytes) -> None:
        """The execution layer reported INVALID for an optimistically
        imported payload: invalidate the block and all its descendants in
        fork choice, re-compute the head off the poisoned branch, and
        re-pack the op pool against the reverted head state
        (`beacon_chain.rs process_invalid_execution_payload`)."""
        if not self.fork_choice.contains_block(block_root):
            return
        old_head = self.head.root
        self.fork_choice.on_invalid_execution_payload(block_root)
        new_head = self.recompute_head()
        if new_head != old_head:
            # Op-pool re-pack: attestations/ops packed for the abandoned
            # branch re-validate against the reverted head's state (stale
            # ones drop; survivors re-enter the greedy packer's universe).
            self.op_pool.prune(self.head.state)
            self.event_bus.publish("payload_invalidated", {
                "block": "0x" + bytes(block_root).hex(),
                "new_head": "0x" + new_head.hex()})

    def recompute_head(self) -> bytes:
        """`recompute_head` (`canonical_head.rs`)."""
        with TRACER.span("head_update", cat="head") as _sp:
            return self._recompute_head(_sp)

    def _recompute_head(self, _sp) -> bytes:
        head_root = self.fork_choice.get_head()
        _sp.set(head=head_root.hex(), changed=head_root != self.head.root)
        if head_root != self.head.root:
            state = self.state_at_block_root(head_root)
            self.head = CanonicalHead(root=head_root,
                                      slot=int(state.slot), state=state)
            self.block_times_cache.set_as_head(head_root)
            # The post-block state's own latest_block_header.state_root is
            # ZEROED until the next slot; the advertised root comes from
            # the head block itself.
            blk = self.store.get_block(head_root)
            state_root = (bytes(blk.message.state_root) if blk is not None
                          else self.genesis_state_root)
            self.event_bus.publish("head", {
                "slot": str(self.head.slot),
                "block": "0x" + head_root.hex(),
                "state": "0x" + state_root.hex()})
            fin = self.fork_choice.finalized_checkpoint
            if fin[1] != b"\x00" * 32 \
                    and fin != getattr(self, "_last_finalized_event", None):
                self._last_finalized_event = fin
                self.event_bus.publish("finalized_checkpoint", {
                    "epoch": str(fin[0]),
                    "block": "0x" + fin[1].hex()})
        return self.head.root

    # -- attestations --------------------------------------------------------

    def register_verified_attestation(self, verified) -> None:
        """Post-verification import — fork choice + op pool + event
        stream.  The tail of :meth:`process_attestation_batch`, shared
        with the streaming verification service's completion callback."""
        indexed = _Indexed(verified.attestation.data,
                           [int(i) for i in verified.indexed_indices])
        try:
            self.fork_choice.on_attestation(indexed)
        except Exception:
            pass
        if self.slasher is not None:
            self.slasher.accept_attestation(indexed)
        self.op_pool.insert_attestation(verified.attestation,
                                        verified.committee)
        self.event_bus.publish("attestation", {
            "slot": str(int(verified.attestation.data.slot)),
            "index": str(int(verified.attestation.data.index))})

    def process_attestation_batch(self, attestations: List) -> List:
        """Gossip batch → one device verify → fork choice + op pool
        (`attestation_verification/batch.rs` + `beacon_chain.rs:1858`).
        Synchronous: the VC / HTTP-API submission path."""
        results = batch_verify_attestations(self, attestations)
        for verified, err in results:
            if verified is not None:
                self.register_verified_attestation(verified)
        return results

    def stream_attestation_batch(self, attestations: List,
                                 kind: str = "attestation"):
        """Gossip-path entry.  The streaming verification service is not
        ported, so the batch takes the synchronous path of
        :meth:`process_attestation_batch` (``kind`` is the shedding class
        the service would read)."""
        return self.process_attestation_batch(attestations)

    # -- production ----------------------------------------------------------

    def produce_block_components(self, slot: int, randao_reveal: bytes,
                                 graffiti: bytes = b"") -> object:
        """Adopt the pre-advanced state when the head it was built on is
        still the head, else advance serially
        (`state_advance_timer.rs:94-106` — the pre-advance is only usable
        if no block landed in between).  The head is read ONCE so the
        adoption check and the parent root cannot race a concurrent head
        swap.  Either state goes to :meth:`produce_block_on_state` as it
        is, which makes production's one private copy: the cached advance
        and the head's state stay as they were, whatever production
        writes."""
        head = self.head
        state = None
        if int(head.state.slot) < slot:
            adv = self._advanced_states.get((head.root, slot))
            if adv is not None and int(adv.slot) == slot:
                state = adv
        if state is not None:
            self._produce_adopted += 1
        else:
            state = head.state
            self._produce_serial += 1
        return self.produce_block_on_state(state, slot, randao_reveal,
                                           graffiti, _head_root=head.root)

    def note_block_production(self, seconds: float) -> None:
        """Feed one end-to-end block-production latency into the local
        SLO histogram (drives the ``block_production_ms`` objective)."""
        self._slo_production_hist.observe(seconds)
        observe("block_production_seconds", seconds)

    def _proposer_for(self, slot: int, state, head_root: bytes = None) -> int:
        """Proposer index for ``slot`` — the duty cache when the lookahead
        primed it, shuffle-on-demand otherwise."""
        if head_root is not None:
            cache = self._duty_caches.get(
                (head_root, slot // self.preset.SLOTS_PER_EPOCH))
            if cache is not None:
                return cache.proposer_at(slot)
        return get_beacon_proposer_index(state, self.preset, slot=slot)

    def produce_block_on_state(self, state, slot: int, randao_reveal: bytes,
                               graffiti: bytes = b"",
                               _head_root: bytes = None) -> object:
        """Assemble an unsigned block's parts from the op pool
        (`produce_block_on_state`, `beacon_chain.rs:4133`).  ``state`` is
        never written: the parts' ``state`` is a private copy of it at
        ``slot``, which the caller may apply the block to.  The copy
        shares the device-resident columns copy-on-write but copies each
        host master (tens of ms at 2^20 validators); its time and the
        slot advance's land in the ``production`` stage source."""
        t0 = time.perf_counter()
        state = state.copy()
        t1 = time.perf_counter()
        if int(state.slot) < slot:
            state = process_slots(state, slot, self.preset, self.spec,
                                  self.T)
        LAST_PRODUCTION_TIMINGS.clear()
        LAST_PRODUCTION_TIMINGS.update(
            copy_ms=round((t1 - t0) * 1e3, 3),
            advance_ms=round((time.perf_counter() - t1) * 1e3, 3))
        proposer = self._proposer_for(slot, state, _head_root)
        atts = self.op_pool.get_attestations(state, self.T)
        proposer_slashings, attester_slashings, exits = \
            self.op_pool.get_slashings_and_exits(state)
        changes = self.op_pool.get_bls_to_execution_changes(state)
        return dict(
            slot=slot, proposer_index=proposer,
            parent_root=_head_root if _head_root is not None
            else self.head.root,
            attestations=atts,
            proposer_slashings=proposer_slashings,
            attester_slashings=attester_slashings,
            voluntary_exits=exits,
            bls_to_execution_changes=changes,
            randao_reveal=randao_reveal,
            graffiti=graffiti,
            state=state,
        )


class _Indexed:
    def __init__(self, data, indices):
        self.data = data
        self.attesting_indices = indices
