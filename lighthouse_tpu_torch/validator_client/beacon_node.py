"""Beacon-node handles for the validator client.

Port of ``lighthouse_tpu/validator_client/beacon_node.py``.
``InProcessBeaconNode`` adapts a :class:`~..beacon_chain.BeaconChain` to
the duty/production/publish API the services consume (the ``common/eth2``
typed HTTP client's role, minus the wire);
``BeaconNodeFallback`` is the multi-node redundancy router
(``validator_client/src/beacon_node_fallback.rs:317,465`` —
``first_success`` over healthy nodes)."""

from __future__ import annotations

import hashlib
import time
from dataclasses import dataclass
from typing import Callable, List, Optional, Sequence

from ..common.tracing import TRACER
from ..state_transition.helpers import (
    current_epoch,
    get_randao_mix,
)
from ..state_transition.per_block import get_expected_withdrawals
from ..types.chain_spec import ForkName


@dataclass
class ProposerDuty:
    slot: int
    validator_index: int


@dataclass
class AttesterDuty:
    slot: int
    committee_index: int
    committee_position: int
    committee_length: int
    validator_index: int


class BeaconNodeError(RuntimeError):
    pass


class InProcessBeaconNode:
    """Direct-object beacon node (node_test_rig style)."""

    def __init__(self, chain):
        self.chain = chain
        self.healthy = True

    # -- info ----------------------------------------------------------------

    def head_root(self) -> bytes:
        return self.chain.head.root

    def genesis_validators_root(self) -> bytes:
        return bytes(self.chain.head.state.genesis_validators_root)

    # -- duties --------------------------------------------------------------

    def proposer_duties(self, epoch: int) -> List[ProposerDuty]:
        """`DutiesService` proposer poll (`duties_service.rs`) — served
        from the chain's pre-materialized duty cache; the lookahead
        usually primed it during the slot tail, so this is a list read,
        not an epoch of shuffles."""
        preset = self.chain.preset
        cache = self.chain.duty_cache(epoch)
        first = epoch * preset.SLOTS_PER_EPOCH
        return [ProposerDuty(first + k, cache.proposers[k])
                for k in range(preset.SLOTS_PER_EPOCH)]

    def attester_duties(self, epoch: int,
                        indices: Sequence[int]) -> List[AttesterDuty]:
        cache = self.chain.duty_cache(epoch)
        n = len(self.chain.head.state.validators)
        out = []
        for vi in indices:
            duty = cache.attester_duty(int(vi), n)
            if duty is not None:
                slot, ci, pos, length = duty
                out.append(AttesterDuty(slot, ci, pos, length, int(vi)))
        return out

    def liveness(self, epoch: int, indices: Sequence[int]) -> List[bool]:
        """Doppelganger probe: was the validator seen attesting this
        epoch? (`/lighthouse/liveness` endpoint role)."""
        seen = self.chain.observed_attesters
        return [seen.has_attested(epoch, int(i)) for i in indices]

    # -- attestation data ----------------------------------------------------

    def attestation_data(self, slot: int, committee_index: int):
        """`produce_unaggregated_attestation` (`beacon_chain.rs`) via the
        attester caches — NO state copy or slot advance on the hot path
        (`attester_cache.rs` / `early_attester_cache.rs`; primed by the
        3/4-slot timer and at block import)."""
        chain = self.chain
        epoch = slot // chain.preset.SLOTS_PER_EPOCH
        entry = chain.attestation_data_parts(slot)
        T = chain.T
        return T.AttestationData(
            slot=slot, index=committee_index,
            beacon_block_root=chain.head.root,
            source=T.Checkpoint(epoch=entry.source_epoch,
                                root=entry.source_root),
            target=T.Checkpoint(epoch=epoch, root=entry.target_root))

    # -- production ----------------------------------------------------------

    def produce_block(self, slot: int, randao_reveal: bytes,
                      graffiti: bytes = b"\x00" * 32):
        """Unsigned block assembly from the pool + mock payload
        (`produce_block_on_state`, `beacon_chain.rs:4133`; payload via the
        MockExecutionLayer-style generator).  The hot path is
        `produce_block_components`: adopt the pre-advanced state → pack
        the pool → assemble; the whole assembly is timed into the
        ``block_production_ms`` SLO.  Spans: ``block_production`` around
        it, ``produce_components``, ``produce_scratch_block`` (the scratch
        ``process_block``) and ``produce_state_root``."""
        chain = self.chain
        preset, spec, T = chain.preset, chain.spec, chain.T
        t0 = time.perf_counter()
        with TRACER.span("block_production", cat="production"):
            with TRACER.span("produce_components", cat="production"):
                parts = chain.produce_block_components(slot, randao_reveal,
                                                       graffiti)
            state = parts["state"]
            fork = spec.fork_name_at_epoch(slot // preset.SLOTS_PER_EPOCH)
            body_kw = dict(
                randao_reveal=randao_reveal,
                eth1_data=state.eth1_data,
                graffiti=graffiti.ljust(32, b"\x00"),
                proposer_slashings=parts["proposer_slashings"],
                attester_slashings=parts["attester_slashings"],
                attestations=parts["attestations"],
                deposits=[],
                voluntary_exits=parts["voluntary_exits"],
            )
            if fork >= ForkName.ALTAIR:
                # Real aggregate from the naive sync-message pool: the
                # block at slot N carries votes for the parent root signed
                # at slot N-1 (`process_sync_aggregate` previous-slot
                # semantics).
                body_kw["sync_aggregate"] = \
                    chain.sync_message_pool.aggregate(slot - 1,
                                                      chain.head.root, T)
            if fork >= ForkName.BELLATRIX:
                body_kw["execution_payload"] = self._payload(state, fork)
            if fork >= ForkName.CAPELLA:
                body_kw["bls_to_execution_changes"] = parts[
                    "bls_to_execution_changes"]
            body = T.body_cls(fork)(**body_kw)
            block = T.block_cls(fork)(
                slot=slot, proposer_index=parts["proposer_index"],
                parent_root=parts["parent_root"], state_root=b"\x00" * 32,
                body=body)
            # Fill the state root (NoVerification scratch application on
            # the parts' state, a private copy nothing reads after this).
            from ..state_transition.per_block import (
                SignatureStrategy, process_block)
            dummy = T.signed_block_cls(fork)(
                message=block, signature=b"\xc0" + b"\x00" * 95)
            with TRACER.span("produce_scratch_block", cat="production"):
                process_block(state, dummy, fork, preset, spec, T,
                              strategy=SignatureStrategy.NO_VERIFICATION)
            with TRACER.span("produce_state_root", cat="production"):
                block.state_root = state.tree_hash_root()
        chain.note_block_production(time.perf_counter() - t0)
        return block

    def _payload(self, state, fork: ForkName):
        T, preset, spec = self.chain.T, self.chain.preset, self.chain.spec
        parent_hash = bytes(state.latest_execution_payload_header.block_hash)
        kw = dict(
            parent_hash=parent_hash,
            prev_randao=get_randao_mix(
                state, current_epoch(state, preset), preset),
            block_number=int(
                state.latest_execution_payload_header.block_number) + 1,
            gas_limit=30_000_000,
            timestamp=int(state.genesis_time)
            + int(state.slot) * spec.seconds_per_slot,
            block_hash=hashlib.sha256(
                parent_hash + int(state.slot).to_bytes(8, "little")).digest(),
        )
        if fork >= ForkName.CAPELLA:
            kw["withdrawals"] = [
                T.Withdrawal(index=w[0], validator_index=w[1], address=w[2],
                             amount=w[3])
                for w in get_expected_withdrawals(state, preset)]
        return T.payload_cls(fork)(**kw)

    # -- publication ---------------------------------------------------------

    def publish_block(self, signed_block) -> bytes:
        self.chain.per_slot_task(int(signed_block.message.slot))
        return self.chain.process_block(signed_block, is_timely=True)

    def submit_attestations(self, atts: List) -> None:
        self.chain.process_attestation_batch(atts)

    # -- sync committee ------------------------------------------------------

    def _pk_to_index(self, reg) -> dict:
        """pubkey → validator index, maintained incrementally (the
        registry only grows and pubkeys are immutable once set — the
        `ValidatorPubkeyCache` role; rebuilding per slot would walk the
        whole 1M-entry registry inside the slot budget)."""
        cache = getattr(self, "_pk_index_cache", None)
        if cache is None:
            cache = self._pk_index_cache = [0, {}]
        n, table = cache
        if n < len(reg):
            pk = reg.pubkey
            for i in range(n, len(reg)):
                table[pk[i].tobytes()] = i
            cache[0] = len(reg)
        return table

    def sync_committee_positions(self, indices: Sequence[int]
                                 ) -> dict[int, list[int]]:
        """validator index → committee positions in the CURRENT sync
        committee (`/eth2/v1/validator/duties/sync` role)."""
        state = self.chain.head.state
        if not hasattr(state, "current_sync_committee"):
            return {}
        pk_to_index = self._pk_to_index(state.validators)
        out: dict[int, list[int]] = {}
        wanted = set(int(i) for i in indices)
        for pos, pk in enumerate(state.current_sync_committee.pubkeys):
            vi = pk_to_index.get(bytes(pk))
            if vi is not None and vi in wanted:
                out.setdefault(vi, []).append(pos)
        return out

    def submit_sync_messages(self, slot: int, block_root: bytes,
                             items: List) -> None:
        """items: (positions, signature) per validator — naive-aggregated
        for the next block's SyncAggregate."""
        for positions, sig in items:
            self.chain.sync_message_pool.insert(slot, block_root,
                                                positions, sig)

    # -- preparation ---------------------------------------------------------

    def prepare_proposers(self, preparations: List) -> None:
        """(validator_index, fee_recipient) registrations
        (`preparation_service.rs` → `prepare_beacon_proposer`)."""
        store = getattr(self.chain, "proposer_preparations", None)
        if store is None:
            store = self.chain.proposer_preparations = {}
        for idx, fee_recipient in preparations:
            store[int(idx)] = bytes(fee_recipient)


class BeaconNodeFallback:
    """`first_success` routing over candidate nodes."""

    def __init__(self, nodes: List):
        self.nodes = list(nodes)

    def first_success(self, fn: Callable):
        last_err: Optional[Exception] = None
        for node in self.nodes:
            if not getattr(node, "healthy", True):
                continue
            try:
                return fn(node)
            except Exception as e:  # noqa: BLE001 — try the next node
                last_err = e
        raise BeaconNodeError(
            f"all beacon nodes failed: {last_err}") from last_err
