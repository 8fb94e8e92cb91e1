"""Spec-level fork choice over the proto-array
(``consensus/fork_choice/src/fork_choice.rs``).

``ForkChoice`` binds the proto-array to consensus types: blocks arrive with
their post-states (``on_block`` — ``fork_choice.rs:748``), attestations
arrive indexed (``on_attestation`` — ``:1165``), and ``get_head``
(``:528``) replays queued votes into deltas and runs the two-pass score
update.  Justified balances come from the justified state's effective
balances (active validators only), as one numpy mask-select over the SoA
registry columns.
"""

from __future__ import annotations

from dataclasses import dataclass
import numpy as np

from ..common.tracing import TRACER
from .device_proto_array import DeviceProtoArrayForkChoice
from .proto_array import (
    EXEC_IRRELEVANT,
    EXEC_OPTIMISTIC,
    ProtoArrayError,
    ZERO_ROOT,
)


class ForkChoiceError(ValueError):
    pass


@dataclass
class QueuedAttestation:
    """Attestations for the current slot wait one slot before counting
    (`fork_choice.rs` QueuedAttestation)."""
    slot: int
    indices: np.ndarray
    block_root: bytes
    target_epoch: int


def _active_balances(state, epoch: int) -> np.ndarray:
    reg = state.validators
    active = ((reg.col("activation_epoch") <= epoch)
              & (epoch < reg.col("exit_epoch")))
    out = np.where(active, reg.col("effective_balance"), 0).astype(np.uint64)
    return out


class ForkChoice:
    """`ForkChoice` (`fork_choice.rs:244`), single-process flavour."""

    def __init__(self, preset, spec, *, genesis_root: bytes,
                 genesis_state, current_slot: int = 0):
        self.preset = preset
        self.spec = spec
        self.proto = DeviceProtoArrayForkChoice()
        self.queued: list[QueuedAttestation] = []
        self.justified_state = genesis_state
        jcp = (int(genesis_state.current_justified_checkpoint.epoch),
               bytes(genesis_state.current_justified_checkpoint.root))
        fcp = (int(genesis_state.finalized_checkpoint.epoch),
               bytes(genesis_state.finalized_checkpoint.root))
        # Genesis anchor: checkpoints root to the anchor block itself.
        self.justified_checkpoint = (jcp[0], genesis_root)
        self.finalized_checkpoint = (fcp[0], genesis_root)
        self.proposer_boost_root = ZERO_ROOT
        self.current_slot = current_slot
        self.proto.on_block(
            slot=int(genesis_state.slot), root=genesis_root,
            parent_root=ZERO_ROOT,
            state_root=bytes(genesis_state.latest_block_header.state_root),
            justified_epoch=self.justified_checkpoint[0],
            justified_root=genesis_root,
            finalized_epoch=self.finalized_checkpoint[0],
            finalized_root=genesis_root,
            execution_status=EXEC_IRRELEVANT)

    # -- time ----------------------------------------------------------------

    def on_tick(self, slot: int) -> None:
        """Slot rollover: reset the proposer boost (`fork_choice.rs:
        update_time/on_tick`)."""
        if slot > self.current_slot:
            self.current_slot = slot
            self.proposer_boost_root = ZERO_ROOT

    # -- block import --------------------------------------------------------

    def on_block(self, signed_block, block_root: bytes, state,
                 *, is_timely: bool = False,
                 execution_status: int = EXEC_IRRELEVANT,
                 execution_block_hash: bytes = None) -> None:
        """`fork_choice.rs:748`; ``state`` is the block's post-state.

        A block carrying a live execution payload imports OPTIMISTICALLY
        by default (`fork_choice.rs` payload_verification_status): the
        payload is only proven by the EL, so `on_invalid_execution_payload`
        must be able to revert it later; pre-merge blocks stay IRRELEVANT.
        """
        block = signed_block.message
        if int(block.slot) > self.current_slot:
            self.current_slot = int(block.slot)
        if execution_status == EXEC_IRRELEVANT:
            payload = getattr(block.body, "execution_payload", None)
            if payload is not None \
                    and bytes(payload.block_hash) != ZERO_ROOT:
                execution_status = EXEC_OPTIMISTIC
                execution_block_hash = bytes(payload.block_hash)
        jcp = (int(state.current_justified_checkpoint.epoch),
               bytes(state.current_justified_checkpoint.root))
        fcp = (int(state.finalized_checkpoint.epoch),
               bytes(state.finalized_checkpoint.root))
        if jcp[0] > self.justified_checkpoint[0]:
            self.justified_checkpoint = jcp
            self.justified_state = state
        if fcp[0] > self.finalized_checkpoint[0]:
            self.finalized_checkpoint = fcp
            self.proto.maybe_prune(fcp[1])
        if is_timely and self.proposer_boost_root == ZERO_ROOT:
            self.proposer_boost_root = block_root
        self.proto.on_block(
            slot=int(block.slot), root=block_root,
            parent_root=bytes(block.parent_root),
            state_root=bytes(block.state_root),
            justified_epoch=jcp[0], justified_root=jcp[1],
            finalized_epoch=fcp[0], finalized_root=fcp[1],
            execution_status=execution_status,
            execution_block_hash=execution_block_hash)

    # -- attestations --------------------------------------------------------

    def on_attestation(self, indexed_attestation, *,
                       is_from_block: bool = False) -> None:
        """`fork_choice.rs:1165` — validate + queue the latest messages."""
        data = indexed_attestation.data
        target_epoch = int(data.target.epoch)
        block_root = bytes(data.beacon_block_root)
        if block_root not in self.proto.indices:
            raise ForkChoiceError("unknown attestation head block")
        if self.proto.slot_of(block_root) > int(data.slot):
            raise ForkChoiceError("attestation to a future block")
        indices = np.asarray(list(indexed_attestation.attesting_indices),
                             dtype=np.int64)
        self.queued.append(QueuedAttestation(
            slot=int(data.slot), indices=indices, block_root=block_root,
            target_epoch=target_epoch))

    def on_attester_slashing(self, attester_slashing) -> None:
        """Equivocating validators lose fork-choice weight forever
        (`fork_choice.rs` on_attester_slashing)."""
        a = set(int(i) for i in attester_slashing.attestation_1.attesting_indices)
        b = set(int(i) for i in attester_slashing.attestation_2.attesting_indices)
        for idx in a & b:
            self.proto.process_equivocation(idx)

    def _drain_queued(self) -> None:
        """Votes only count from the slot after they were cast
        (`queued_attestations`, `fork_choice.rs:300-330`).  The whole
        slot's due attestations apply as ONE batch — attestations whose
        block was pruned between queue and drain drop atomically (the
        host raised before any mutation for those, so filtering first is
        bit-identical)."""
        queued = self.queued  # snapshot: appends race with drain (as
        # before this was batched); one list is partitioned exactly once
        due = [q for q in queued if q.slot < self.current_slot]
        if not due:
            return
        self.queued = [q for q in queued if q.slot >= self.current_slot]
        batch = [(q.indices, q.block_root, q.target_epoch)
                 for q in due if q.block_root in self.proto.indices]
        if batch:
            self.proto.process_attestation_batch(batch)

    # -- head ----------------------------------------------------------------

    def get_head(self) -> bytes:
        """`fork_choice.rs:528` → `proto_array.find_head`."""
        with TRACER.span("fork_choice_apply", cat="fork_choice",
                         nodes=len(self.proto.indices)) as _sp:
            with TRACER.span("drain_votes", cat="fork_choice",
                             queued=len(self.queued)):
                self._drain_queued()
            # Justified balances: active validators AT the justified
            # epoch, from the justified state
            # (`JustifiedBalances::from_justified_state`).
            balances = _active_balances(self.justified_state,
                                        self.justified_checkpoint[0])
            with TRACER.span("compute_deltas", cat="fork_choice"):
                deltas = self.proto.compute_deltas(balances)
            boost_score = 0
            if self.proposer_boost_root != ZERO_ROOT:
                committee_weight = (int(balances.sum())
                                    // self.preset.SLOTS_PER_EPOCH)
                boost_score = (committee_weight
                               * self.spec.proposer_score_boost // 100)
            with TRACER.span("apply_scores", cat="fork_choice"):
                self.proto.apply_score_changes(
                    deltas, self.justified_checkpoint,
                    self.finalized_checkpoint,
                    self.proposer_boost_root, boost_score,
                    self.current_slot)
            with TRACER.span("find_head", cat="fork_choice"):
                head = self.proto.find_head(self.justified_checkpoint[1],
                                            self.current_slot)
            _sp.set(head=head.hex())
            return head

    # -- optimistic sync hooks ----------------------------------------------

    def on_valid_execution_payload(self, root: bytes) -> None:
        self.proto.on_valid_execution_payload(root)

    def on_invalid_execution_payload(self, root: bytes) -> None:
        self.proto.on_invalid_execution_payload(root)

    def contains_block(self, root: bytes) -> bool:
        return root in self.proto.indices

    def block_slot(self, root: bytes) -> int:
        """Slot of a known block (works on both proto-array flavours)."""
        return self.proto.slot_of(root)
