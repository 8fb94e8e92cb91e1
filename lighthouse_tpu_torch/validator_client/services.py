"""Validator services — the per-slot machinery of
``ProductionValidatorClient::start_service``
(``validator_client/src/lib.rs:88-520``; port of
``lighthouse_tpu/validator_client/services.py``):

- :class:`DutiesService` — polls proposer/attester duties per epoch
  (``duties_service.rs``);
- :class:`BlockService` — randao sign → produce via BN → sign (slashing
  protected) → publish (``block_service.rs``);
- :class:`AttestationService` — attest at the duty slot
  (``attestation_service.rs``);
- :class:`DoppelgangerService` — refuse to sign for two epochs while
  watching liveness for our keys (``doppelganger_service.rs:253,421``);
- :class:`ValidatorClient` — wires them over a
  :class:`~.beacon_node.BeaconNodeFallback`.
"""

from __future__ import annotations

from typing import Dict, List, Optional

from ..common.logging import Logger, test_logger
from .beacon_node import AttesterDuty, BeaconNodeFallback, ProposerDuty
from .store import ValidatorStore


class DutiesService:
    def __init__(self, store: ValidatorStore, fallback: BeaconNodeFallback,
                 preset):
        self.store = store
        self.fallback = fallback
        self.preset = preset
        self.proposers: Dict[int, List[ProposerDuty]] = {}
        self.attesters: Dict[int, List[AttesterDuty]] = {}

    def poll(self, epoch: int) -> None:
        ours = set(self.store.indices())
        props = self.fallback.first_success(
            lambda bn: bn.proposer_duties(epoch))
        self.proposers[epoch] = [d for d in props
                                 if d.validator_index in ours]
        self.attesters[epoch] = self.fallback.first_success(
            lambda bn: bn.attester_duties(epoch, sorted(ours)))

    def proposer_at(self, slot: int) -> Optional[ProposerDuty]:
        epoch = slot // self.preset.SLOTS_PER_EPOCH
        for d in self.proposers.get(epoch, []):
            if d.slot == slot:
                return d
        return None

    def attesters_at(self, slot: int) -> List[AttesterDuty]:
        epoch = slot // self.preset.SLOTS_PER_EPOCH
        return [d for d in self.attesters.get(epoch, []) if d.slot == slot]


class BlockService:
    def __init__(self, store: ValidatorStore, duties: DutiesService,
                 fallback: BeaconNodeFallback, preset, log: Logger):
        self.store = store
        self.duties = duties
        self.fallback = fallback
        self.preset = preset
        self.log = log.child("block_service")

    def on_slot(self, slot: int) -> Optional[bytes]:
        duty = self.duties.proposer_at(slot)
        if duty is None:
            return None
        pk = next((p for p, i in self.store.index_by_pubkey.items()
                   if i == duty.validator_index), None)
        if pk is None or pk in self.store.doppelganger_blocked:
            return None  # doppelganger watch: don't attempt signing
        epoch = slot // self.preset.SLOTS_PER_EPOCH

        def produce(bn):
            state = bn.chain.head.state
            reveal = self.store.sign_randao(pk, epoch, state, self.preset)
            block = bn.produce_block(slot, reveal)
            sig = self.store.sign_block(pk, block, state, self.preset)
            T = bn.chain.T
            fork = bn.chain.spec.fork_name_at_epoch(epoch)
            signed = T.signed_block_cls(fork)(message=block, signature=sig)
            return bn.publish_block(signed)

        root = self.fallback.first_success(produce)
        self.log.info("block proposed", slot=slot,
                      validator=duty.validator_index)
        return root


class AttestationService:
    def __init__(self, store: ValidatorStore, duties: DutiesService,
                 fallback: BeaconNodeFallback, preset, log: Logger):
        self.store = store
        self.duties = duties
        self.fallback = fallback
        self.preset = preset
        self.log = log.child("attestation_service")

    def on_slot(self, slot: int) -> int:
        duties = self.duties.attesters_at(slot)
        if not duties:
            return 0

        def attest(bn):
            atts = []
            for duty in duties:
                pk = next((p for p, i in self.store.index_by_pubkey.items()
                           if i == duty.validator_index), None)
                if pk is None or pk in self.store.doppelganger_blocked:
                    continue
                data = bn.attestation_data(slot, duty.committee_index)
                sig = self.store.sign_attestation(
                    pk, data, bn.chain.head.state, self.preset)
                bits = [False] * duty.committee_length
                bits[duty.committee_position] = True
                T = bn.chain.T
                atts.append(T.Attestation(
                    aggregation_bits=bits, data=data, signature=sig))
            bn.submit_attestations(atts)
            return len(atts)

        n = self.fallback.first_success(attest)
        self.log.debug("attested", slot=slot, count=n)
        return n


class SyncCommitteeService:
    """Per-slot sync-committee signing (`sync_committee_service.rs`): each
    member signs the current head root; the BN naive-aggregates into the
    next block's SyncAggregate."""

    def __init__(self, store: ValidatorStore, fallback: BeaconNodeFallback,
                 preset, log: Logger):
        self.store = store
        self.fallback = fallback
        self.preset = preset
        self.log = log.child("sync_committee_service")

    def on_slot(self, slot: int) -> int:
        def run(bn):
            duties = bn.sync_committee_positions(self.store.indices())
            if not duties:
                return 0
            head_root = bn.chain.head.root
            state = bn.chain.head.state
            items = []
            for vi, positions in duties.items():
                pk = next((p for p, i in self.store.index_by_pubkey.items()
                           if i == vi), None)
                if pk is None or pk in self.store.doppelganger_blocked:
                    continue
                sig = self.store.sign_sync_committee_message(
                    pk, slot, head_root, state, self.preset)
                items.append((positions, sig))
            bn.submit_sync_messages(slot, head_root, items)
            return len(items)

        n = self.fallback.first_success(run)
        if n:
            self.log.debug("sync committee signed", slot=slot, count=n)
        return n


class PreparationService:
    """Fee-recipient registration (`preparation_service.rs`): tell the BN
    which execution address each managed proposer wants, once per epoch."""

    def __init__(self, store: ValidatorStore, fallback: BeaconNodeFallback,
                 preset, log: Logger,
                 fee_recipient: bytes = b"\x00" * 20):
        self.store = store
        self.fallback = fallback
        self.preset = preset
        self.fee_recipient = fee_recipient
        self.log = log.child("preparation_service")
        self._last_epoch = -1

    def on_slot(self, slot: int) -> None:
        epoch = slot // self.preset.SLOTS_PER_EPOCH
        if epoch == self._last_epoch:
            return
        self._last_epoch = epoch
        preparations = [(i, self.fee_recipient)
                        for i in self.store.indices()]
        self.fallback.first_success(
            lambda bn: bn.prepare_proposers(preparations))
        self.log.debug("proposers prepared", epoch=epoch,
                       count=len(preparations))


class DoppelgangerService:
    """Two-epoch liveness watch before any signing
    (`doppelganger_service.rs:253,421`)."""

    EPOCHS_TO_WATCH = 2

    def __init__(self, store: ValidatorStore, fallback: BeaconNodeFallback,
                 start_epoch: int, log: Logger):
        self.store = store
        self.fallback = fallback
        self.start_epoch = start_epoch
        self.log = log.child("doppelganger")
        self.detected: set[bytes] = set()
        self.complete = False
        self._probed: set[int] = set()
        # Initially every key is blocked.
        store.doppelganger_blocked = set(store.pubkeys())

    def check_epoch(self, epoch: int) -> None:
        """Probe liveness for the previously-COMPLETED epoch only, and stop
        for good once the watch window is done.

        The reference never checks an epoch this VC itself may have signed
        in (``doppelganger_service.rs:253,421``): probing the in-progress
        epoch after the keys are released would observe our *own*
        attestations, mark every key as a doppelganger, and re-block them
        permanently.
        """
        if self.complete:
            return
        probe = epoch - 1
        if probe < self.start_epoch or probe in self._probed:
            return  # no fully-completed watch epoch yet / already probed
        pks = self.store.pubkeys()
        indices = [self.store.index_by_pubkey[pk] for pk in pks]
        live = self.fallback.first_success(
            lambda bn: bn.liveness(probe, indices))
        # Only a probe that actually RAN counts toward the watch window —
        # marking before the query would let a transient BN outage skip an
        # epoch's check while still counting it toward release.
        self._probed.add(probe)
        for pk, is_live in zip(pks, live):
            if is_live:
                self.detected.add(pk)
                self.log.crit("doppelganger detected", pubkey=pk.hex()[:12])
        if len(self._probed) >= self.EPOCHS_TO_WATCH \
                and probe >= self.start_epoch + self.EPOCHS_TO_WATCH - 1:
            # Watch over — but only after EPOCHS_TO_WATCH epochs were
            # actually probed: a VC resuming at epoch N ≥ start+2 must not
            # release on a single liveness query.  Release is permanent.
            self.store.doppelganger_blocked = set(self.detected)
            self.complete = True


class ValidatorClient:
    """`ProductionValidatorClient` — service assembly + the per-slot loop."""

    def __init__(self, store: ValidatorStore, nodes: List, preset,
                 log: Optional[Logger] = None, doppelganger: bool = False):
        self.store = store
        self.preset = preset
        self.log = log or test_logger()
        self.fallback = BeaconNodeFallback(nodes)
        self.duties = DutiesService(store, self.fallback, preset)
        self.blocks = BlockService(store, self.duties, self.fallback,
                                   preset, self.log)
        self.attestations = AttestationService(store, self.duties,
                                               self.fallback, preset,
                                               self.log)
        self.sync_committee = SyncCommitteeService(store, self.fallback,
                                                   preset, self.log)
        self.preparation = PreparationService(store, self.fallback, preset,
                                              self.log)
        self.doppelganger: Optional[DoppelgangerService] = (
            DoppelgangerService(store, self.fallback, 0, self.log)
            if doppelganger else None)

    def on_slot(self, slot: int) -> None:
        epoch = slot // self.preset.SLOTS_PER_EPOCH
        if epoch not in self.duties.proposers:
            self.duties.poll(epoch)
        if self.doppelganger is not None:
            self.doppelganger.check_epoch(epoch)
        self.preparation.on_slot(slot)
        self.blocks.on_slot(slot)
        self.attestations.on_slot(slot)
        self.sync_committee.on_slot(slot)
