"""Per-preset consensus containers — phase0 through deneb.

Port of ``lighthouse_tpu/types/factory.py`` (a copy; only the hashing
behind the columnar types differs).

The counterpart of the reference's generic types
(``consensus/types/src/*.rs``, monomorphized over
``EthSpec``): :func:`spec_types` builds the full set of container classes for
a :class:`~lighthouse_tpu_torch.types.presets.Preset` and caches it.  Fork-versioned
types (``superstruct`` enums in the reference — ``beacon_state.rs:19``,
``beacon_block.rs``, ``execution_payload.rs``) become per-fork classes whose
common field prefix is shared via annotated base classes, so SSZ field order
matches the spec exactly.

Hot state columns use the columnar types from
:mod:`lighthouse_tpu_torch.types.columns` and the SoA registry from
:mod:`lighthouse_tpu_torch.types.validators` — wire-identical to SSZ, hashed as
batched device reductions.

NOTE: no ``from __future__ import annotations`` here — container field
annotations must evaluate eagerly so they can reference the other classes
built in this scope.
"""

from ..ssz import (
    Bitlist,
    Bitvector,
    ByteList,
    ByteVector,
    Bytes4,
    Bytes20,
    Bytes32,
    Bytes48,
    Bytes96,
    Container,
    List,
    Vector,
    boolean,
    uint64,
    uint256,
)
from .chain_spec import ForkName
from .columns import (
    PackedU8List,
    PackedU64List,
    PackedU64Vector,
    RootsList,
    RootsVector,
)
from .device_state import DEVICE_COLUMN_FIELDS as _DEVICE_COLUMN_FIELDS_T
from .presets import Preset
from .validators import Validator, ValidatorRegistryList

_DEVICE_COLUMN_FIELDS = frozenset(_DEVICE_COLUMN_FIELDS_T)


class SpecTypes:
    """Namespace of container classes for one preset."""

    def __init__(self, preset: Preset):
        self.preset = preset
        p = preset
        ns = self.__dict__

        # -- fork-independent leaf containers (beacon-chain.md) --------------

        class Fork(Container):
            previous_version: Bytes4
            current_version: Bytes4
            epoch: uint64

        class ForkData(Container):
            current_version: Bytes4
            genesis_validators_root: Bytes32

        class SigningData(Container):
            object_root: Bytes32
            domain: Bytes32

        class Checkpoint(Container):
            epoch: uint64
            root: Bytes32

        class AttestationData(Container):
            slot: uint64
            index: uint64
            beacon_block_root: Bytes32
            source: Checkpoint
            target: Checkpoint

        class IndexedAttestation(Container):
            attesting_indices: List(uint64, p.MAX_VALIDATORS_PER_COMMITTEE)
            data: AttestationData
            signature: Bytes96

        class PendingAttestation(Container):
            aggregation_bits: Bitlist(p.MAX_VALIDATORS_PER_COMMITTEE)
            data: AttestationData
            inclusion_delay: uint64
            proposer_index: uint64

        class Eth1Data(Container):
            deposit_root: Bytes32
            deposit_count: uint64
            block_hash: Bytes32

        class HistoricalBatch(Container):
            block_roots: RootsVector(p.SLOTS_PER_HISTORICAL_ROOT)
            state_roots: RootsVector(p.SLOTS_PER_HISTORICAL_ROOT)

        class HistoricalSummary(Container):
            block_summary_root: Bytes32
            state_summary_root: Bytes32

        class DepositMessage(Container):
            pubkey: Bytes48
            withdrawal_credentials: Bytes32
            amount: uint64

        class DepositData(Container):
            pubkey: Bytes48
            withdrawal_credentials: Bytes32
            amount: uint64
            signature: Bytes96

        class Deposit(Container):
            proof: Vector(Bytes32, p.DEPOSIT_CONTRACT_TREE_DEPTH + 1)
            data: DepositData

        class BeaconBlockHeader(Container):
            slot: uint64
            proposer_index: uint64
            parent_root: Bytes32
            state_root: Bytes32
            body_root: Bytes32

        class SignedBeaconBlockHeader(Container):
            message: BeaconBlockHeader
            signature: Bytes96

        class ProposerSlashing(Container):
            signed_header_1: SignedBeaconBlockHeader
            signed_header_2: SignedBeaconBlockHeader

        class AttesterSlashing(Container):
            attestation_1: IndexedAttestation
            attestation_2: IndexedAttestation

        class Attestation(Container):
            aggregation_bits: Bitlist(p.MAX_VALIDATORS_PER_COMMITTEE)
            data: AttestationData
            signature: Bytes96

        class VoluntaryExit(Container):
            epoch: uint64
            validator_index: uint64

        class SignedVoluntaryExit(Container):
            message: VoluntaryExit
            signature: Bytes96

        class SyncAggregate(Container):
            sync_committee_bits: Bitvector(p.SYNC_COMMITTEE_SIZE)
            sync_committee_signature: Bytes96

        class SyncCommittee(Container):
            pubkeys: Vector(Bytes48, p.SYNC_COMMITTEE_SIZE)
            aggregate_pubkey: Bytes48

        class AggregateAndProof(Container):
            aggregator_index: uint64
            aggregate: Attestation
            selection_proof: Bytes96

        class SignedAggregateAndProof(Container):
            message: AggregateAndProof
            signature: Bytes96

        class SyncCommitteeMessage(Container):
            slot: uint64
            beacon_block_root: Bytes32
            validator_index: uint64
            signature: Bytes96

        class SyncCommitteeContribution(Container):
            slot: uint64
            beacon_block_root: Bytes32
            subcommittee_index: uint64
            aggregation_bits: Bitvector(p.sync_subcommittee_size)
            signature: Bytes96

        class ContributionAndProof(Container):
            aggregator_index: uint64
            contribution: SyncCommitteeContribution
            selection_proof: Bytes96

        class SignedContributionAndProof(Container):
            message: ContributionAndProof
            signature: Bytes96

        class SyncAggregatorSelectionData(Container):
            slot: uint64
            subcommittee_index: uint64

        class Withdrawal(Container):
            index: uint64
            validator_index: uint64
            address: Bytes20
            amount: uint64

        class BLSToExecutionChange(Container):
            validator_index: uint64
            from_bls_pubkey: Bytes48
            to_execution_address: Bytes20

        class SignedBLSToExecutionChange(Container):
            message: BLSToExecutionChange
            signature: Bytes96

        # -- execution payloads (bellatrix / capella) ------------------------

        Transaction = ByteList(p.MAX_BYTES_PER_TRANSACTION)
        LogsBloom = ByteVector(p.BYTES_PER_LOGS_BLOOM)
        ExtraData = ByteList(p.MAX_EXTRA_DATA_BYTES)

        class _PayloadCommon(Container):
            parent_hash: Bytes32
            fee_recipient: Bytes20
            state_root: Bytes32
            receipts_root: Bytes32
            logs_bloom: LogsBloom
            prev_randao: Bytes32
            block_number: uint64
            gas_limit: uint64
            gas_used: uint64
            timestamp: uint64
            extra_data: ExtraData
            base_fee_per_gas: uint256
            block_hash: Bytes32

        class ExecutionPayloadBellatrix(_PayloadCommon):
            transactions: List(Transaction, p.MAX_TRANSACTIONS_PER_PAYLOAD)

        class ExecutionPayloadCapella(_PayloadCommon):
            transactions: List(Transaction, p.MAX_TRANSACTIONS_PER_PAYLOAD)
            withdrawals: List(Withdrawal, p.MAX_WITHDRAWALS_PER_PAYLOAD)

        class ExecutionPayloadDeneb(_PayloadCommon):
            transactions: List(Transaction, p.MAX_TRANSACTIONS_PER_PAYLOAD)
            withdrawals: List(Withdrawal, p.MAX_WITHDRAWALS_PER_PAYLOAD)
            blob_gas_used: uint64
            excess_blob_gas: uint64

        class ExecutionPayloadHeaderBellatrix(_PayloadCommon):
            transactions_root: Bytes32

        class ExecutionPayloadHeaderCapella(_PayloadCommon):
            transactions_root: Bytes32
            withdrawals_root: Bytes32

        class ExecutionPayloadHeaderDeneb(_PayloadCommon):
            transactions_root: Bytes32
            withdrawals_root: Bytes32
            blob_gas_used: uint64
            excess_blob_gas: uint64

        # -- block bodies / blocks per fork ----------------------------------

        class _BodyCommon(Container):
            randao_reveal: Bytes96
            eth1_data: Eth1Data
            graffiti: Bytes32
            proposer_slashings: List(ProposerSlashing, p.MAX_PROPOSER_SLASHINGS)
            attester_slashings: List(AttesterSlashing, p.MAX_ATTESTER_SLASHINGS)
            attestations: List(Attestation, p.MAX_ATTESTATIONS)
            deposits: List(Deposit, p.MAX_DEPOSITS)
            voluntary_exits: List(SignedVoluntaryExit, p.MAX_VOLUNTARY_EXITS)

        class BeaconBlockBodyPhase0(_BodyCommon):
            pass

        class BeaconBlockBodyAltair(_BodyCommon):
            sync_aggregate: SyncAggregate

        class BeaconBlockBodyBellatrix(_BodyCommon):
            sync_aggregate: SyncAggregate
            execution_payload: ExecutionPayloadBellatrix

        class BeaconBlockBodyCapella(_BodyCommon):
            sync_aggregate: SyncAggregate
            execution_payload: ExecutionPayloadCapella
            bls_to_execution_changes: List(
                SignedBLSToExecutionChange, p.MAX_BLS_TO_EXECUTION_CHANGES)

        # Deneb (EIP-4844): the body carries the blob KZG commitments; the
        # blobs themselves travel as BlobSidecars outside the block.
        KZGCommitment = Bytes48
        KZGProof = Bytes48
        Blob = ByteVector(p.BYTES_PER_BLOB)

        class BeaconBlockBodyDeneb(_BodyCommon):
            sync_aggregate: SyncAggregate
            execution_payload: ExecutionPayloadDeneb
            bls_to_execution_changes: List(
                SignedBLSToExecutionChange, p.MAX_BLS_TO_EXECUTION_CHANGES)
            blob_kzg_commitments: List(
                KZGCommitment, p.MAX_BLOB_COMMITMENTS_PER_BLOCK)

        class BlobSidecar(Container):
            """`deneb/p2p-interface.md` BlobSidecar: blob + proof bound to
            a block via the header and the commitment inclusion branch."""
            index: uint64
            blob: Blob
            kzg_commitment: KZGCommitment
            kzg_proof: KZGProof
            signed_block_header: SignedBeaconBlockHeader
            kzg_commitment_inclusion_proof: Vector(
                Bytes32, p.KZG_COMMITMENT_INCLUSION_PROOF_DEPTH)

        class BlobIdentifier(Container):
            """`BlobSidecarsByRoot` request element."""
            block_root: Bytes32
            index: uint64

        def _make_block(body_cls):
            class BeaconBlock(Container):
                slot: uint64
                proposer_index: uint64
                parent_root: Bytes32
                state_root: Bytes32
                body: body_cls

            class SignedBeaconBlock(Container):
                message: BeaconBlock
                signature: Bytes96

            return BeaconBlock, SignedBeaconBlock

        BeaconBlockPhase0, SignedBeaconBlockPhase0 = _make_block(BeaconBlockBodyPhase0)
        BeaconBlockAltair, SignedBeaconBlockAltair = _make_block(BeaconBlockBodyAltair)
        BeaconBlockBellatrix, SignedBeaconBlockBellatrix = _make_block(BeaconBlockBodyBellatrix)
        BeaconBlockCapella, SignedBeaconBlockCapella = _make_block(BeaconBlockBodyCapella)
        BeaconBlockDeneb, SignedBeaconBlockDeneb = _make_block(BeaconBlockBodyDeneb)

        # -- blinded blocks (builder flow) ------------------------------------
        # The payload is replaced by its header; because the header's
        # tree-hash equals the full payload's, a blinded block and its
        # unblinded twin share one root — the `AbstractExecPayload`
        # machinery of `consensus/types/src/payload.rs` collapses to two
        # parallel container families here.

        class BlindedBeaconBlockBodyBellatrix(_BodyCommon):
            sync_aggregate: SyncAggregate
            execution_payload_header: ExecutionPayloadHeaderBellatrix

        class BlindedBeaconBlockBodyCapella(_BodyCommon):
            sync_aggregate: SyncAggregate
            execution_payload_header: ExecutionPayloadHeaderCapella
            bls_to_execution_changes: List(
                SignedBLSToExecutionChange, p.MAX_BLS_TO_EXECUTION_CHANGES)

        class BlindedBeaconBlockBodyDeneb(_BodyCommon):
            sync_aggregate: SyncAggregate
            execution_payload_header: ExecutionPayloadHeaderDeneb
            bls_to_execution_changes: List(
                SignedBLSToExecutionChange, p.MAX_BLS_TO_EXECUTION_CHANGES)
            blob_kzg_commitments: List(
                KZGCommitment, p.MAX_BLOB_COMMITMENTS_PER_BLOCK)

        BlindedBeaconBlockBellatrix, SignedBlindedBeaconBlockBellatrix = \
            _make_block(BlindedBeaconBlockBodyBellatrix)
        BlindedBeaconBlockCapella, SignedBlindedBeaconBlockCapella = \
            _make_block(BlindedBeaconBlockBodyCapella)
        BlindedBeaconBlockDeneb, SignedBlindedBeaconBlockDeneb = \
            _make_block(BlindedBeaconBlockBodyDeneb)

        # -- states per fork -------------------------------------------------

        JustificationBits = Bitvector(4)
        Balances = PackedU64List(p.VALIDATOR_REGISTRY_LIMIT)
        Participation = PackedU8List(p.VALIDATOR_REGISTRY_LIMIT)
        InactivityScores = PackedU64List(p.VALIDATOR_REGISTRY_LIMIT)
        Slashings = PackedU64Vector(p.EPOCHS_PER_SLASHINGS_VECTOR)
        Registry = ValidatorRegistryList(p.VALIDATOR_REGISTRY_LIMIT)

        class _StateCommon(Container):
            """Shared state prefix + the incremental tree-hash cache hook
            (``BeaconTreeHashCache``,
            ``types/src/beacon_state/tree_hash_cache.rs:332``): instances
            carry a :class:`~lighthouse_tpu_torch.types.state_cache.StateHashCache`
            that makes repeated ``tree_hash_root()`` calls O(changes·log n);
            ``copy()`` clones it like the reference's state clone.

            Once a state is device-resident
            (:func:`~lighthouse_tpu_torch.types.device_state.materialize_state`),
            wholesale column assignment (``state.balances = new``) is routed
            INTO the existing :class:`~lighthouse_tpu_torch.types.device_state.
            DeviceColumn` instead of replacing it, so residency and dirty
            tracking survive every legacy write path; a device-tensor RHS
            is adopted without a pull (a column computed on the device
            stays there)."""

            def __setattr__(self, name, value):
                if name in _DEVICE_COLUMN_FIELDS:
                    from .device_state import DeviceColumn
                    cur = self.__dict__.get(name)
                    if isinstance(cur, DeviceColumn) and cur is not value:
                        if isinstance(value, DeviceColumn):
                            object.__setattr__(self, name, value)
                        else:
                            cur.assign(value)
                        return
                object.__setattr__(self, name, value)

            def tree_hash_root(self) -> bytes:
                from .state_cache import StateHashCache
                thc = self.__dict__.get("_thc")
                if thc is None:
                    thc = self.__dict__["_thc"] = StateHashCache()
                return thc.root(self)

            def copy(self):
                out = super().copy()
                thc = self.__dict__.get("_thc")
                if thc is not None:
                    out.__dict__["_thc"] = thc.copy()
                if self.__dict__.get("_device_resident"):
                    out.__dict__["_device_resident"] = True
                return out

            genesis_time: uint64
            genesis_validators_root: Bytes32
            slot: uint64
            fork: Fork
            latest_block_header: BeaconBlockHeader
            block_roots: RootsVector(p.SLOTS_PER_HISTORICAL_ROOT)
            state_roots: RootsVector(p.SLOTS_PER_HISTORICAL_ROOT)
            historical_roots: RootsList(p.HISTORICAL_ROOTS_LIMIT)
            eth1_data: Eth1Data
            eth1_data_votes: List(
                Eth1Data, p.EPOCHS_PER_ETH1_VOTING_PERIOD * p.SLOTS_PER_EPOCH)
            eth1_deposit_index: uint64
            validators: Registry
            balances: Balances
            randao_mixes: RootsVector(p.EPOCHS_PER_HISTORICAL_VECTOR)
            slashings: Slashings

        class BeaconStatePhase0(_StateCommon):
            previous_epoch_attestations: List(
                PendingAttestation, p.MAX_ATTESTATIONS * p.SLOTS_PER_EPOCH)
            current_epoch_attestations: List(
                PendingAttestation, p.MAX_ATTESTATIONS * p.SLOTS_PER_EPOCH)
            justification_bits: JustificationBits
            previous_justified_checkpoint: Checkpoint
            current_justified_checkpoint: Checkpoint
            finalized_checkpoint: Checkpoint

        class _StateAltairCommon(_StateCommon):
            previous_epoch_participation: Participation
            current_epoch_participation: Participation
            justification_bits: JustificationBits
            previous_justified_checkpoint: Checkpoint
            current_justified_checkpoint: Checkpoint
            finalized_checkpoint: Checkpoint
            inactivity_scores: InactivityScores
            current_sync_committee: SyncCommittee
            next_sync_committee: SyncCommittee

        class BeaconStateAltair(_StateAltairCommon):
            pass

        class BeaconStateBellatrix(_StateAltairCommon):
            latest_execution_payload_header: ExecutionPayloadHeaderBellatrix

        class BeaconStateCapella(_StateAltairCommon):
            latest_execution_payload_header: ExecutionPayloadHeaderCapella
            next_withdrawal_index: uint64
            next_withdrawal_validator_index: uint64
            historical_summaries: List(
                HistoricalSummary, p.HISTORICAL_ROOTS_LIMIT)

        class BeaconStateDeneb(_StateAltairCommon):
            latest_execution_payload_header: ExecutionPayloadHeaderDeneb
            next_withdrawal_index: uint64
            next_withdrawal_validator_index: uint64
            historical_summaries: List(
                HistoricalSummary, p.HISTORICAL_ROOTS_LIMIT)

        # -- publish ---------------------------------------------------------

        for k, v in list(locals().items()):
            if k not in ("self", "p", "ns", "preset") and not k.startswith("_"):
                ns[k] = v
        ns["Validator"] = Validator
        ns["Transaction"] = Transaction
        ns["JustificationBits"] = JustificationBits
        ns["Registry"] = Registry
        ns["Balances"] = Balances
        ns["Participation"] = Participation

        self._by_fork = {
            ForkName.PHASE0: (BeaconStatePhase0, BeaconBlockPhase0,
                              SignedBeaconBlockPhase0, BeaconBlockBodyPhase0),
            ForkName.ALTAIR: (BeaconStateAltair, BeaconBlockAltair,
                              SignedBeaconBlockAltair, BeaconBlockBodyAltair),
            ForkName.BELLATRIX: (BeaconStateBellatrix, BeaconBlockBellatrix,
                                 SignedBeaconBlockBellatrix,
                                 BeaconBlockBodyBellatrix),
            ForkName.CAPELLA: (BeaconStateCapella, BeaconBlockCapella,
                               SignedBeaconBlockCapella,
                               BeaconBlockBodyCapella),
            ForkName.DENEB: (BeaconStateDeneb, BeaconBlockDeneb,
                             SignedBeaconBlockDeneb, BeaconBlockBodyDeneb),
        }
        self._payload_by_fork = {
            ForkName.BELLATRIX: (ExecutionPayloadBellatrix,
                                 ExecutionPayloadHeaderBellatrix),
            ForkName.CAPELLA: (ExecutionPayloadCapella,
                               ExecutionPayloadHeaderCapella),
            ForkName.DENEB: (ExecutionPayloadDeneb,
                             ExecutionPayloadHeaderDeneb),
        }
        self._blinded_by_fork = {
            ForkName.BELLATRIX: (BlindedBeaconBlockBellatrix,
                                 SignedBlindedBeaconBlockBellatrix,
                                 BlindedBeaconBlockBodyBellatrix),
            ForkName.CAPELLA: (BlindedBeaconBlockCapella,
                               SignedBlindedBeaconBlockCapella,
                               BlindedBeaconBlockBodyCapella),
            ForkName.DENEB: (BlindedBeaconBlockDeneb,
                             SignedBlindedBeaconBlockDeneb,
                             BlindedBeaconBlockBodyDeneb),
        }

    # -- fork-indexed access (superstruct's common accessors) ---------------

    def state_cls(self, fork: ForkName) -> type:
        return self._by_fork[fork][0]

    def block_cls(self, fork: ForkName) -> type:
        return self._by_fork[fork][1]

    def signed_block_cls(self, fork: ForkName) -> type:
        return self._by_fork[fork][2]

    def body_cls(self, fork: ForkName) -> type:
        return self._by_fork[fork][3]

    def payload_cls(self, fork: ForkName) -> type:
        return self._payload_by_fork[fork][0]

    def payload_header_cls(self, fork: ForkName) -> type:
        return self._payload_by_fork[fork][1]

    def blinded_block_cls(self, fork: ForkName) -> type:
        return self._blinded_by_fork[fork][0]

    def signed_blinded_block_cls(self, fork: ForkName) -> type:
        return self._blinded_by_fork[fork][1]

    def blinded_body_cls(self, fork: ForkName) -> type:
        return self._blinded_by_fork[fork][2]

    def fork_of_state(self, state) -> ForkName:
        for fork, (scls, *_rest) in self._by_fork.items():
            if type(state) is scls:
                return fork
        raise TypeError(f"not a BeaconState: {type(state).__name__}")

    def fork_of_block(self, block) -> ForkName:
        for fork, (_s, bcls, sbcls, _body) in self._by_fork.items():
            if type(block) is bcls or type(block) is sbcls:
                return fork
        for fork, (bcls, sbcls, _body) in self._blinded_by_fork.items():
            if type(block) is bcls or type(block) is sbcls:
                return fork
        raise TypeError(f"not a BeaconBlock: {type(block).__name__}")


_spec_types_cache: dict[str, SpecTypes] = {}


def spec_types(preset: Preset) -> SpecTypes:
    st = _spec_types_cache.get(preset.name)
    if st is None:
        st = SpecTypes(preset)
        _spec_types_cache[preset.name] = st
    return st
