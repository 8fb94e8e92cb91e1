"""Block-building harness over the pure state-transition layer.

Counterpart of ``BeaconChainHarness``
(``beacon_node/beacon_chain/src/test_utils.rs:579``): builds
*valid* signed blocks — correct proposer, randao reveal, state root,
attestations with full committee participation, sync aggregates, deposits
with real Merkle proofs, slashings, exits, BLS-to-execution changes — against
a live state, using the interop keypairs.

Signing honours the active BLS backend: under ``python`` every signature is
real; under ``fake`` a fixed valid-encoding G2 point stands in (the backend
ignores pairings but deserialization validity rules still apply), mirroring
how the reference runs its harness under ``fake_crypto``.
"""

from __future__ import annotations

import numpy as np

from ..crypto import bls as B
from ..crypto import curve as C
from ..ops.merkle_proof import DepositTree
from ..types.chain_spec import ChainSpec, Domain, ForkName
from ..types.factory import spec_types
from ..types.presets import MINIMAL, Preset
from ..state_transition import (
    SignatureStrategy,
    interop_genesis_state,
    interop_secret_key,
    state_transition,
)
from ..state_transition.committees import (
    get_beacon_committee,
    get_beacon_proposer_index,
    get_committee_count_per_slot,
)
from ..state_transition.genesis import bls_withdrawal_credentials, interop_pubkey
from ..state_transition.helpers import (
    compute_epoch_at_slot,
    compute_signing_root,
    current_epoch,
    get_block_root,
    get_block_root_at_slot,
    get_domain,
    get_randao_mix,
)
from ..state_transition.per_block import get_expected_withdrawals
from ..state_transition.per_slot import process_slots

# A valid non-infinity G2 encoding for fake-backend signing.
_DUMMY_SIG = C.g2_compress(C.G2_GEN)


def _real_signing() -> bool:
    return B.get_backend().name != "fake"


def _sign(validator_index: int, signing_root: bytes) -> bytes:
    if not _real_signing():
        return _DUMMY_SIG
    return interop_secret_key(validator_index).sign(signing_root).serialize()


class StateHarness:
    """Drives a beacon state forward with self-built valid blocks."""

    def __init__(self, n_validators: int = 64,
                 fork: ForkName = ForkName.CAPELLA,
                 preset: Preset = MINIMAL,
                 spec: ChainSpec | None = None,
                 genesis_time: int = 0):
        self.preset = preset
        self.spec = spec or ChainSpec.minimal().with_forks_at_genesis(fork)
        self.T = spec_types(preset)
        self.state = interop_genesis_state(
            n_validators, genesis_time, preset, self.spec, self.T, fork=fork)
        # Deposit tree pre-seeded with the genesis validators, so new
        # deposits continue the contract's index sequence
        # (state.eth1_deposit_index == n_validators at interop genesis).
        self.deposit_tree = DepositTree(preset.DEPOSIT_CONTRACT_TREE_DEPTH)
        for i in range(n_validators):
            pk = interop_pubkey(i)
            self.deposit_tree.push(self.T.DepositData(
                pubkey=pk,
                withdrawal_credentials=bls_withdrawal_credentials(pk),
                amount=preset.MAX_EFFECTIVE_BALANCE,
                signature=_DUMMY_SIG).tree_hash_root())
        self.pending_deposits: list = []
        self.blocks: list = []  # applied signed blocks, in order

    # -- fork plumbing -------------------------------------------------------

    def fork_at(self, slot: int) -> ForkName:
        return self.spec.fork_name_at_epoch(
            compute_epoch_at_slot(slot, self.preset.SLOTS_PER_EPOCH))

    # -- attestation building ------------------------------------------------

    def _committee_att_data(self, state, slot: int):
        """Per-committee ``(index, committee, AttestationData, signing
        root)`` tuples for ``slot`` — the ONE construction aggregates
        AND single-bit attestations share (they must vote identical
        AttestationData or a drill's aggregate conflicts with its own
        singles)."""
        T, preset = self.T, self.preset
        epoch = compute_epoch_at_slot(slot, preset.SLOTS_PER_EPOCH)
        head_root = get_block_root_at_slot(state, slot, preset)
        epoch_start = epoch * preset.SLOTS_PER_EPOCH
        if epoch_start < state.slot:
            target_root = get_block_root_at_slot(state, epoch_start, preset)
        else:
            target_root = head_root
        if epoch == current_epoch(state, preset):
            source = state.current_justified_checkpoint
        else:
            source = state.previous_justified_checkpoint
        domain = get_domain(state, Domain.BEACON_ATTESTER, epoch, preset)
        out = []
        for index in range(get_committee_count_per_slot(state, epoch,
                                                        preset)):
            committee = get_beacon_committee(state, slot, index, preset)
            data = T.AttestationData(
                slot=slot, index=index, beacon_block_root=head_root,
                source=T.Checkpoint(epoch=source.epoch, root=source.root),
                target=T.Checkpoint(epoch=epoch, root=target_root))
            out.append((index, committee, data,
                        compute_signing_root(data, domain)))
        return out

    def attestations_for_slot(self, state, slot: int,
                              participation: float = 1.0) -> list:
        """One aggregate attestation per committee at ``slot``, signed by the
        (first ``participation`` fraction of the) committee.

        ``state`` must be advanced past ``slot`` so the block root exists.
        """
        T = self.T
        out = []
        for _index, committee, data, root in \
                self._committee_att_data(state, slot):
            n_sign = max(1, int(len(committee) * participation))
            bits = np.zeros(len(committee), dtype=bool)
            bits[:n_sign] = True
            if _real_signing():
                sig = B.aggregate_signatures([
                    interop_secret_key(int(v)).sign(root)
                    for v in committee[:n_sign]]).serialize()
            else:
                sig = _DUMMY_SIG
            out.append(T.Attestation(aggregation_bits=bits, data=data,
                                     signature=sig))
        return out

    def single_attestations_for_slot(self, state, slot: int,
                                     fraction: float = 1.0) -> list:
        """Unaggregated single-bit attestations — the subnet-gossip
        shape the sustained-load drill streams.  One attestation per
        committee member for the first ``fraction`` of each committee
        at ``slot``, each with exactly its own aggregation bit set and
        its own signature.  ``state`` must be advanced past ``slot``."""
        T = self.T
        out = []
        for _index, committee, data, root in \
                self._committee_att_data(state, slot):
            n_sign = max(1, int(len(committee) * fraction))
            for pos in range(n_sign):
                bits = np.zeros(len(committee), dtype=bool)
                bits[pos] = True
                if _real_signing():
                    sig = interop_secret_key(
                        int(committee[pos])).sign(root).serialize()
                else:
                    sig = _DUMMY_SIG
                out.append(T.Attestation(aggregation_bits=bits, data=data,
                                         signature=sig))
        return out

    # -- sync aggregate ------------------------------------------------------

    def sync_aggregate_for(self, state, block_slot: int) -> object:
        """Full-participation sync aggregate for a block at ``block_slot``
        (signs the previous slot's block root with the current committee)."""
        T, preset = self.T, self.preset
        prev_slot = max(block_slot, 1) - 1
        root = get_block_root_at_slot(state, prev_slot, preset)
        domain = get_domain(
            state, Domain.SYNC_COMMITTEE,
            compute_epoch_at_slot(prev_slot, preset.SLOTS_PER_EPOCH), preset)
        signing_root = compute_signing_root(root, domain)
        bits = np.ones(preset.SYNC_COMMITTEE_SIZE, dtype=bool)
        if _real_signing():
            cache = self._pubkey_to_index(state)
            sig = B.aggregate_signatures([
                interop_secret_key(cache[bytes(pk)]).sign(signing_root)
                for pk in state.current_sync_committee.pubkeys]).serialize()
        else:
            sig = _DUMMY_SIG
        return T.SyncAggregate(sync_committee_bits=bits,
                               sync_committee_signature=sig)

    def empty_sync_aggregate(self) -> object:
        return self.T.SyncAggregate(
            sync_committee_bits=np.zeros(self.preset.SYNC_COMMITTEE_SIZE,
                                         dtype=bool),
            sync_committee_signature=B.INFINITY_SIGNATURE)

    def _pubkey_to_index(self, state) -> dict:
        return {state.validators.col("pubkey")[i].tobytes(): i
                for i in range(len(state.validators))}

    # -- operations ----------------------------------------------------------

    def make_deposit(self, validator_index: int, amount: int | None = None,
                     valid_signature: bool = True):
        """Build a deposit (new validator keyed by ``validator_index``'s
        interop key) and register it in the harness deposit tree.  From the
        next built block on, blocks vote for the tree's ``eth1_data``; the
        block whose vote reaches the majority includes the pending
        deposits."""
        T, preset = self.T, self.preset
        amount = amount or preset.MAX_EFFECTIVE_BALANCE
        pk = interop_pubkey(validator_index)
        msg = T.DepositMessage(
            pubkey=pk,
            withdrawal_credentials=bls_withdrawal_credentials(pk),
            amount=amount)
        from ..state_transition.helpers import compute_domain
        domain = compute_domain(Domain.DEPOSIT, self.spec.genesis_fork_version)
        root = compute_signing_root(msg, domain)
        if valid_signature:
            sig = interop_secret_key(validator_index).sign(root).serialize()
        else:
            sig = _DUMMY_SIG if _real_signing() else B.INFINITY_SIGNATURE
        data = T.DepositData(
            pubkey=pk, withdrawal_credentials=msg.withdrawal_credentials,
            amount=amount, signature=sig)
        self.deposit_tree.push(data.tree_hash_root())
        self.pending_deposits.append(data)

    def make_exit(self, state, validator_index: int):
        T, preset = self.T, self.preset
        epoch = current_epoch(state, preset)
        exit_msg = T.VoluntaryExit(epoch=epoch,
                                   validator_index=validator_index)
        domain = get_domain(state, Domain.VOLUNTARY_EXIT, epoch, preset)
        sig = _sign(validator_index, compute_signing_root(exit_msg, domain))
        return T.SignedVoluntaryExit(message=exit_msg, signature=sig)

    def make_proposer_slashing(self, state, proposer_index: int):
        """Two distinct signed headers at the same slot."""
        T, preset = self.T, self.preset
        slot = state.slot
        domain = get_domain(state, Domain.BEACON_PROPOSER,
                            compute_epoch_at_slot(slot,
                                                  preset.SLOTS_PER_EPOCH),
                            preset)

        def header(graffiti: bytes):
            h = T.BeaconBlockHeader(
                slot=slot, proposer_index=proposer_index,
                parent_root=b"\x11" * 32, state_root=graffiti,
                body_root=b"\x22" * 32)
            return T.SignedBeaconBlockHeader(
                message=h,
                signature=_sign(proposer_index,
                                compute_signing_root(h, domain)))

        return T.ProposerSlashing(signed_header_1=header(b"\x01" * 32),
                                  signed_header_2=header(b"\x02" * 32))

    def make_attester_slashing(self, state, indices: list[int]):
        """Double vote by ``indices``: two attestations, same target epoch,
        different data."""
        T, preset = self.T, self.preset
        epoch = current_epoch(state, preset)
        domain = get_domain(state, Domain.BEACON_ATTESTER, epoch, preset)

        def indexed(root: bytes):
            data = T.AttestationData(
                slot=state.slot, index=0, beacon_block_root=root,
                source=T.Checkpoint(epoch=max(epoch, 1) - 1, root=b"\x00" * 32),
                target=T.Checkpoint(epoch=epoch, root=root))
            signing = compute_signing_root(data, domain)
            if _real_signing():
                sig = B.aggregate_signatures([
                    interop_secret_key(i).sign(signing)
                    for i in indices]).serialize()
            else:
                sig = _DUMMY_SIG
            return T.IndexedAttestation(
                attesting_indices=sorted(indices), data=data, signature=sig)

        return T.AttesterSlashing(attestation_1=indexed(b"\xaa" * 32),
                                  attestation_2=indexed(b"\xbb" * 32))

    def make_bls_to_execution_change(self, validator_index: int,
                                     address: bytes = b"\x0b" * 20):
        T = self.T
        change = T.BLSToExecutionChange(
            validator_index=validator_index,
            from_bls_pubkey=interop_pubkey(validator_index),
            to_execution_address=address)
        from ..state_transition.helpers import compute_domain
        domain = compute_domain(Domain.BLS_TO_EXECUTION_CHANGE,
                                self.spec.genesis_fork_version,
                                self.state.genesis_validators_root)
        sig = _sign(validator_index, compute_signing_root(change, domain))
        return T.SignedBLSToExecutionChange(message=change, signature=sig)

    # -- block building ------------------------------------------------------

    def build_block(self, slot: int | None = None, *,
                    attestations: list | None = None,
                    proposer_slashings: list = (),
                    attester_slashings: list = (),
                    voluntary_exits: list = (),
                    bls_to_execution_changes: list = (),
                    blob_kzg_commitments: list = (),
                    sync_participation: float = 1.0,
                    compute_state_root: bool = True,
                    pre_merge: bool = False,
                    graffiti: bytes = b"\x00" * 32):
        """Build a valid signed block on top of the current state.

        Default attestations: full participation for ``slot - 1``.  Returns
        the signed block without applying it.
        """
        T, preset, spec = self.T, self.preset, self.spec
        state = self.state
        if slot is None:
            slot = state.slot + 1
        fork = self.fork_at(slot)

        advanced = state.copy()
        advanced = process_slots(advanced, slot, preset, spec, T)
        # A slashed proposer cannot propose (process_block_header rejects);
        # on mainnet that slot simply stays empty — skip forward.
        while bool(advanced.validators.col("slashed")[
                get_beacon_proposer_index(advanced, preset)]):
            slot += 1
            advanced = process_slots(advanced, slot, preset, spec, T)
            fork = self.fork_at(slot)

        if attestations is None:
            if slot > 0 and state.slot <= slot - 1:
                attestations = self.attestations_for_slot(advanced, slot - 1)
            else:
                attestations = []

        proposer = get_beacon_proposer_index(advanced, preset)
        epoch = compute_epoch_at_slot(slot, preset.SLOTS_PER_EPOCH)

        # Randao reveal signs the epoch.
        from ..ssz import uint64 as _u64
        randao_domain = get_domain(advanced, Domain.RANDAO, epoch, preset)
        reveal = _sign(proposer, compute_signing_root(
            _u64.hash_tree_root(epoch), randao_domain))

        # Deposits: while any are pending the block votes for the deposit
        # tree's eth1_data, and the block whose vote makes the majority
        # (process_eth1_data runs before the operations) includes them all.
        deposits = []
        eth1_data = advanced.eth1_data
        if self.pending_deposits:
            eth1_data = T.Eth1Data(
                deposit_root=self.deposit_tree.root(),
                deposit_count=self.deposit_tree.count,
                block_hash=b"\x42" * 32)
            votes = 1 + sum(1 for v in advanced.eth1_data_votes
                            if v == eth1_data)
            needed = (preset.EPOCHS_PER_ETH1_VOTING_PERIOD
                      * preset.SLOTS_PER_EPOCH)
            if votes * 2 > needed:
                start = advanced.eth1_deposit_index
                for i, data in enumerate(self.pending_deposits):
                    deposits.append(T.Deposit(
                        proof=self.deposit_tree.proof(start + i), data=data))
                self.pending_deposits = []

        body_kw = dict(
            randao_reveal=reveal,
            eth1_data=eth1_data,
            graffiti=graffiti,
            proposer_slashings=list(proposer_slashings),
            attester_slashings=list(attester_slashings),
            attestations=list(attestations),
            deposits=deposits,
            voluntary_exits=list(voluntary_exits),
        )
        if fork >= ForkName.ALTAIR:
            if sync_participation > 0:
                body_kw["sync_aggregate"] = self.sync_aggregate_for(
                    advanced, slot)
            else:
                body_kw["sync_aggregate"] = self.empty_sync_aggregate()
        if fork >= ForkName.BELLATRIX:
            # ``pre_merge``: default payload — valid only while the merge
            # transition is incomplete (the is_execution_enabled gate).
            body_kw["execution_payload"] = (
                T.payload_cls(fork)() if pre_merge
                else self._execution_payload(advanced, fork))
        if fork >= ForkName.CAPELLA:
            body_kw["bls_to_execution_changes"] = list(
                bls_to_execution_changes)
        if fork >= ForkName.DENEB:
            body_kw["blob_kzg_commitments"] = [
                bytes(c) for c in blob_kzg_commitments]

        body = T.body_cls(fork)(**body_kw)
        block = T.block_cls(fork)(
            slot=slot, proposer_index=proposer,
            parent_root=advanced.latest_block_header.tree_hash_root(),
            state_root=b"\x00" * 32, body=body)

        # State root: apply without verification on a scratch copy.
        # ``compute_state_root=False`` for deliberately-invalid blocks whose
        # application would fail here (rejection tests).
        if compute_state_root:
            from ..state_transition.per_block import process_block
            scratch = advanced.copy()
            process_block(scratch, T.signed_block_cls(fork)(
                message=block, signature=_DUMMY_SIG), fork, preset, spec, T,
                strategy=SignatureStrategy.NO_VERIFICATION)
            block.state_root = scratch.tree_hash_root()

        proposal_domain = get_domain(advanced, Domain.BEACON_PROPOSER, epoch,
                                     preset)
        sig = _sign(proposer, compute_signing_root(block, proposal_domain))
        return T.signed_block_cls(fork)(message=block, signature=sig)

    def _execution_payload(self, advanced, fork: ForkName):
        """A linking payload over the mock EL (``MockExecutionLayer`` role)."""
        T, preset, spec = self.T, self.preset, self.spec
        import hashlib
        parent_hash = advanced.latest_execution_payload_header.block_hash
        kw = dict(
            parent_hash=parent_hash,
            prev_randao=get_randao_mix(
                advanced, current_epoch(advanced, preset), preset),
            block_number=advanced.latest_execution_payload_header.block_number
            + 1,
            gas_limit=30_000_000,
            timestamp=advanced.genesis_time
            + advanced.slot * spec.seconds_per_slot,
            block_hash=hashlib.sha256(
                parent_hash + int(advanced.slot).to_bytes(8, "little")
            ).digest(),
        )
        if fork >= ForkName.CAPELLA:
            kw["withdrawals"] = [
                T.Withdrawal(index=w[0], validator_index=w[1],
                             address=w[2], amount=w[3])
                for w in get_expected_withdrawals(advanced, preset)]
        return T.payload_cls(fork)(**kw)

    # -- chain driving -------------------------------------------------------

    def apply_block(self, signed_block,
                    strategy: SignatureStrategy = SignatureStrategy.VERIFY_BULK,
                    validate_state_root: bool = True):
        self.state = state_transition(
            self.state, signed_block, self.preset, self.spec, self.T,
            strategy=strategy, validate_state_root=validate_state_root)
        self.blocks.append(signed_block)
        return self.state

    def extend_chain(self, n_blocks: int,
                     strategy: SignatureStrategy = SignatureStrategy.VERIFY_BULK,
                     **build_kw):
        out = []
        for _ in range(n_blocks):
            sb = self.build_block(**build_kw)
            self.apply_block(sb, strategy=strategy)
            out.append(sb)
        return out
