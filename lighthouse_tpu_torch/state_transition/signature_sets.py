"""Signature-set builders for every consensus message kind.

Counterpart of ``consensus/state_processing/src/
per_block_processing/signature_sets.rs:74-599``.  Each builder returns a
:class:`~lighthouse_tpu_torch.crypto.bls.SignatureSet` {aggregate signature,
signing keys, message}; the verifier batches them into ONE
random-linear-combination multi-pairing — the funnel that makes per-slot
crypto a single device launch.
"""

from __future__ import annotations

import numpy as np

from ..crypto.bls import PublicKey, Signature, SignatureSet
from ..types.chain_spec import Domain
from .committees import get_attesting_indices, get_beacon_proposer_index
from .helpers import (
    compute_epoch_at_slot,
    compute_signing_root,
    get_domain,
)


class SignatureSetError(ValueError):
    pass


class PubkeyCache:
    """Decompressed, subgroup-checked pubkeys by validator index — the
    ``ValidatorPubkeyCache`` seam
    (``beacon_node/beacon_chain/src/validator_pubkey_cache.rs:18-161``)."""

    def __init__(self):
        self._by_index: dict[int, PublicKey] = {}
        self._index_by_pubkey: dict[bytes, int] = {}

    def get(self, registry, index: int) -> PublicKey:
        pk = self._by_index.get(index)
        if pk is None:
            raw = registry.col("pubkey")[index].tobytes()
            pk = PublicKey.deserialize(raw)
            self._by_index[index] = pk
            self._index_by_pubkey[raw] = index
        return pk

    def get_many(self, registry, indices) -> list[PublicKey]:
        """Batched decompress-and-cache: the committee-sized builders'
        replacement for per-index :meth:`get` loops (one pubkey-column
        gather + one dict sweep instead of a Python attribute/method hop
        per index — committee-sized per-index loops were measurable
        block time).  Returns the keys in ``indices`` order."""
        by_index = self._by_index
        missing = {int(i) for i in indices if int(i) not in by_index}
        if missing:
            col = registry.col("pubkey")
            for i in missing:
                raw = col[i].tobytes()
                pk = PublicKey.deserialize(raw)
                by_index[i] = pk
                self._index_by_pubkey[raw] = i
        return [by_index[int(i)] for i in indices]

    def get_many_bytes(self, registry, raws) -> list[PublicKey]:
        """Batched lookup by compressed ENCODING (the sync-committee
        shape: the state stores committee pubkeys as bytes, possibly
        with duplicates, possibly — in hand-crafted states — not in the
        registry at all).  Registry members route through the index
        cache; foreign keys fall back to direct deserialization."""
        out = []
        for raw in raws:
            raw = bytes(raw)
            idx = self._index_by_pubkey.get(raw)
            if idx is None:
                idx = registry.pubkey_index(raw)
                if idx is not None:
                    self._index_by_pubkey[raw] = idx
            if idx is None:
                out.append(PublicKey.deserialize(raw))
                continue
            pk = self._by_index.get(idx)
            if pk is None:
                pk = self._by_index[idx] = PublicKey.deserialize(raw)
            out.append(pk)
        return out

    def index_of(self, registry, pubkey: bytes) -> int | None:
        idx = self._index_by_pubkey.get(pubkey)
        if idx is not None:
            return idx
        # Registry-resident reverse map (one lazy build per registry
        # lineage — a fresh per-state column scan per lookup made
        # sync-aggregate processing ~40% of block time).
        idx = registry.pubkey_index(pubkey)
        if idx is None:
            return None
        self._index_by_pubkey[pubkey] = idx
        return idx


class AttestationSigningRoots:
    """Per-block memo of attestation signing material: the
    ``BEACON_ATTESTER`` domain per target epoch (a block spans at most
    two) and the signing root per ``AttestationData`` VALUE — duplicate
    committee aggregates in one block share the data, and every
    signing-root recompute is ~7 SHA rounds of SSZ hashing the memo
    skips."""

    def __init__(self, state, preset):
        self._state = state
        self._preset = preset
        self._domains: dict[int, bytes] = {}
        self._messages: dict[tuple, bytes] = {}

    def domain(self, epoch: int) -> bytes:
        d = self._domains.get(epoch)
        if d is None:
            d = self._domains[epoch] = get_domain(
                self._state, Domain.BEACON_ATTESTER, epoch, self._preset)
        return d

    def message(self, data) -> bytes:
        key = (int(data.slot), int(data.index),
               bytes(data.beacon_block_root),
               int(data.source.epoch), bytes(data.source.root),
               int(data.target.epoch), bytes(data.target.root))
        m = self._messages.get(key)
        if m is None:
            m = self._messages[key] = compute_signing_root(
                data, self.domain(int(data.target.epoch)))
        return m


def block_proposal_signature_set(state, signed_block, pubkey_cache, preset,
                                 block_root: bytes | None = None) -> SignatureSet:
    block = signed_block.message
    proposer = block.proposer_index
    if proposer != get_beacon_proposer_index(state, preset, slot=block.slot):
        raise SignatureSetError(f"wrong proposer index {proposer}")
    domain = get_domain(state, Domain.BEACON_PROPOSER,
                        compute_epoch_at_slot(block.slot,
                                              preset.SLOTS_PER_EPOCH), preset)
    root = block_root if block_root is not None else block.tree_hash_root()
    return SignatureSet(
        signature=Signature.deserialize(signed_block.signature),
        signing_keys=[pubkey_cache.get(state.validators, proposer)],
        message=compute_signing_root(root, domain))


def randao_signature_set(state, block, pubkey_cache, preset) -> SignatureSet:
    epoch = compute_epoch_at_slot(block.slot, preset.SLOTS_PER_EPOCH)
    domain = get_domain(state, Domain.RANDAO, epoch, preset)
    from ..ssz import uint64 as _u64
    return SignatureSet(
        signature=Signature.deserialize(block.body.randao_reveal),
        signing_keys=[pubkey_cache.get(state.validators, block.proposer_index)],
        message=compute_signing_root(_u64.hash_tree_root(epoch), domain))


def block_header_signature_set(state, signed_header, pubkey_cache,
                               preset) -> SignatureSet:
    header = signed_header.message
    domain = get_domain(state, Domain.BEACON_PROPOSER,
                        compute_epoch_at_slot(header.slot,
                                              preset.SLOTS_PER_EPOCH), preset)
    return SignatureSet(
        signature=Signature.deserialize(signed_header.signature),
        signing_keys=[pubkey_cache.get(state.validators,
                                       header.proposer_index)],
        message=compute_signing_root(header, domain))


def indexed_attestation_signature_set(state, indices, signature_bytes, data,
                                      pubkey_cache, preset,
                                      msg_cache: AttestationSigningRoots
                                      | None = None) -> SignatureSet:
    if msg_cache is not None:
        message = msg_cache.message(data)
    else:
        domain = get_domain(state, Domain.BEACON_ATTESTER, data.target.epoch,
                            preset)
        message = compute_signing_root(data, domain)
    keys = pubkey_cache.get_many(state.validators, indices)
    return SignatureSet(
        signature=Signature.deserialize(signature_bytes),
        signing_keys=keys,
        message=message)


def attestation_signature_set(state, attestation, pubkey_cache,
                              preset) -> SignatureSet:
    indices = get_attesting_indices(
        state, attestation.data, attestation.aggregation_bits, preset)
    return indexed_attestation_signature_set(
        state, indices, attestation.signature, attestation.data,
        pubkey_cache, preset)


def voluntary_exit_signature_set(state, signed_exit, pubkey_cache,
                                 preset) -> SignatureSet:
    exit = signed_exit.message
    domain = get_domain(state, Domain.VOLUNTARY_EXIT, exit.epoch, preset)
    return SignatureSet(
        signature=Signature.deserialize(signed_exit.signature),
        signing_keys=[pubkey_cache.get(state.validators,
                                       exit.validator_index)],
        message=compute_signing_root(exit, domain))


def sync_aggregate_signature_set(state, sync_aggregate, slot: int,
                                 block_root_fn, preset,
                                 pubkey_cache: PubkeyCache | None = None,
                                 ) -> SignatureSet | None:
    """Signature over the previous slot's block root by the participating
    sync-committee subset.  ``block_root_fn(slot)`` supplies the root
    (``sync_committee_verification``-style).  Returns None when no bits are
    set and the signature is infinity (valid empty aggregate).

    With a ``pubkey_cache`` the committee subset materializes through
    one :meth:`PubkeyCache.get_many_bytes` sweep instead of a per-bit
    deserialize loop."""
    bits = np.asarray(sync_aggregate.sync_committee_bits, dtype=bool)
    sig = Signature.deserialize(sync_aggregate.sync_committee_signature)
    if not bits.any():
        if sig.point is None:
            return None
        raise SignatureSetError("non-infinity signature with empty bits")
    previous_slot = max(slot, 1) - 1
    domain = get_domain(state, Domain.SYNC_COMMITTEE,
                        compute_epoch_at_slot(previous_slot,
                                              preset.SLOTS_PER_EPOCH), preset)
    committee = state.current_sync_committee.pubkeys
    sel = np.flatnonzero(bits)
    if pubkey_cache is not None:
        pubkeys = pubkey_cache.get_many_bytes(
            state.validators, [committee[i] for i in sel])
    else:
        pubkeys = [PublicKey.deserialize(committee[i]) for i in sel]
    return SignatureSet(
        signature=sig,
        signing_keys=pubkeys,
        message=compute_signing_root(block_root_fn(previous_slot), domain))


def selection_proof_signature_set(state, slot: int, aggregator_index: int,
                                  selection_proof: bytes, pubkey_cache,
                                  preset) -> SignatureSet:
    """Aggregator slot-selection proof: BLS over the slot
    (``signature_sets.rs`` aggregate selection-proof arm)."""
    from ..ssz import uint64 as _u64
    domain = get_domain(state, Domain.SELECTION_PROOF,
                        compute_epoch_at_slot(slot, preset.SLOTS_PER_EPOCH),
                        preset)
    return SignatureSet(
        signature=Signature.deserialize(selection_proof),
        signing_keys=[pubkey_cache.get(state.validators, aggregator_index)],
        message=compute_signing_root(_u64.hash_tree_root(slot), domain))


def aggregate_and_proof_signature_set(state, signed_aggregate, pubkey_cache,
                                      preset) -> SignatureSet:
    """The aggregator's signature over the AggregateAndProof container
    (``signature_sets.rs`` signed_aggregate arm)."""
    msg = signed_aggregate.message
    slot = int(msg.aggregate.data.slot)
    domain = get_domain(state, Domain.AGGREGATE_AND_PROOF,
                        compute_epoch_at_slot(slot, preset.SLOTS_PER_EPOCH),
                        preset)
    return SignatureSet(
        signature=Signature.deserialize(signed_aggregate.signature),
        signing_keys=[pubkey_cache.get(state.validators,
                                       int(msg.aggregator_index))],
        message=compute_signing_root(msg, domain))


def sync_committee_message_signature_set(state, message, pubkey_cache,
                                         preset) -> SignatureSet:
    """A single sync-committee member's vote over a beacon block root
    (``signature_sets.rs`` sync_committee_message arm)."""
    domain = get_domain(state, Domain.SYNC_COMMITTEE,
                        compute_epoch_at_slot(int(message.slot),
                                              preset.SLOTS_PER_EPOCH),
                        preset)
    return SignatureSet(
        signature=Signature.deserialize(message.signature),
        signing_keys=[pubkey_cache.get(state.validators,
                                       int(message.validator_index))],
        message=compute_signing_root(
            bytes(message.beacon_block_root), domain))


def sync_selection_proof_signature_set(state, contribution_and_proof,
                                       pubkey_cache, preset, T) -> SignatureSet:
    """Sync-subcommittee aggregator selection proof over
    SyncAggregatorSelectionData (``signature_sets.rs``
    sync-selection-proof arm)."""
    c = contribution_and_proof.contribution
    slot = int(c.slot)
    data = T.SyncAggregatorSelectionData(
        slot=slot, subcommittee_index=int(c.subcommittee_index))
    domain = get_domain(state, Domain.SYNC_COMMITTEE_SELECTION_PROOF,
                        compute_epoch_at_slot(slot, preset.SLOTS_PER_EPOCH),
                        preset)
    return SignatureSet(
        signature=Signature.deserialize(
            contribution_and_proof.selection_proof),
        signing_keys=[pubkey_cache.get(
            state.validators, int(contribution_and_proof.aggregator_index))],
        message=compute_signing_root(data, domain))


def contribution_and_proof_signature_set(state, signed_contribution,
                                         pubkey_cache, preset) -> SignatureSet:
    """The sync aggregator's signature over ContributionAndProof
    (``signature_sets.rs`` signed_contribution_and_proof arm)."""
    msg = signed_contribution.message
    slot = int(msg.contribution.slot)
    domain = get_domain(state, Domain.CONTRIBUTION_AND_PROOF,
                        compute_epoch_at_slot(slot, preset.SLOTS_PER_EPOCH),
                        preset)
    return SignatureSet(
        signature=Signature.deserialize(signed_contribution.signature),
        signing_keys=[pubkey_cache.get(state.validators,
                                       int(msg.aggregator_index))],
        message=compute_signing_root(msg, domain))


def bls_to_execution_change_signature_set(state, signed_change,
                                          genesis_fork_version: bytes,
                                          preset) -> SignatureSet:
    """Signed with the GENESIS fork version regardless of current fork
    (capella spec; ``signature_sets.rs`` bls_execution_change arm)."""
    from .helpers import compute_domain
    change = signed_change.message
    domain = compute_domain(Domain.BLS_TO_EXECUTION_CHANGE,
                            genesis_fork_version,
                            state.genesis_validators_root)
    return SignatureSet(
        signature=Signature.deserialize(signed_change.signature),
        signing_keys=[PublicKey.deserialize(change.from_bls_pubkey)],
        message=compute_signing_root(change, domain))


def deposit_signature_set(deposit_data, T,
                          genesis_fork_version: bytes = bytes(4)) -> SignatureSet:
    """Deposits sign over DepositMessage with the genesis fork version and an
    EMPTY genesis_validators_root (spec ``is_valid_deposit_signature``)."""
    from .helpers import compute_domain
    msg = T.DepositMessage(
        pubkey=deposit_data.pubkey,
        withdrawal_credentials=deposit_data.withdrawal_credentials,
        amount=deposit_data.amount)
    domain = compute_domain(Domain.DEPOSIT, genesis_fork_version)
    return SignatureSet(
        signature=Signature.deserialize(deposit_data.signature),
        signing_keys=[PublicKey.deserialize(deposit_data.pubkey)],
        message=compute_signing_root(msg, domain))
