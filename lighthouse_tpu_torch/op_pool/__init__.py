"""Operation pool: pending operations for block production.

Counterpart of ``beacon_node/operation_pool``
(``beacon_node/operation_pool/src/lib.rs``; port of
``lighthouse_tpu/op_pool/__init__.py``): attestations stored compactly per
``AttestationData`` with aggregation-bit merging (the
``attestation_storage.rs`` split/compact idea), plus slashings/exits/
BLS-change pools with per-validator de-duplication (``lib.rs:366``
``get_slashings_and_exits``).

This is the pool's import side: insert, prune and persistence.  Packing
attestations into a block (``get_attestations`` — greedy weighted
max-coverage over :class:`AttMaxCover` candidates, ``max_cover.rs``) is
not ported yet.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Tuple

import numpy as np

from .max_cover import maximum_cover

__all__ = ["OperationPool", "AttMaxCover", "maximum_cover"]


class AttMaxCover:
    """Attestation candidate weighted by effective balances of the NEW
    attesters it would add (`attestation.rs` AttMaxCover; rewards are
    balance-proportional, so balance weight orders candidates the same
    way as the reference's base-reward weight).  Coverage lives in flat
    int64 arrays (``cover_elements`` — max_cover's packed fast path);
    ``covering_set``/``update_covering_set`` keep the dict protocol for
    external callers."""

    def __init__(self, att, fresh_indices: np.ndarray,
                 balances: np.ndarray):
        self.att = att
        self._elems = np.asarray(fresh_indices, dtype=np.int64)
        self._weights = balances[self._elems].astype(np.int64)

    def cover_elements(self):
        return self._elems, self._weights

    def covering_set(self) -> Dict[int, int]:
        return dict(zip(self._elems.tolist(), self._weights.tolist()))

    def update_covering_set(self, covered: Dict[int, int]) -> None:
        if not covered:
            return
        dead = np.fromiter(covered.keys(), np.int64, len(covered))
        keep = ~np.isin(self._elems, dead)
        self._elems = self._elems[keep]
        self._weights = self._weights[keep]


@dataclass
class _StoredAttestation:
    data: object              # AttestationData
    bits: np.ndarray          # bool aggregation bits (committee-sized)
    signature: bytes          # aggregate signature bytes
    committee: np.ndarray     # validator indices for (slot, index)


class OperationPool:
    """Pending ops, keyed for de-duplication, packed on demand."""

    def __init__(self, preset, spec):
        self.preset = preset
        self.spec = spec
        # (data_root, committee_key) → list of compatible aggregates.
        self.attestations: Dict[bytes, List[_StoredAttestation]] = {}
        self.proposer_slashings: Dict[int, object] = {}
        self.attester_slashings: List[object] = []
        self.voluntary_exits: Dict[int, object] = {}
        self.bls_changes: Dict[int, object] = {}
        self.sync_contributions: Dict[Tuple[int, bytes], object] = {}

    # -- attestations --------------------------------------------------------

    def insert_attestation(self, att, committee: np.ndarray) -> None:
        """Merge into an existing aggregate when disjoint, else keep both
        (`lib.rs:198` insert_attestation + naive aggregation)."""
        key = att.data.tree_hash_root()
        bits = np.asarray(att.aggregation_bits, dtype=bool)
        entry = self.attestations.setdefault(key, [])
        for stored in entry:
            if not (stored.bits & bits).any():
                stored.bits = stored.bits | bits
                from ..crypto import bls
                sig_a = bls.Signature.deserialize(stored.signature)
                sig_b = bls.Signature.deserialize(bytes(att.signature))
                stored.signature = bls.aggregate_signatures(
                    [sig_a, sig_b]).serialize()
                return
        entry.append(_StoredAttestation(
            data=att.data, bits=bits.copy(),
            signature=bytes(att.signature),
            committee=np.asarray(committee)))

    def num_attestations(self) -> int:
        return sum(len(v) for v in self.attestations.values())

    # -- slashings / exits / changes ----------------------------------------

    def insert_proposer_slashing(self, slashing) -> None:
        self.proposer_slashings[
            int(slashing.signed_header_1.message.proposer_index)] = slashing

    def insert_attester_slashing(self, slashing) -> None:
        self.attester_slashings.append(slashing)

    def insert_voluntary_exit(self, exit_) -> None:
        self.voluntary_exits[int(exit_.message.validator_index)] = exit_

    def insert_bls_to_execution_change(self, change) -> None:
        self.bls_changes[int(change.message.validator_index)] = change

    def get_slashings_and_exits(self, state) -> Tuple[List, List, List]:
        """Filter against the state: not-yet-slashed / still-exitable
        (`lib.rs:366`)."""
        reg = state.validators
        slashed = reg.col("slashed")
        exiting = reg.col("exit_epoch")
        from ..types.chain_spec import FAR_FUTURE_EPOCH

        proposer = [
            s for i, s in self.proposer_slashings.items()
            if i < len(reg) and not slashed[i]
        ][:self.preset.MAX_PROPOSER_SLASHINGS]

        attester, covered = [], set()
        for s in self.attester_slashings:
            a = set(int(i) for i in s.attestation_1.attesting_indices)
            b = set(int(i) for i in s.attestation_2.attesting_indices)
            both = {i for i in a & b
                    if i < len(reg) and not slashed[i] and i not in covered}
            if both:
                covered |= both
                attester.append(s)
            if len(attester) >= self.preset.MAX_ATTESTER_SLASHINGS:
                break

        exits = [
            e for i, e in self.voluntary_exits.items()
            if i < len(reg) and not slashed[i]
            and int(exiting[i]) == FAR_FUTURE_EPOCH
        ][:self.preset.MAX_VOLUNTARY_EXITS]
        return proposer, attester, exits

    def get_bls_to_execution_changes(self, state) -> List:
        creds = state.validators.col("withdrawal_credentials")
        out = []
        for i, change in self.bls_changes.items():
            if i < creds.shape[0] and creds[i][0] == 0x00:
                out.append(change)
            if len(out) >= self.preset.MAX_BLS_TO_EXECUTION_CHANGES:
                break
        return out

    # -- maintenance ---------------------------------------------------------

    def prune(self, state) -> None:
        """Drop everything no longer includable (`lib.rs` prune_all)."""
        epoch = int(state.slot) // self.preset.SLOTS_PER_EPOCH
        self.attestations = {
            k: [s for s in v
                if int(s.data.slot) // self.preset.SLOTS_PER_EPOCH
                >= epoch - 1]
            for k, v in self.attestations.items()}
        self.attestations = {k: v for k, v in self.attestations.items() if v}
        slashed = state.validators.col("slashed")
        self.proposer_slashings = {
            i: s for i, s in self.proposer_slashings.items()
            if i < slashed.shape[0] and not slashed[i]}
        self.voluntary_exits = {
            i: e for i, e in self.voluntary_exits.items()
            if i < slashed.shape[0] and not slashed[i]}
