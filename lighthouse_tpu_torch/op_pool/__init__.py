"""Operation pool: pending operations for block production.

Counterpart of ``beacon_node/operation_pool``
(``beacon_node/operation_pool/src/lib.rs``; port of
``lighthouse_tpu/op_pool/__init__.py``): attestations stored compactly per
``AttestationData`` with aggregation-bit merging (the
``attestation_storage.rs`` split/compact idea), block packing by greedy
weighted max-coverage (``max_cover.rs``, ``attestation.rs`` AttMaxCover;
a backlogged pool packs through the rounds of :mod:`.device_pack`), plus
slashings/exits/BLS-change pools with per-validator de-duplication
(``lib.rs:366`` ``get_slashings_and_exits``).
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Dict, List, Tuple

import numpy as np

from ..types.device_state import DeviceColumn
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

    def get_attestations(self, state, T) -> List:
        """Pack ≤ MAX_ATTESTATIONS by greedy max-cover over fresh attester
        balances (`lib.rs:248` get_attestations)."""
        slot = int(state.slot)
        epoch = slot // self.preset.SLOTS_PER_EPOCH
        balances = state.validators.col("effective_balance")
        # Freshness is per-epoch: an attestation for epoch E only rewards
        # validators not yet credited in E's participation flags
        # (current vs previous — mixing them mis-weights boundary packing).
        n_vals = balances.shape[0]
        seen_cur = np.zeros(n_vals, bool)
        seen_prev = np.zeros(n_vals, bool)
        if hasattr(state, "current_epoch_participation"):
            cur_part = _host_column(state.current_epoch_participation)
            if cur_part.size:
                seen_cur[:cur_part.shape[0]] = cur_part != 0
            prev_part = _host_column(state.previous_epoch_participation)
            if prev_part.size:
                seen_prev[:prev_part.shape[0]] = prev_part != 0
        # else: phase0 — no participation flags; credited attesters live in
        # state.{previous,current}_epoch_attestations whose bits→index
        # resolution needs the committee shuffle, so every attester counts
        # as fresh (over-weighting only costs packing optimality, never
        # validity).
        # Candidates must also pass the reference's curr/prev-epoch validity
        # filters (`attestation.rs` validity_filter): an attestation whose
        # source disagrees with the proposal state's justified checkpoint
        # would fail process_attestation in the very block we pack it into.
        def _cp_key(cp):
            return (int(cp.epoch), bytes(cp.root))

        want_cur = _cp_key(state.current_justified_checkpoint)
        want_prev = _cp_key(state.previous_justified_checkpoint)
        candidates = []       # (stored, is_current_epoch)
        for entry in self.attestations.values():
            if not entry:
                continue
            # Every aggregate in a group shares the same AttestationData
            # (the dict key is its root) — filter once per group.
            data = entry[0].data
            att_slot = int(data.slot)
            att_epoch = att_slot // self.preset.SLOTS_PER_EPOCH
            if att_slot + self.preset.MIN_ATTESTATION_INCLUSION_DELAY > slot:
                continue
            if slot > att_slot + self.preset.SLOTS_PER_EPOCH:
                # Upper inclusion bound: process_attestation enforces
                # slot ≤ att_slot + SLOTS_PER_EPOCH, which is TIGHTER
                # than the epoch filter below near an epoch boundary.
                continue
            if att_epoch not in (epoch, epoch - 1):
                continue
            want = want_cur if att_epoch == epoch else want_prev
            if _cp_key(data.source) != want:
                continue
            candidates.extend((stored, att_epoch == epoch)
                              for stored in entry)
        if len(candidates) >= 2048:
            chosen = _pack_columnar(candidates, balances, seen_cur,
                                    seen_prev, self.preset.MAX_ATTESTATIONS)
        else:
            covers = []
            for stored, is_cur in candidates:
                seen = seen_cur if is_cur else seen_prev
                idx = np.asarray(
                    stored.committee[stored.bits[:len(stored.committee)]],
                    dtype=np.int64)
                fresh = idx[~seen[idx]]
                if fresh.size == 0:
                    continue
                covers.append(AttMaxCover(stored, fresh, balances))
            chosen = [c.att for c in
                      maximum_cover(covers, self.preset.MAX_ATTESTATIONS)]
        return [self._to_attestation(c, T) for c in chosen]

    def _to_attestation(self, stored: _StoredAttestation, T):
        return T.Attestation(
            aggregation_bits=stored.bits[:len(stored.committee)].tolist(),
            data=stored.data,
            signature=stored.signature)

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


def _host_column(col) -> np.ndarray:
    """A state column's values on the host; a device-resident column the
    device is ahead of is pulled under the ledger's ``op_pool``
    subsystem."""
    if isinstance(col, DeviceColumn):
        return col.host("op_pool")
    return np.asarray(col)


def _pack_columnar(candidates, balances, seen_cur, seen_prev,
                   limit: int) -> List:
    """Columnar greedy max-cover — same greedy (heaviest-first, earliest
    tie-break, winners' coverage struck from the rest) as
    :func:`max_cover.maximum_cover`, expressed over flat CSR arrays feeding
    the pack rounds of :mod:`.device_pack` (the host CELF
    :func:`max_cover.greedy_pack` is the tests' oracle), so a backlogged
    pool packs in device time, not Python-dict time (the 100k-candidate
    BASELINE row-5 shape).  Freshness is resolved per candidate epoch
    against the participation state in one flat gather.  CSR-build /
    coverage / select phase timings land in the ``op_pool`` tracing stage
    source."""
    # looked up at call time: chip_smoke.py swaps the host CELF oracle in
    # to time it on the same pool
    from .device_pack import greedy_pack_device

    t0 = time.perf_counter()
    N = len(candidates)
    ws = np.fromiter((len(s.committee) for s, _ in candidates),
                     np.int64, N)
    bounds = np.zeros(N + 1, dtype=np.int64)
    np.cumsum(ws, out=bounds[1:])
    # int32 ids: the flat passes below are memory-bandwidth bound.
    flat_comm = np.concatenate(
        [np.asarray(s.committee) for s, _ in candidates],
        dtype=np.int32, casting="unsafe")
    flat_bit = np.concatenate(
        [np.asarray(s.bits[:w], bool)
         for (s, _), w in zip(candidates, ws)])
    # Mask by aggregation bits FIRST so the freshness gathers touch only
    # set members (~half the flat length); candidate segment bounds track
    # through the compactions via searchsorted/cumsum instead of a
    # full-length candidate-id column.
    attesting = np.flatnonzero(flat_bit)
    att_bounds = np.searchsorted(attesting, bounds)
    att_comm = flat_comm[attesting]
    csr_build_ms = (time.perf_counter() - t0) * 1e3
    t1 = time.perf_counter()
    is_cur = np.fromiter((cur for _, cur in candidates), bool, N)
    att_cur = np.repeat(is_cur, np.diff(att_bounds))
    seen_flat = np.empty(attesting.shape[0], dtype=bool)
    seen_flat[att_cur] = seen_cur[att_comm[att_cur]]
    not_cur = ~att_cur
    seen_flat[not_cur] = seen_prev[att_comm[not_cur]]
    fresh = ~seen_flat
    cfs = np.zeros(attesting.shape[0] + 1, dtype=np.int64)
    np.cumsum(fresh, out=cfs[1:])
    offsets = cfs[att_bounds]
    flat_e = att_comm[fresh]
    flat_w = balances[flat_e].astype(np.int64)
    coverage_ms = (time.perf_counter() - t1) * 1e3
    chosen = greedy_pack_device(flat_e, flat_w, offsets, balances.shape[0],
                                limit, csr_build_ms=csr_build_ms,
                                coverage_ms=coverage_ms)
    return [candidates[b][0] for b in chosen]


def bench_pack_attestations(n_atts: int, n_validators: int = 1 << 20,
                            seed: int = 0) -> Tuple[float, int]:
    """BASELINE row 5: time ``get_attestations`` max-cover packing over
    ``n_atts`` pooled aggregates (reference workload:
    ``operation_pool/src/lib.rs:248`` at a backlogged pool).

    Synthetic but structurally faithful: aggregates spread over the
    previous 32 slots × 64 committee indices (distinct ``AttestationData``
    per (slot, index)), 128-member committees drawn from a 2^20-validator
    registry, random half-full aggregation bits, empty participation (every
    attester fresh).  Returns (milliseconds, packed-count); the pool and
    the state are built outside the timed window."""
    pool, state, T = bench_pool(n_atts, n_validators, seed)
    t0 = time.perf_counter()
    packed = pool.get_attestations(state, T)
    ms = (time.perf_counter() - t0) * 1e3
    return ms, len(packed)


def bench_pool(n_atts: int, n_validators: int = 1 << 20, seed: int = 0):
    """The pool and proposal state :func:`bench_pack_attestations` packs:
    (pool, state, T)."""
    from types import SimpleNamespace
    from ..types.presets import MAINNET
    from ..types.factory import spec_types

    preset = MAINNET
    T = spec_types(MAINNET)
    pool = OperationPool(preset, None)
    rng = np.random.default_rng(seed)
    slot = 100
    cur_src = T.Checkpoint(epoch=2, root=b"\x22" * 32)
    prev_src = T.Checkpoint(epoch=1, root=b"\x11" * 32)
    datas = []
    for s in range(slot - 32, slot):
        epoch = s // preset.SLOTS_PER_EPOCH
        src = cur_src if epoch == slot // preset.SLOTS_PER_EPOCH else prev_src
        for index in range(64):
            datas.append(T.AttestationData(
                slot=s, index=index,
                beacon_block_root=bytes(rng.integers(0, 256, 32, np.uint8)),
                source=src,
                target=T.Checkpoint(epoch=epoch, root=b"\x33" * 32)))
    per_data = max(1, n_atts // len(datas))
    total = 0
    for data in datas:
        if total >= n_atts:
            break
        key = data.tree_hash_root()
        committee = rng.choice(n_validators, 128, replace=False)
        entry = pool.attestations.setdefault(key, [])
        for _ in range(min(per_data, n_atts - total)):
            bits = rng.random(128) < 0.5
            entry.append(_StoredAttestation(
                data=data, bits=bits, signature=b"\x00" * 96,
                committee=committee))
            total += 1

    class _Reg:
        def __init__(self, bal):
            self._bal = bal

        def col(self, name):
            return self._bal

    balances = np.full(n_validators, 32 * 10**9, np.uint64)
    state = SimpleNamespace(
        slot=slot, validators=_Reg(balances),
        current_epoch_participation=np.zeros(n_validators, np.uint8),
        previous_epoch_participation=np.zeros(n_validators, np.uint8),
        current_justified_checkpoint=cur_src,
        previous_justified_checkpoint=prev_src)
    return pool, state, T
