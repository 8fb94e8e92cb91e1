"""Block production in the port on the CPU, against the JAX package.

Every comparison is exact (selection order, SSZ bytes, roots), so no
tolerance is stated.

1. **Pack rounds.** The port's torch rounds (on CPU tensors) against
   the JAX package's ``_pack_rounds_numpy`` and its host CELF
   ``greedy_pack`` on seeded CSR pools: random pools,
   tie-heavy weights, ``limit`` below the candidate count, prefixes that
   straddle what were the JAX package's pow2 buckets, and elements with
   ``e % 64 == 63`` (the int64 sign bit of a bitset word); empty and
   singleton pools.
2. **``get_attestations``.** Both packages' ``OperationPool`` fed the
   same SSZ-decoded aggregates over a harness state with participation
   set, below and above the 2048-candidate columnar threshold, with
   aggregates outside the inclusion window and with a mismatched source:
   the packed ``Attestation`` bytes are equal, in order.
   ``bench_pack_attestations`` at 4096 aggregates over 2^14 validators
   packs the same list as the JAX package's.
3. **Production.** Both packages' ``BeaconChain`` import the same
   MINIMAL chain; ``produce_block_components`` gives the same proposer,
   parent root, attestations, slashings, exits and changes; the adopted
   and serial routes are equal; the cached advanced state is unchanged
   after production; a head change discards the advanced state;
   ``stage_split("op_pool")`` has the JAX package's keys, with the
   device in place of the engine.
"""

import importlib

import numpy as np
import pytest
import torch

from lighthouse_tpu.crypto import bls as jbls
from lighthouse_tpu.op_pool import device_pack as JDP
from lighthouse_tpu.op_pool.max_cover import greedy_pack
from lighthouse_tpu_torch import device
from lighthouse_tpu_torch.common import tracing as ttr
from lighthouse_tpu_torch.crypto import bls as tbls
from lighthouse_tpu_torch.op_pool import device_pack as TDP

INFINITY_SIG = b"\xc0" + b"\x00" * 95


@pytest.fixture(autouse=True, scope="module")
def _cpu():
    prev, threads = device.default_device(), torch.get_num_threads()
    device.set_default_device("cpu")
    torch.set_num_threads(1)
    jprev, tprev = jbls._active, tbls._active
    jbls.set_backend("fake")
    tbls.set_backend("fake")
    yield
    jbls._active, tbls._active = jprev, tprev
    device.set_default_device(prev)
    torch.set_num_threads(threads)


def _ser(obj) -> bytes:
    return type(obj).serialize(obj)


def _mod(pkg: str, name: str):
    return importlib.import_module(f"{pkg}.{name}")


# ---------------------------------------------------------------------------
# 1. Pack engines
# ---------------------------------------------------------------------------

def _csr(segments):
    offsets = np.zeros(len(segments) + 1, np.int64)
    np.cumsum([s.size for s in segments], out=offsets[1:])
    flat_e = (np.concatenate(segments).astype(np.int64) if segments
              else np.empty(0, np.int64))
    return flat_e, offsets


def _random_pool(rng, n_cands, n_validators=512, ties=False, high=False):
    """A CSR pool biased to the adversarial corners (duplicate, empty,
    singleton, overlapping and disjoint candidates), with weights drawn
    from three balances (one balance when ``ties``); ``high`` maps every
    element id to ``64 k + 63``."""
    segments = []
    shared = rng.choice(n_validators, 64, replace=False)
    for _ in range(n_cands):
        kind = rng.integers(0, 10)
        if kind == 0 and segments:
            segments.append(segments[rng.integers(0, len(segments))])
        elif kind == 1:
            segments.append(np.empty(0, np.int64))
        elif kind == 2:
            segments.append(rng.choice(n_validators, 1))
        elif kind <= 6:
            segments.append(np.sort(rng.choice(
                shared, int(rng.integers(1, 17)), replace=False)))
        else:
            segments.append(rng.choice(
                n_validators, int(rng.integers(1, 17)), replace=False))
    flat_e, offsets = _csr(segments)
    n_elements = n_validators
    if high:
        flat_e = flat_e * 64 + 63
        n_elements = n_validators * 64
    if ties:
        flat_w = np.full(flat_e.shape[0], 32 * 10**9, np.int64)
    else:
        balances = rng.choice(np.array([31, 32, 2048], np.int64) * 10**9,
                              n_elements)
        flat_w = balances[flat_e]
    return flat_e, flat_w, offsets, n_elements


def _pools(case: str, seed: int):
    """(flat_e, flat_w, offsets, n_elements, limit) pools of one case."""
    rng = np.random.default_rng(seed)
    if case == "random":
        return [(*_random_pool(rng, n), 16)
                for n in (0, 1, 2, 3, 5, 9, 17, 40, 90, 200)]
    if case == "ties":
        return [(*_random_pool(rng, n, ties=True), 16)
                for n in (2, 9, 40, 120)]
    if case == "limit":
        return [(*_random_pool(rng, 150), limit) for limit in (1, 2, 5, 9)]
    if case == "buckets":
        flat_e, flat_w, offsets, n_el = _random_pool(rng, 140)
        out = []
        for cut in (7, 8, 9, 63, 64, 65, 127, 128, 129, 140):
            o = offsets[:cut + 1]
            out.append((flat_e[:o[-1]], flat_w[:o[-1]], o, n_el, 8))
        return out
    assert case == "bit63"
    out = [(*_random_pool(rng, n, high=True), 16) for n in (5, 40, 150)]
    # every element in the same word, bit 63 among them
    e = np.array([63, 62, 0, 63, 1, 63, 2], np.int64)
    out.append((e, np.full(7, 32, np.int64), np.array([0, 3, 5, 7]), 64, 4))
    return out


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("case", ["random", "ties", "limit", "buckets",
                                  "bit63"])
def test_pack_engines_equal_the_reference(case, seed):
    for flat_e, flat_w, offsets, n_el, limit in _pools(case, seed):
        celf, _, _ = greedy_pack(flat_e, flat_w, offsets, n_el, limit)
        ref = JDP._pack_rounds_numpy(flat_e, flat_w, offsets, n_el, limit)
        assert list(ref) == list(celf)
        got = TDP.greedy_pack_device(flat_e, flat_w, offsets, n_el, limit)
        assert got == list(celf), (case, seed, offsets.size)


def test_pack_empty_singleton_and_ties():
    empty = np.empty(0, np.int64)
    # two identical candidates + a disjoint lighter one: the EARLIER
    # duplicate first, the lighter one second, never the other duplicate
    tie = (np.array([5, 6, 7, 5, 6, 7, 9], np.int64),
           np.array([32, 32, 32, 32, 32, 32, 31], np.int64),
           np.array([0, 3, 6, 7], np.int64))
    pack = TDP.greedy_pack_device
    assert pack(empty, empty, np.zeros(1, np.int64), 64, 8) == []
    assert pack(empty, empty, np.zeros(2, np.int64), 64, 8) == []
    assert pack(np.array([3]), np.array([32]), np.array([0, 1]), 64, 8) \
        == [0]
    assert pack(*tie, 16, 4) == [0, 2]
    assert pack(*tie, 16, 0) == []


def test_engine_follows_the_device_and_the_model_reads_the_card():
    tie = (np.array([5, 6, 7, 5, 6, 7, 9], np.int64),
           np.array([32, 32, 32, 32, 32, 32, 31], np.int64),
           np.array([0, 3, 6, 7], np.int64))
    TDP.reset_stats()
    assert TDP.greedy_pack_device(*tie, 16, 4) == [0, 2]
    assert TDP.LAST_PACK_STATS["device"] == "cpu"
    prev = device.default_device()
    device.set_default_device("cuda")
    try:
        if not torch.cuda.is_available():   # no host fallback
            with pytest.raises(RuntimeError, match="no CUDA device"):
                TDP.greedy_pack_device(*tie, 16, 4)
    finally:
        device.set_default_device(prev)
    # BASELINE row 5's shape: 6,291,993 entries, 98,304 candidates, 128
    # rounds of 16 B an entry and 16 B a candidate over 3.35 TB/s
    ms = TDP.modeled_pack_ms(6_291_993, 98_304, 128)
    want = 128 * (6_291_993 * 16 + 98_304 * 16) / 3.35e12 * 1e3
    assert ms == pytest.approx(want, rel=1e-12)
    assert 3.8 < ms < 4.0


# ---------------------------------------------------------------------------
# 2. get_attestations
# ---------------------------------------------------------------------------

POOL_VALIDATORS = 64
POOL_SLOT = 12           # the proposal slot; the harness chain ends at 11


@pytest.fixture(scope="module")
def pool_state():
    """A MINIMAL Capella state at slot 12 after 11 full-participation
    blocks at 64 validators, with half of each participation column's
    flags cleared (seeded), as SSZ bytes; and the per-committee
    ``(committee, AttestationData bytes)`` of slots 1-11."""
    from lighthouse_tpu.state_transition.per_slot import process_slots
    from lighthouse_tpu.testing.harness import StateHarness
    h = StateHarness(POOL_VALIDATORS)
    h.extend_chain(POOL_SLOT - 1)
    st = process_slots(h.state.copy(), POOL_SLOT, h.preset, h.spec, h.T)
    rng = np.random.default_rng(3)
    for name in ("current_epoch_participation",
                 "previous_epoch_participation"):
        flags = np.asarray(getattr(st, name)).copy()
        flags[rng.random(flags.shape[0]) < 0.5] = 0
        setattr(st, name, flags)
    groups = []
    for s in range(1, POOL_SLOT):
        for _, committee, data, _ in h._committee_att_data(st, s):
            groups.append((np.asarray(committee, np.int64), _ser(data)))
    # a group whose source is no justified checkpoint of the state
    committee, data = groups[-1]
    bad = h.T.AttestationData.deserialize(data)
    bad.source.root = b"\x5a" * 32
    groups.append((committee, _ser(bad)))
    return _ser(st), groups


def _aggregates(groups, per_group: int, seed: int) -> list:
    """(committee, Attestation SSZ) with random bits, the committee's
    first member always among them (so no two aggregates are disjoint and
    none merge in the pool)."""
    from lighthouse_tpu.types.factory import spec_types
    from lighthouse_tpu.types.presets import MINIMAL
    T = spec_types(MINIMAL)
    rng = np.random.default_rng(seed)
    out = []
    for committee, data in groups:
        d = T.AttestationData.deserialize(data)
        for _ in range(per_group):
            bits = rng.random(committee.shape[0]) < 0.5
            bits[0] = True
            out.append((committee, _ser(T.Attestation(
                aggregation_bits=bits.tolist(), data=d,
                signature=INFINITY_SIG))))
    return out


def _packed(pkg: str, state_bytes: bytes, aggregates) -> list:
    presets = _mod(pkg, "types.presets")
    factory = _mod(pkg, "types.factory")
    cs = _mod(pkg, "types.chain_spec")
    op_pool = _mod(pkg, "op_pool")
    preset, T = presets.MINIMAL, factory.spec_types(presets.MINIMAL)
    state = T.state_cls(cs.ForkName.CAPELLA).deserialize(state_bytes)
    pool = op_pool.OperationPool(preset, None)
    for committee, att in aggregates:
        pool.insert_attestation(T.Attestation.deserialize(att), committee)
    return [_ser(a) for a in pool.get_attestations(state, T)]


@pytest.mark.parametrize("per_group,columnar", [(3, False), (150, True)])
def test_get_attestations_packs_the_same_bytes(pool_state, per_group,
                                               columnar):
    state_bytes, groups = pool_state
    aggs = _aggregates(groups, per_group, seed=per_group)
    JDP.reset_stats()
    want = _packed("lighthouse_tpu", state_bytes, aggs)
    assert want and len(want) <= 128
    assert ("candidates" in JDP.LAST_PACK_STATS) == columnar
    if columnar:
        assert JDP.LAST_PACK_STATS["candidates"] >= 2048
    TDP.reset_stats()
    assert _packed("lighthouse_tpu_torch", state_bytes, aggs) == want
    assert ("candidates" in TDP.LAST_PACK_STATS) == columnar
    if columnar:
        assert TDP.LAST_PACK_STATS["device"] == "cpu"
        assert (TDP.LAST_PACK_STATS["candidates"]
                == JDP.LAST_PACK_STATS["candidates"])
    # the filters held: nothing outside the inclusion window (slots 4-11
    # at slot 12) and nothing with the mismatched source
    from lighthouse_tpu.types.factory import spec_types
    from lighthouse_tpu.types.presets import MINIMAL
    T = spec_types(MINIMAL)
    bad_source = T.AttestationData.deserialize(groups[-1][1]).source
    for a in want:
        data = T.Attestation.deserialize(a).data
        assert POOL_SLOT - 8 <= int(data.slot) <= POOL_SLOT - 1
        assert bytes(data.source.root) != bytes(bad_source.root)


def test_get_attestations_reads_a_device_resident_state(pool_state):
    """On a materialized state whose participation columns the device is
    ahead of (adopted tensors, as after the epoch sweep on the card), the
    pool reads the columns as they are, pulled under the ledger's
    ``op_pool`` subsystem, and packs what the JAX package packs."""
    from lighthouse_tpu_torch.common.device_ledger import LEDGER
    from lighthouse_tpu_torch.op_pool import OperationPool
    from lighthouse_tpu_torch.types import MINIMAL, ForkName
    from lighthouse_tpu_torch.types.device_state import (materialize_state,
                                                         store_column)
    from lighthouse_tpu_torch.types.factory import spec_types
    state_bytes, groups = pool_state
    aggs = _aggregates(groups, 3, seed=5)
    want = _packed("lighthouse_tpu", state_bytes, aggs)
    T = spec_types(MINIMAL)
    state = T.state_cls(ForkName.CAPELLA).deserialize(state_bytes)
    assert materialize_state(state)
    for name in ("current_epoch_participation",
                 "previous_epoch_participation"):
        flags = np.asarray(getattr(state, name)).copy()
        store_column(state, name, torch.from_numpy(flags))
    pool = OperationPool(MINIMAL, None)
    for committee, att in aggs:
        pool.insert_attestation(T.Attestation.deserialize(att), committee)
    before = LEDGER.transfer_totals()["op_pool"][1]
    assert [_ser(a) for a in pool.get_attestations(state, T)] == want
    pulled = LEDGER.transfer_totals()["op_pool"][1] - before
    assert pulled == 2 * len(state.validators)


def test_bench_pack_attestations_packs_the_same_list(monkeypatch):
    from lighthouse_tpu import op_pool as jop
    from lighthouse_tpu_torch import op_pool as top
    seen = {}
    get = jop.OperationPool.get_attestations

    def spy(self, state, T):
        seen["packed"] = get(self, state, T)
        return seen["packed"]

    monkeypatch.setattr(jop.OperationPool, "get_attestations", spy)
    _, n_ref = jop.bench_pack_attestations(4096, 1 << 14)
    want = [_ser(a) for a in seen["packed"]]
    assert n_ref == len(want) == 128
    pool, state, T = top.bench_pool(4096, 1 << 14)
    TDP.reset_stats()
    packed = [_ser(a) for a in pool.get_attestations(state, T)]
    assert packed == want
    assert TDP.LAST_PACK_STATS["device"] == "cpu"
    _, n = top.bench_pack_attestations(4096, 1 << 14)
    assert n == n_ref


# ---------------------------------------------------------------------------
# 3. Production through BeaconChain
# ---------------------------------------------------------------------------

CHAIN_VALIDATORS = 16
CHAIN_BLOCKS = 10         # slots 1-10: crosses the epoch boundary at 8


@pytest.fixture(scope="module")
def chain_script():
    """The JAX harness's chain as SSZ: genesis, the blocks of slots 1-10
    each followed by its slot's unaggregated attestations, a block for
    slot 11 (the head change), and a proposer slashing, an exit and a
    BLS change for the pool."""
    from lighthouse_tpu.state_transition.per_slot import process_slots
    from lighthouse_tpu.testing.harness import StateHarness
    h = StateHarness(CHAIN_VALIDATORS)
    genesis = _ser(h.state)
    hdr = h.state.latest_block_header.copy()
    hdr.state_root = h.state.tree_hash_root()
    steps = []
    for slot in range(1, CHAIN_BLOCKS + 1):
        sb = h.build_block(slot)
        h.apply_block(sb)
        adv = process_slots(h.state.copy(), slot + 1, h.preset, h.spec, h.T)
        steps.append((slot, _ser(sb), [
            _ser(a) for a in h.single_attestations_for_slot(adv, slot)]))
    ops = (_ser(h.make_proposer_slashing(h.state, 3)),
           _ser(h.make_exit(h.state, 5)),
           _ser(h.make_bls_to_execution_change(7)))
    nxt = h.build_block(CHAIN_BLOCKS + 1)
    return genesis, hdr.tree_hash_root(), steps, ops, _ser(nxt)


def _chain_at_head(pkg: str, script):
    genesis, groot, steps, ops, _ = script
    presets = _mod(pkg, "types.presets")
    factory = _mod(pkg, "types.factory")
    cs = _mod(pkg, "types.chain_spec")
    store = _mod(pkg, "store")
    bc = _mod(pkg, "beacon_chain")
    preset, T = presets.MINIMAL, factory.spec_types(presets.MINIMAL)
    spec = cs.ChainSpec.minimal().with_forks_at_genesis(cs.ForkName.CAPELLA)
    chain = bc.BeaconChain(
        store=store.HotColdDB.memory(preset, spec, T),
        genesis_state=T.state_cls(cs.ForkName.CAPELLA).deserialize(genesis),
        genesis_block_root=groot, preset=preset, spec=spec, T=T)
    block_cls = T.signed_block_cls(cs.ForkName.CAPELLA)
    for slot, block, atts in steps:
        chain.per_slot_task(slot)
        chain.process_block(block_cls.deserialize(block), is_timely=True)
        chain.per_slot_task(slot + 1)
        res = chain.process_attestation_batch(
            [T.Attestation.deserialize(a) for a in atts])
        assert all(v is not None for v, _ in res)
    chain.op_pool.insert_proposer_slashing(
        T.ProposerSlashing.deserialize(ops[0]))
    chain.op_pool.insert_voluntary_exit(
        T.SignedVoluntaryExit.deserialize(ops[1]))
    chain.op_pool.insert_bls_to_execution_change(
        T.SignedBLSToExecutionChange.deserialize(ops[2]))
    return chain


def _parts(parts) -> tuple:
    return (parts["slot"], parts["proposer_index"], parts["parent_root"],
            [_ser(a) for a in parts["attestations"]],
            [_ser(s) for s in parts["proposer_slashings"]],
            [_ser(s) for s in parts["attester_slashings"]],
            [_ser(e) for e in parts["voluntary_exits"]],
            [_ser(c) for c in parts["bls_to_execution_changes"]],
            bytes(parts["state"].tree_hash_root()))


@pytest.fixture(scope="module")
def chains(chain_script):
    return (_chain_at_head("lighthouse_tpu", chain_script),
            _chain_at_head("lighthouse_tpu_torch", chain_script))


REVEAL = b"\x00" * 96


def test_produce_block_components_equal_the_reference(chains):
    jchain, pchain = chains
    assert pchain.head.root == jchain.head.root
    target = pchain.head.slot + 1
    JDP.reset_stats()
    TDP.reset_stats()
    adopted0 = pchain._produce_adopted
    for c in chains:
        c.on_three_quarters_slot(target - 1)
        c.produce_block_components(target, REVEAL)
    assert JDP.LAST_PACK_STATS["adopted"] == 1
    assert pchain._produce_adopted == adopted0 + 1
    # below 2048 candidates no round ran, and the route is the chain's
    assert TDP.LAST_PACK_STATS == {}
    assert set(ttr.stage_split("production")) == {"copy_ms", "advance_ms"}
    want = _parts(jchain.produce_block_components(target, REVEAL))
    got = _parts(pchain.produce_block_components(target, REVEAL))
    assert got == want
    assert got[3], "no attestation was packed"
    assert got[4] and got[6] and got[7], "a pool of operations was empty"


def test_adopted_equals_serial_and_leaves_the_cache_alone(chains):
    pchain = chains[1]
    head = pchain.head
    target = head.slot + 1
    pchain.on_three_quarters_slot(head.slot)
    cached = pchain._advanced_states[(head.root, target)]
    before = (_ser(cached), cached.tree_hash_root(),
              _ser(head.state), head.state.tree_hash_root())
    adopted0, serial0 = pchain._produce_adopted, pchain._produce_serial
    produced = pchain.produce_block_components(target, REVEAL)
    assert pchain._produce_adopted == adopted0 + 1
    assert ttr.stage_split("production")["copy_ms"] >= 0
    adopted = _parts(produced)
    produced["state"].slot = 9999              # a caller-side write
    produced["state"].balances[0] = 1          # a write to a column
    assert (_ser(cached), cached.tree_hash_root(), _ser(head.state),
            head.state.tree_hash_root()) == before
    del pchain._advanced_states[(head.root, target)]
    serial = pchain.produce_block_components(target, REVEAL)
    assert pchain._produce_serial == serial0 + 1
    assert _parts(serial) == adopted


def test_a_head_change_discards_the_advanced_state(chain_script):
    from lighthouse_tpu_torch.types import ForkName
    pchain = _chain_at_head("lighthouse_tpu_torch", chain_script)
    old = pchain.head
    pchain.on_three_quarters_slot(old.slot)
    primed = pchain._advanced_states[(old.root, old.slot + 1)]
    before = (_ser(primed), primed.tree_hash_root())
    nxt = pchain.T.signed_block_cls(ForkName.CAPELLA).deserialize(
        chain_script[4])
    pchain.per_slot_task(old.slot + 1)
    pchain.process_block(nxt, is_timely=True)
    assert pchain.head.root != old.root
    serial0 = pchain._produce_serial
    parts = pchain.produce_block_components(pchain.head.slot + 1, REVEAL)
    assert pchain._produce_serial == serial0 + 1
    assert pchain._produce_adopted == 0
    assert int(parts["state"].slot) == pchain.head.slot + 1
    assert parts["parent_root"] == pchain.head.root
    assert (_ser(primed), primed.tree_hash_root()) == before


def test_pack_stage_split_has_the_reference_keys():
    from lighthouse_tpu.common import tracing as jtr
    pool = _pools("random", 5)[-1]
    JDP.reset_stats()
    JDP.greedy_pack_device(*pool, engine="numpy", csr_build_ms=1.0,
                           coverage_ms=2.0)
    want = jtr.stage_split("op_pool")
    TDP.reset_stats()
    TDP.greedy_pack_device(*pool, csr_build_ms=1.0, coverage_ms=2.0)
    got = ttr.stage_split("op_pool")
    # one route: the device the rounds ran on in place of the engine,
    # and the push of the CSR columns
    assert got.keys() == want.keys() - {"engine"} | {"device", "stage_ms"}
    assert got["device"] == "cpu"
    for k in ("candidates", "entries", "rounds", "selected",
              "csr_build_ms", "coverage_ms"):
        assert got[k] == want[k], k
