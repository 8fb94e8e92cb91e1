"""The port's ``BeaconChain`` on the CPU, against the JAX package's.

The JAX package's ``StateHarness`` (fake BLS backend) builds a MINIMAL
Capella chain of 4 epochs + 1 slot at 16 validators: the blocks carry
full-participation aggregates (so the chain justifies and finalizes),
each slot's unaggregated attestations go through
``process_attestation_batch``, and one side-branch block competes with
the canonical block at its height.  Both packages' chains import the
same bytes, each over ``HotColdDB.memory``:

- after every step the returned root, the head (root, slot) and the
  justified and finalized checkpoints are equal;
- at the end the fork choice node columns, the events published, the
  raw kv rows of every store column (blocks, states, summaries, the
  journal, the cold tier, fork choice, op pool, metadata) and the op
  pool's bytes (``encode_op_pool``) are byte-equal, and the pool packs
  the same attestations for the next slot's block;
- each rejection of ``tests/test_beacon_chain.py`` raises the same class
  from both packages;
- ``persist`` → ``resume`` over a ``SqliteStore`` datadir gives the same
  head, and a datadir the port wrote resumes in the JAX package to the
  same head.

The port's chain runs once with its CPU default fork-choice engine
(numpy) and once with the torch engine on CPU tensors.
"""

import importlib

import pytest
import torch

from lighthouse_tpu.crypto import bls as jbls
from lighthouse_tpu_torch import device
from lighthouse_tpu_torch.crypto import bls as tbls

N_VALIDATORS = 16
CHAIN_SLOTS = 4 * 8 + 1
SIDE_AT = 13          # the side block extends this slot's parent


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


@pytest.fixture(scope="module")
def script():
    """The JAX harness's chain as a list of steps over SSZ bytes:
    ``("tick", slot)``, ``("block", fork, bytes, is_timely)`` and
    ``("atts", [bytes, ...])``."""
    from lighthouse_tpu.state_transition.per_slot import process_slots
    from lighthouse_tpu.testing.harness import StateHarness
    h = StateHarness(N_VALIDATORS)
    genesis = _ser(h.state)
    hdr = h.state.latest_block_header.copy()
    hdr.state_root = h.state.tree_hash_root()
    genesis_root = hdr.tree_hash_root()
    steps = []
    while int(h.state.slot) < CHAIN_SLOTS:
        slot = int(h.state.slot) + 1
        if slot == SIDE_AT + 1:
            slot += 1       # the side block holds this slot
        parent_state = h.state.copy()
        sb = h.build_block(slot)
        h.apply_block(sb)
        steps.append(("tick", slot))
        steps.append(("block", h.fork_at(slot).value, _ser(sb), True))
        adv = process_slots(h.state.copy(), slot + 1, h.preset, h.spec, h.T)
        steps.append(("tick", slot + 1))
        steps.append(("atts", [_ser(a) for a in
                               h.single_attestations_for_slot(adv, slot)]))
        if slot == SIDE_AT:
            # the competing block: the next slot's proposer builds on
            # this block's parent, so the two are siblings
            live, h.state = h.state, parent_state
            side = h.build_block(slot + 1,
                                 graffiti=b"side".ljust(32, b"\x00"))
            h.state = live
            steps.append(("block", h.fork_at(slot + 1).value, _ser(side),
                          True))
    return genesis, genesis_root, steps


def _chain(pkg: str, genesis: bytes, genesis_root: bytes, kv=None):
    """A fresh chain of ``pkg`` at genesis (``kv``: a SqliteStore path)."""
    presets = _mod(pkg, "types.presets")
    factory = _mod(pkg, "types.factory")
    cs = _mod(pkg, "types.chain_spec")
    store = _mod(pkg, "store")
    bc = _mod(pkg, "beacon_chain")
    preset, T = presets.MINIMAL, factory.spec_types(presets.MINIMAL)
    spec = cs.ChainSpec.minimal().with_forks_at_genesis(cs.ForkName.CAPELLA)
    state = T.state_cls(cs.ForkName.CAPELLA).deserialize(genesis)
    db = (store.HotColdDB.memory(preset, spec, T) if kv is None
          else store.HotColdDB(store.SqliteStore(kv), preset, spec, T))
    return bc.BeaconChain(store=db, genesis_state=state,
                          genesis_block_root=genesis_root, preset=preset,
                          spec=spec, T=T)


def _decoders(chain):
    cs = _mod(type(chain).__module__.split(".")[0], "types.chain_spec")
    T = chain.T
    return (lambda fork, data: T.signed_block_cls(cs.ForkName(fork))
            .deserialize(data)), T.Attestation.deserialize


def _head(chain) -> tuple:
    fc = chain.fork_choice
    return (chain.head.root, chain.head.slot, fc.justified_checkpoint,
            fc.finalized_checkpoint)


def _run(chain, steps) -> list:
    """Drive ``chain`` through ``steps``; one record per step."""
    block_of, att_of = _decoders(chain)
    out = []
    for step in steps:
        if step[0] == "tick":
            chain.per_slot_task(step[1])
            out.append(("tick", _head(chain)))
        elif step[0] == "block":
            root = chain.process_block(block_of(step[1], step[2]),
                                       is_timely=step[3])
            assert chain.store.get_block(root) is not None
            out.append(("block", root, _head(chain)))
        else:
            res = chain.process_attestation_batch(
                [att_of(a) for a in step[1]])
            out.append(("atts", [(v is None, type(e).__name__)
                                 for v, e in res], _head(chain)))
    return out


def _events(chain) -> list:
    q = chain.event_bus.subscribe(["block", "head", "finalized_checkpoint",
                                   "attestation"])
    chain._test_events = q
    return q


def _drain(q) -> list:
    out = []
    while not q.empty():
        out.append(q.get_nowait())
    return out


def _node_columns(chain) -> list:
    c = chain.fork_choice.proto.cols
    n = c.n
    return [c.slot[:n].tolist(), c.parent[:n].tolist(), c.weight[:n].tolist(),
            c.best_child[:n].tolist(), c.best_desc[:n].tolist(),
            c.roots[:n].tobytes(), c.justified_epoch[:n].tolist(),
            c.finalized_epoch[:n].tolist()]


def _kv_rows(chain) -> dict:
    kv = chain.store.kv
    rows = {}
    store = _mod(type(chain).__module__.split(".")[0], "store")
    for col in store.DBColumn:
        rows[col.value] = sorted(kv.iter_column(col))
    return rows


@pytest.fixture(scope="module")
def reference_run(script):
    genesis, groot, steps = script
    chain = _chain("lighthouse_tpu", genesis, groot)
    q = _events(chain)
    recs = _run(chain, steps)
    return chain, recs, _drain(q)


@pytest.fixture(scope="module", params=["numpy", "torch"])
def port_run(request, script):
    from lighthouse_tpu_torch.fork_choice import device_proto_array as DPA
    genesis, groot, steps = script
    resolve = DPA._resolve_engine
    DPA._resolve_engine = lambda engine: request.param
    try:
        chain = _chain("lighthouse_tpu_torch", genesis, groot)
        assert chain.fork_choice.proto.engine == request.param
        q = _events(chain)
        recs = _run(chain, steps)
    finally:
        DPA._resolve_engine = resolve
    return chain, recs, _drain(q)


def test_every_step_agrees(reference_run, port_run):
    _, want, _ = reference_run
    _, got, _ = port_run
    assert got == want
    # the side branch: two children of one parent, the head chose one
    heads = {r[-1][0] for r in want}
    assert len(heads) > 10
    final = want[-1][-1]
    assert final[3][0] >= 1, "the chain did not finalize"


def test_side_branch_competes(reference_run, port_run):
    jchain = reference_run[0]
    pchain = port_run[0]
    parents = {}
    for pa in (jchain.fork_choice.proto, pchain.fork_choice.proto):
        nodes = pa.nodes
        kids = {}
        for i, n in enumerate(nodes):
            if n.parent is not None:
                kids.setdefault(n.parent, []).append(i)
        parents[id(pa)] = sorted(len(v) for v in kids.values())
    a, b = parents.values()
    assert a == b and a[-1] == 2


def test_final_columns_events_store_and_pool_are_byte_equal(reference_run,
                                                           port_run):
    from lighthouse_tpu.op_pool.persistence import encode_op_pool as jenc
    from lighthouse_tpu_torch.op_pool.persistence import \
        encode_op_pool as tenc
    jchain, _, jev = reference_run
    pchain, _, pev = port_run
    assert _node_columns(pchain) == _node_columns(jchain)
    assert pev == jev and any(t == "finalized_checkpoint" for t, _ in jev)
    jrows, prows = _kv_rows(jchain), _kv_rows(pchain)
    assert prows.keys() == jrows.keys()
    for col in jrows:
        assert prows[col] == jrows[col], col
    for col in ("blk", "ste", "bss", "jnl", "cbk", "cst", "frk", "opo",
                "bch", "bma"):
        if col in jrows:
            assert jrows[col], col
    assert tenc(pchain.op_pool, pchain.T) == jenc(jchain.op_pool, jchain.T)
    assert pchain.op_pool.num_attestations() > 0
    assert pchain.store.split_slot == jchain.store.split_slot > 0


def _reject_cases(pkg: str):
    """The rejections of ``tests/test_beacon_chain.py``, each as
    (expected class name, a callable that raises it on ``pkg``)."""
    bc = _mod(pkg, "beacon_chain")
    harness = _mod(pkg, "testing.harness")
    presets = _mod(pkg, "types.presets")
    store = _mod(pkg, "store")

    def make_chain(n=16):
        h = harness.StateHarness(n_validators=n, preset=presets.MINIMAL)
        hdr = h.state.latest_block_header.copy()
        hdr.state_root = h.state.tree_hash_root()
        db = store.HotColdDB.memory(h.preset, h.spec, h.T)
        return h, bc.BeaconChain(store=db, genesis_state=h.state.copy(),
                                 genesis_block_root=hdr.tree_hash_root(),
                                 preset=h.preset, spec=h.spec, T=h.T)

    def future():
        h, chain = make_chain()
        chain.process_block(h.build_block())

    def parent_unknown():
        h, chain = make_chain()
        bad = h.build_block()
        bad.message.parent_root = b"\x42" * 32
        chain.per_slot_task(int(bad.message.slot))
        chain.process_block(bad)

    def wrong_proposer():
        h, chain = make_chain()
        bad = h.build_block()
        bad.message.proposer_index = (int(bad.message.proposer_index) + 1) % 16
        chain.per_slot_task(int(bad.message.slot))
        chain.process_block(bad)

    def wrong_root():
        h, chain = make_chain()
        bad = h.build_block()
        bad.message.state_root = b"\x13" * 32
        chain.per_slot_task(int(bad.message.slot))
        chain.process_block(bad)

    def known():
        h, chain = make_chain()
        sb = h.build_block()
        chain.per_slot_task(int(sb.message.slot))
        chain.process_block(sb)
        chain.process_block(sb)

    st = _mod(pkg, "state_transition")
    helpers = _mod(pkg, "state_transition.helpers")
    curve = _mod(pkg, "crypto.curve")
    types = _mod(pkg, "types")

    def bad_signatures():
        """A wrong attestation signature under a valid proposal
        signature: the block's signature batch fails."""
        h, chain = make_chain(8)
        first = h.build_block()
        chain.per_slot_task(int(first.message.slot))
        chain.process_block(first)
        h.apply_block(first)
        sb = h.build_block()
        parent = chain.head.state
        chain.per_slot_task(int(sb.message.slot))
        msg = sb.message
        msg.body.attestations[0].signature = st.interop_secret_key(1).sign(
            b"\x5a" * 32).serialize()
        domain = helpers.get_domain(
            parent, types.Domain.BEACON_PROPOSER,
            int(msg.slot) // h.preset.SLOTS_PER_EPOCH, h.preset)
        sb.signature = st.interop_secret_key(int(msg.proposer_index)).sign(
            helpers.compute_signing_root(msg, domain)).serialize()
        chain.process_block(sb)

    def bad_proposal():
        h, chain = make_chain(8)
        sb = h.build_block()
        chain.per_slot_task(int(sb.message.slot))
        sb.signature = curve.g2_compress(curve.g2_mul(curve.G2_GEN, 12345))
        chain.process_block(sb)

    return {"FutureSlot": future, "ParentUnknown": parent_unknown,
            "IncorrectProposer": wrong_proposer,
            "StateRootMismatch": wrong_root,
            "BlockIsAlreadyKnown": known,
            "InvalidSignatures": bad_signatures,
            "ProposalSignatureInvalid": bad_proposal}


@pytest.mark.parametrize("kind", ["FutureSlot", "ParentUnknown",
                                  "IncorrectProposer", "StateRootMismatch",
                                  "BlockIsAlreadyKnown", "InvalidSignatures",
                                  "ProposalSignatureInvalid"])
def test_rejection_raises_the_same_class(kind, monkeypatch):
    """Each rejection from both packages; the signature cases on their
    python backends (real pairings), the rest on the fake backend."""
    if kind in ("InvalidSignatures", "ProposalSignatureInvalid"):
        monkeypatch.setattr(jbls, "_active", None)
        monkeypatch.setattr(tbls, "_active", None)
        jbls.set_backend("python")
        tbls.set_backend("python")
    names = []
    for pkg in ("lighthouse_tpu", "lighthouse_tpu_torch"):
        with pytest.raises(Exception) as ei:
            _reject_cases(pkg)[kind]()
        names.append((type(ei.value).__name__,
                      type(ei.value).__module__.split(".")[0]))
    assert names == [(kind, "lighthouse_tpu"),
                     (kind, "lighthouse_tpu_torch")]


def test_persist_resume_over_sqlite_in_both_packages(script, tmp_path):
    """The port writes a SQLite datadir; the port's ``resume`` and the JAX
    package's ``resume`` both restore the live head."""
    genesis, groot, steps = script
    path = str(tmp_path / "chain.sqlite")
    live = _chain("lighthouse_tpu_torch", genesis, groot, kv=path)
    _run(live, steps[:len(steps) * 3 // 4])
    live.persist()
    want = _head(live)
    live.store.kv.close()
    for pkg in ("lighthouse_tpu_torch", "lighthouse_tpu"):
        presets = _mod(pkg, "types.presets")
        factory = _mod(pkg, "types.factory")
        cs = _mod(pkg, "types.chain_spec")
        store = _mod(pkg, "store")
        bc = _mod(pkg, "beacon_chain")
        preset, T = presets.MINIMAL, factory.spec_types(presets.MINIMAL)
        spec = cs.ChainSpec.minimal().with_forks_at_genesis(
            cs.ForkName.CAPELLA)
        db = store.HotColdDB(store.SqliteStore(path), preset, spec, T)
        chain = bc.BeaconChain.resume(store=db, preset=preset, spec=spec,
                                      T=T)
        assert _head(chain) == want, pkg
        assert chain.head.state.tree_hash_root() == \
            live.head.state.tree_hash_root()
        db.kv.close()


def test_blob_commitments_need_the_kzg_port():
    """The availability gate with the KZG port: an empty sidecar batch and
    a block without commitments pass; a block with commitments and no
    verified sidecars raises ``BlobsUnavailable`` and lists every index as
    missing."""
    from types import SimpleNamespace
    from lighthouse_tpu_torch.beacon_chain import (BlobsUnavailable,
                                                   DataAvailabilityChecker)
    from lighthouse_tpu_torch.types import MINIMAL
    da = DataAvailabilityChecker(MINIMAL, None)

    def block(commitments):
        return SimpleNamespace(message=SimpleNamespace(
            body=SimpleNamespace(blob_kzg_commitments=commitments)))

    da.check_availability(block([]), b"\x01" * 32)
    da.put_sidecars([])
    with pytest.raises(BlobsUnavailable, match="missing verified blobs"):
        da.check_availability(block([b"\xc0" * 48] * 2), b"\x02" * 32)
    assert da.missing_indices(block([b"\xc0" * 48] * 2),
                              b"\x02" * 32) == [0, 1]


def test_op_pool_packs_like_the_reference(reference_run, port_run):
    """The chain's pool at the end of the run packs, for the next slot's
    block, the same attestations as the JAX package's pool."""
    packed = []
    for chain in (reference_run[0], port_run[0]):
        pkg = type(chain).__module__.split(".")[0]
        per_slot = _mod(pkg, "state_transition.per_slot")
        state = per_slot.process_slots(chain.head.state.copy(),
                                       chain.head.slot + 1, chain.preset,
                                       chain.spec, chain.T)
        packed.append([_ser(a) for a in
                       chain.op_pool.get_attestations(state, chain.T)])
    assert packed[1] == packed[0]
    assert packed[0], "the pool packed nothing"


def test_slo_engine_reads_the_chain_over_fixed_windows(port_run):
    """The chain's SLO engine has no off switch and no knobs: it evaluates
    the chain's import feeds over the module's constant windows and
    budgets."""
    from lighthouse_tpu_torch.common import slo
    chain = port_run[0]
    _b, _c, imported, _s = chain._slo_import_hist.snapshot()
    assert imported > 0
    assert chain._slo_import_attempts >= imported
    report = chain.slo_engine.evaluate()
    assert report["windows"]["fast_s"] == slo.FAST_WINDOW_S
    assert report["windows"]["slow_s"] == slo.SLOW_WINDOW_S
    assert report["hysteresis"] == slo.HYSTERESIS
    rows = {r["name"]: r for r in report["objectives"]}
    assert rows["block_import"]["budget_ms"] == slo.BLOCK_IMPORT_MS
    assert rows["shed_rate"]["budget"] == slo.SHED_PCT / 100.0
    assert report["state"] == slo.HEALTHY
    assert chain.slo_engine.health()["state"] == slo.HEALTHY
