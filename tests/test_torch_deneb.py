"""Deneb on the port's chain, against the JAX package's.

- The three availability-gate cases of ``tests/test_kzg.py`` on the port's
  ``BeaconChain`` (a Deneb genesis at 16 validators, the port's harness,
  fake BLS): a block with blob commitments raises ``BlobsUnavailable``
  until its sidecars are verified, then imports and its sidecars read back
  from the store; a tampered inclusion proof and a wrong KZG proof raise
  ``BlobSidecarError`` and leave the block unavailable; a Deneb block
  without commitments needs no blobs.
- A MINIMAL chain that crosses ``deneb_fork_epoch = 1`` (a Capella genesis,
  the upgrade at the first slot of epoch 1), built by the JAX package's
  harness with blob-carrying blocks after the fork, imported by both
  packages' chains from the same SSZ bytes: one block's first import is
  refused for missing blobs, and its sidecars come by
  ``data_availability.put_sidecars``, another's inline with the block.
  After every step the returned root, the head and the post-state root are
  equal; at the end the events published and the raw rows of every store
  column (blob sidecars included) are byte-equal.
"""

import dataclasses
import importlib
import random

import pytest
import torch

from lighthouse_tpu.crypto import bls as jbls
from lighthouse_tpu_torch import device
from lighthouse_tpu_torch.crypto import bls as tbls

N_VALIDATORS = 16
SLOTS = 13               # epoch 0 (Capella) and slots 8-13 of epoch 1 (Deneb)
FORK_EPOCH = 1


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


def _mod(pkg: str, name: str):
    return importlib.import_module(f"{pkg}.{name}")


def _ser(obj) -> bytes:
    return type(obj).serialize(obj)


def _spec(pkg: str):
    cs = _mod(pkg, "types.chain_spec")
    spec = cs.ChainSpec.minimal().with_forks_at_genesis(cs.ForkName.CAPELLA)
    return dataclasses.replace(spec, deneb_fork_epoch=FORK_EPOCH)


def _blobs(pkg: str, n: int, seed: int) -> list:
    fr, K = _mod(pkg, "kzg.fr"), _mod(pkg, "kzg.kzg")
    rng = random.Random(seed)
    return [K.polynomial_to_blob([rng.randrange(fr.BLS_MODULUS)
                                  for _ in range(4)]) for _ in range(n)]


# -- the availability gate on the port's chain (tests/test_kzg.py:258-307) --

@pytest.fixture
def deneb_chain():
    from lighthouse_tpu_torch.beacon_chain import BeaconChain
    from lighthouse_tpu_torch.store import HotColdDB
    from lighthouse_tpu_torch.testing.harness import StateHarness
    from lighthouse_tpu_torch.types import MINIMAL
    from lighthouse_tpu_torch.types.chain_spec import ForkName
    h = StateHarness(n_validators=N_VALIDATORS, fork=ForkName.DENEB,
                     preset=MINIMAL)
    hdr = h.state.latest_block_header.copy()
    hdr.state_root = h.state.tree_hash_root()
    chain = BeaconChain(
        store=HotColdDB.memory(h.preset, h.spec, h.T),
        genesis_state=h.state.copy(),
        genesis_block_root=hdr.tree_hash_root(),
        preset=h.preset, spec=h.spec, T=h.T)
    return h, chain


def _blob_block(h, n_blobs=1, seed=11):
    from lighthouse_tpu_torch.kzg import kzg as K, trusted_setup as TS
    blobs = _blobs("lighthouse_tpu_torch", n_blobs, seed)
    cms = [K.blob_to_kzg_commitment(b, TS.embedded_setup(4)) for b in blobs]
    return h.build_block(blob_kzg_commitments=cms), blobs, cms


def test_availability_gate_blocks_then_imports(deneb_chain):
    from lighthouse_tpu_torch.beacon_chain import (BlobsUnavailable,
                                                   build_blob_sidecars)
    from lighthouse_tpu_torch.kzg import trusted_setup as TS
    from lighthouse_tpu_torch.types import MINIMAL
    h, chain = deneb_chain
    sb, blobs, cms = _blob_block(h, n_blobs=2)
    h.apply_block(sb)
    chain.per_slot_task(int(sb.message.slot))
    with pytest.raises(BlobsUnavailable):
        chain.process_block(sb, is_timely=True)
    sidecars = build_blob_sidecars(sb, blobs, TS.embedded_setup(4), MINIMAL,
                                   h.T)
    chain.data_availability.put_sidecars(sidecars)
    root = chain.process_block(sb, is_timely=True)
    assert chain.head.root == root
    stored = chain.store.get_blob_sidecars(root)
    assert [int(sc.index) for sc in stored] == [0, 1]
    assert [bytes(sc.kzg_commitment) for sc in stored] == cms
    assert [_ser(sc) for sc in stored] == [_ser(sc) for sc in sidecars]


def test_availability_gate_rejects_mismatched_sidecar(deneb_chain):
    from lighthouse_tpu_torch.beacon_chain import (
        BlobSidecarError, BlobsUnavailable, build_blob_sidecars)
    from lighthouse_tpu_torch.kzg import trusted_setup as TS
    from lighthouse_tpu_torch.types import MINIMAL
    h, chain = deneb_chain
    sb, blobs, cms = _blob_block(h)
    h.apply_block(sb)
    chain.per_slot_task(int(sb.message.slot))
    setup = TS.embedded_setup(4)
    sidecars = build_blob_sidecars(sb, blobs, setup, MINIMAL, h.T)
    T = h.T
    bad = T.BlobSidecar.deserialize(T.BlobSidecar.serialize(sidecars[0]))
    bad.kzg_commitment = b"\xbb" * 48
    with pytest.raises(BlobSidecarError):
        chain.data_availability.put_sidecar(bad)
    other = _blobs("lighthouse_tpu_torch", 1, 99)[0]
    from lighthouse_tpu_torch.kzg import kzg as K
    wrong_proof = K.compute_blob_kzg_proof(
        other, K.blob_to_kzg_commitment(other, setup), setup)
    wrong = build_blob_sidecars(sb, blobs, setup, MINIMAL, h.T,
                                proofs=[wrong_proof])
    with pytest.raises(BlobSidecarError):
        chain.data_availability.put_sidecar(wrong[0])
    with pytest.raises(BlobsUnavailable):
        chain.process_block(sb, is_timely=True)


def test_blockless_deneb_block_needs_no_blobs(deneb_chain):
    h, chain = deneb_chain
    sb = h.build_block()
    h.apply_block(sb)
    chain.per_slot_task(int(sb.message.slot))
    assert chain.process_block(sb, is_timely=True) == chain.head.root


# -- the fork crossing, against the JAX package's chain ---------------------

@pytest.fixture(scope="module")
def script():
    """The JAX harness's chain across the fork as steps over SSZ bytes:
    ``("tick", slot)``, ``("block", fork, bytes, inline sidecars or None,
    expect_unavailable)`` and ``("sidecars", [bytes, ...])``."""
    from lighthouse_tpu.beacon_chain import build_blob_sidecars
    from lighthouse_tpu.kzg import kzg as K, trusted_setup as TS
    from lighthouse_tpu.testing.harness import StateHarness
    from lighthouse_tpu.types.chain_spec import ForkName
    from lighthouse_tpu.types.presets import MINIMAL
    setup = TS.embedded_setup(4)
    h = StateHarness(N_VALIDATORS, fork=ForkName.CAPELLA, preset=MINIMAL,
                     spec=_spec("lighthouse_tpu"))
    genesis = _ser(h.state)
    hdr = h.state.latest_block_header.copy()
    hdr.state_root = h.state.tree_hash_root()
    steps = []
    deneb_blocks = 0
    for slot in range(1, SLOTS + 1):
        fork = h.fork_at(slot)
        blobs = []
        if fork >= ForkName.DENEB and slot % 3:
            blobs = _blobs("lighthouse_tpu", 1 + slot % 2, slot)
        cms = [K.blob_to_kzg_commitment(b, setup) for b in blobs]
        sb = h.build_block(slot, blob_kzg_commitments=cms)
        h.apply_block(sb)
        sidecars = [_ser(sc) for sc in build_blob_sidecars(
            sb, blobs, setup, MINIMAL, h.T)] if blobs else []
        steps.append(("tick", slot))
        if fork >= ForkName.DENEB:
            deneb_blocks += 1
        if sidecars and deneb_blocks == 1:      # refused, then made whole
            steps.append(("block", fork.value, _ser(sb), None, True))
            steps.append(("sidecars", sidecars))
            steps.append(("block", fork.value, _ser(sb), None, False))
        else:
            steps.append(("block", fork.value, _ser(sb), sidecars or None,
                          False))
    assert h.fork_at(SLOTS) == ForkName.DENEB
    assert any(s[0] == "sidecars" for s in steps)
    assert sum(1 for s in steps if s[0] == "block" and s[3]) >= 2
    return genesis, hdr.tree_hash_root(), steps


def _run(pkg: str, genesis: bytes, genesis_root: bytes, steps) -> tuple:
    presets = _mod(pkg, "types.presets")
    factory = _mod(pkg, "types.factory")
    cs = _mod(pkg, "types.chain_spec")
    store = _mod(pkg, "store")
    bc = _mod(pkg, "beacon_chain")
    preset, T = presets.MINIMAL, factory.spec_types(presets.MINIMAL)
    spec = _spec(pkg)
    state = T.state_cls(cs.ForkName.CAPELLA).deserialize(genesis)
    chain = bc.BeaconChain(store=store.HotColdDB.memory(preset, spec, T),
                           genesis_state=state,
                           genesis_block_root=genesis_root, preset=preset,
                           spec=spec, T=T)
    q = chain.event_bus.subscribe(["block", "head", "finalized_checkpoint",
                                   "attestation"])
    recs = []
    for step in steps:
        if step[0] == "tick":
            chain.per_slot_task(step[1])
            continue
        if step[0] == "sidecars":
            chain.data_availability.put_sidecars(
                [T.BlobSidecar.deserialize(b) for b in step[1]])
            continue
        _, fork, data, inline, unavailable = step
        sb = T.signed_block_cls(cs.ForkName(fork)).deserialize(data)
        inline = (None if inline is None
                  else [T.BlobSidecar.deserialize(b) for b in inline])
        if unavailable:
            with pytest.raises(bc.BlobsUnavailable):
                chain.process_block(sb, is_timely=True, blob_sidecars=inline)
            recs.append(("unavailable", chain.head.root))
            continue
        root = chain.process_block(sb, is_timely=True, blob_sidecars=inline)
        fc = chain.fork_choice
        recs.append((root, chain.head.root, chain.head.slot,
                     type(chain.head.state).__name__,
                     chain.head.state.tree_hash_root(),
                     _ser(chain.head.state), fc.justified_checkpoint,
                     [_ser(sc) for sc in chain.store.get_blob_sidecars(root)]))
    events = []
    while not q.empty():
        events.append(q.get_nowait())
    rows = {col.value: sorted(chain.store.kv.iter_column(col))
            for col in store.DBColumn}
    return recs, events, rows


@pytest.fixture(scope="module")
def both_runs(script):
    genesis, groot, steps = script
    return (_run("lighthouse_tpu", genesis, groot, steps),
            _run("lighthouse_tpu_torch", genesis, groot, steps))


def test_fork_crossing_steps_agree(both_runs):
    (want, _, _), (got, _, _) = both_runs
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g == w
    forks = [r[3] for r in want if r[0] != "unavailable"]
    assert forks[0].endswith("Capella") and forks[-1].endswith("Deneb")
    assert sum(1 for r in want if r[0] != "unavailable" and r[-1]) >= 3


def test_fork_crossing_events_and_store_rows_are_byte_equal(both_runs):
    (_, jev, jrows), (_, pev, prows) = both_runs
    assert pev == jev and any(t == "block" for t, _ in jev)
    assert prows.keys() == jrows.keys()
    for col in jrows:
        assert prows[col] == jrows[col], col
    assert any(rows for col, rows in prows.items() if "blob" in col
               or col == "blb"), sorted(prows)


def test_upgrade_and_harness_blocks_equal_the_reference():
    """``upgrade_to_deneb`` of the same Capella state, and the Deneb block
    each package's harness builds with the same commitments, are
    byte-equal across the packages."""
    from lighthouse_tpu.kzg import kzg as JK, trusted_setup as JTS
    states, blocks = [], []
    for pkg in ("lighthouse_tpu", "lighthouse_tpu_torch"):
        harness = _mod(pkg, "testing.harness")
        cs = _mod(pkg, "types.chain_spec")
        presets = _mod(pkg, "types.presets")
        upgrade = _mod(pkg, "state_transition.upgrade")
        h = harness.StateHarness(N_VALIDATORS, fork=cs.ForkName.CAPELLA,
                                 preset=presets.MINIMAL, spec=_spec(pkg))
        for _ in range(3):
            h.apply_block(h.build_block())
        states.append(_ser(upgrade.upgrade_to_deneb(
            h.state.copy(), FORK_EPOCH, h.preset, h.spec, h.T)))
        hd = harness.StateHarness(N_VALIDATORS, fork=cs.ForkName.DENEB,
                                  preset=presets.MINIMAL)
        cms = [JK.blob_to_kzg_commitment(b, JTS.embedded_setup(4))
               for b in _blobs("lighthouse_tpu", 3, 5)]
        blocks.append(_ser(hd.build_block(blob_kzg_commitments=cms)))
    assert states[0] == states[1]
    assert blocks[0] == blocks[1]
