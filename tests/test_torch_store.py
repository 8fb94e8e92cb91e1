"""The port's store and block replayers on the CPU, against the JAX
package's, on the same rows and the same blocks.

- ``kv``: the same batches through each package's ``MemoryStore`` and
  ``SqliteStore`` leave byte-equal rows; the checksum frame is the same
  bytes and a flipped byte raises ``ChecksumError`` in both;
  ``LIGHTHOUSE_TPU_STORE_SYNC`` sets the same PRAGMA and refuses the same
  values.
- ``migrations``: a chain's rows downgraded to the v1 layout migrate
  to v2 byte-equal in both packages.
- ``recovery``: a datadir with a journal window after the snapshot and a
  corrupt row resumes in both packages to the same head, the same
  recovery report and the same rows.
- ``EpochReplayer``: the same windows (skipped slots, epoch boundaries)
  give the same final state bytes; a tampered window raises
  ``WindowSignaturesInvalid`` (real signatures) or ``WindowRootMismatch``
  naming the same block in both.
"""

import importlib
import struct

import numpy as np
import pytest
import torch

from lighthouse_tpu.crypto import bls as jbls
from lighthouse_tpu_torch import device
from lighthouse_tpu_torch.crypto import bls as tbls

PKGS = ("lighthouse_tpu", "lighthouse_tpu_torch")
GAPPY_SLOTS = [1, 2, 3, 4, 5, 7, 8, 9, 10, 11, 14, 15, 16, 17, 20, 21, 22,
               23, 24, 25]


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


def _ctx(pkg: str):
    presets = _mod(pkg, "types.presets")
    factory = _mod(pkg, "types.factory")
    cs = _mod(pkg, "types.chain_spec")
    preset, T = presets.MINIMAL, factory.spec_types(presets.MINIMAL)
    spec = cs.ChainSpec.minimal().with_forks_at_genesis(cs.ForkName.CAPELLA)
    return preset, spec, T, cs.ForkName.CAPELLA


def _build(slots, backend: str = "fake"):
    """The JAX harness's chain at 16 validators: (genesis bytes, genesis
    root, [block bytes])."""
    from lighthouse_tpu.state_transition.per_block import SignatureStrategy
    from lighthouse_tpu.testing.harness import StateHarness
    prev = jbls._active
    jbls.set_backend(backend)
    try:
        h = StateHarness(16)
        genesis = _ser(h.state)
        hdr = h.state.latest_block_header.copy()
        hdr.state_root = h.state.tree_hash_root()
        blocks = []
        for slot in slots:
            sb = h.build_block(slot=slot)
            h.apply_block(sb, strategy=SignatureStrategy.NO_VERIFICATION)
            blocks.append(_ser(sb))
        return genesis, hdr.tree_hash_root(), blocks
    finally:
        jbls._active = prev


@pytest.fixture(scope="module")
def gappy():
    return _build(GAPPY_SLOTS)


def _decode(pkg: str, genesis: bytes, blocks):
    preset, spec, T, fork = _ctx(pkg)
    return (T.state_cls(fork).deserialize(genesis),
            [T.signed_block_cls(fork).deserialize(b) for b in blocks])


# -- kv ------------------------------------------------------------------


def _kv_ops(kv_mod):
    DB = kv_mod.DBColumn
    rng = np.random.default_rng(5)
    ops = []
    for i in range(40):
        col = list(DB)[i % len(DB)]
        ops.append(("put", col, rng.bytes(8 + i % 7),
                    kv_mod.frame_value(rng.bytes(i * 13))))
    ops.append(("delete", ops[3][1], ops[3][2], None))
    return ops


@pytest.mark.parametrize("backend", ["memory", "sqlite"])
def test_kv_rows_and_frames_equal(backend, tmp_path):
    rows = []
    for pkg in PKGS:
        kv_mod = _mod(pkg, "store.kv")
        kv = (kv_mod.MemoryStore() if backend == "memory" else
              kv_mod.SqliteStore(str(tmp_path / f"{pkg}.sqlite")))
        kv.do_atomically(_kv_ops(kv_mod))
        kv.put(kv_mod.DBColumn.BeaconMeta, b"k", b"v")
        got = {c.value: sorted(kv.iter_column(c)) for c in kv_mod.DBColumn}
        data = kv.get(kv_mod.DBColumn.BeaconBlock,
                      got["blk"][0][0]) if got["blk"] else None
        assert kv_mod.unframe_value(kv_mod.frame_value(b"abc")) == b"abc"
        bad = data[:-1] + bytes([data[-1] ^ 1])
        with pytest.raises(kv_mod.ChecksumError):
            kv_mod.unframe_value(bad)
        rows.append((got, kv_mod.frame_value(b"\x01" * 77)))
        kv.close()
    assert rows[0] == rows[1]


def test_store_sync_knob_matches(tmp_path, monkeypatch):
    out = []
    for pkg in PKGS:
        kv_mod = _mod(pkg, "store.kv")
        monkeypatch.setenv("LIGHTHOUSE_TPU_STORE_SYNC", "full")
        kv = kv_mod.SqliteStore(str(tmp_path / f"{pkg}.db"))
        level = kv._conn.execute("PRAGMA synchronous").fetchone()[0]
        kv.close()
        monkeypatch.setenv("LIGHTHOUSE_TPU_STORE_SYNC", "sometimes")
        with pytest.raises(ValueError):
            kv_mod.SqliteStore(str(tmp_path / f"{pkg}-bad.db"))
        out.append(level)
    assert out[0] == out[1] == 2


# -- migrations and recovery ------------------------------------------------


def _port_chain_rows(genesis, groot, blocks, *, persist_at=None):
    """A port chain over a MemoryStore importing ``blocks``; persists
    after block ``persist_at`` (its journal then holds the rest)."""
    from lighthouse_tpu_torch.beacon_chain import BeaconChain
    from lighthouse_tpu_torch.store import HotColdDB, MemoryStore
    preset, spec, T, fork = _ctx("lighthouse_tpu_torch")
    state, sbs = _decode("lighthouse_tpu_torch", genesis, blocks)
    kv = MemoryStore()
    chain = BeaconChain(store=HotColdDB(kv, preset, spec, T),
                        genesis_state=state, genesis_block_root=groot,
                        preset=preset, spec=spec, T=T)
    for i, sb in enumerate(sbs):
        chain.per_slot_task(int(sb.message.slot))
        chain.process_block(sb)
        if persist_at is not None and i == persist_at:
            chain.persist()
    return chain, kv


def _rows(kv, DBColumn) -> dict:
    return {c.value: sorted(kv.iter_column(c)) for c in DBColumn}


def _load_rows(pkg: str, rows: dict):
    kv_mod = _mod(pkg, "store.kv")
    kv = kv_mod.MemoryStore()
    ops = [("put", kv_mod.DBColumn(col), bytes(k), bytes(v))
           for col, items in rows.items() for k, v in items]
    kv.do_atomically(ops)
    return kv


def _downgrade_to_v1(pkg: str, kv) -> None:
    kv_mod = _mod(pkg, "store.kv")
    mig = _mod(pkg, "store.migrations")
    DB = kv_mod.DBColumn
    ops = []
    for col in mig.FRAMED_COLUMNS:
        for key, data in list(kv.iter_column(col)):
            if col is DB.StoreJournal:
                ops.append(("delete", col, bytes(key), None))
            else:
                ops.append(("put", col, bytes(key),
                            kv_mod.unframe_value(data)))
    ops.append(("put", DB.BeaconMeta, b"schema", struct.pack("<Q", 1)))
    kv.do_atomically(ops)


def test_v1_rows_migrate_to_equal_v2_rows(gappy):
    genesis, groot, blocks = gappy
    chain, kv = _port_chain_rows(genesis, groot, blocks[:10])
    chain.persist()
    from lighthouse_tpu_torch.store import DBColumn
    rows = _rows(kv, DBColumn)
    out = []
    for pkg in PKGS:
        kv2 = _load_rows(pkg, rows)
        _downgrade_to_v1(pkg, kv2)
        store = _mod(pkg, "store")
        preset, spec, T, _ = _ctx(pkg)
        db = store.HotColdDB(kv2, preset, spec, T)
        assert db.schema_migrated_from == 1
        out.append(_rows(kv2, store.DBColumn))
    assert out[0] == out[1]
    v2 = dict(rows)
    v2.pop("jnl", None)
    got = dict(out[1])
    got.pop("jnl", None)
    assert got == v2


def test_recovery_reconciles_the_same_rows_to_the_same_head(gappy):
    """Persist after block 8, import 6 more (their journal entries are
    the replay window), corrupt one post-window state row: both packages'
    ``resume`` quarantine the same row, replay the same blocks and land on
    the same head with the same rows."""
    genesis, groot, blocks = gappy
    chain, kv = _port_chain_rows(genesis, groot, blocks[:14], persist_at=8)
    from lighthouse_tpu_torch.store import DBColumn
    rows = _rows(kv, DBColumn)
    last = _decode("lighthouse_tpu_torch", genesis, blocks[13:14])[1][0]
    bad_key = bytes(last.message.state_root)
    col = "ste" if any(k == bad_key for k, _ in rows["ste"]) else "bss"
    rows[col] = [(k, v[:-1] + bytes([v[-1] ^ 0xFF]) if k == bad_key else v)
                 for k, v in rows[col]]
    out = []
    for pkg in PKGS:
        kv2 = _load_rows(pkg, rows)
        store = _mod(pkg, "store")
        bc = _mod(pkg, "beacon_chain")
        preset, spec, T, _ = _ctx(pkg)
        c = bc.BeaconChain.resume(store=store.HotColdDB(kv2, preset, spec, T),
                                  preset=preset, spec=spec, T=T)
        rep = c.last_recovery
        out.append((c.head.root, c.head.slot,
                    c.fork_choice.justified_checkpoint,
                    c.fork_choice.finalized_checkpoint,
                    [(q.column.value, q.key) for q in rep.quarantined],
                    [bytes(r) for r in rep.replayed],
                    _rows(kv2, store.DBColumn)))
    assert out[0] == out[1]
    assert out[0][4] and out[0][5]


# -- block replayers --------------------------------------------------------


def test_epoch_replayer_windows_equal_the_reference(gappy):
    genesis, _, blocks = gappy
    splits = [3, 5, 1, 7, 4]
    finals = []
    for pkg in PKGS:
        st_mod = _mod(pkg, "state_transition")
        preset, spec, T, _ = _ctx(pkg)
        state, sbs = _decode(pkg, genesis, blocks)
        rep = st_mod.EpochReplayer(state, preset, spec, T,
                                   verify_signatures=False)
        i = 0
        for n in splits:
            rep.apply_window(sbs[i:i + n])
            i += n
        assert i == len(sbs)
        finals.append(_ser(rep.state))
    assert finals[0] == finals[1]
    serial = _mod("lighthouse_tpu_torch", "state_transition.block_replayer")
    per_block = _mod("lighthouse_tpu_torch", "state_transition.per_block")
    preset, spec, T, _ = _ctx("lighthouse_tpu_torch")
    state, sbs = _decode("lighthouse_tpu_torch", genesis, blocks)
    oracle = serial.BlockReplayer(
        state, preset, spec, T,
        strategy=per_block.SignatureStrategy.NO_VERIFICATION)
    oracle.apply_blocks(sbs)
    assert _ser(oracle.state) == finals[1]


def test_tampered_state_root_names_the_same_block(gappy):
    genesis, _, blocks = gappy
    named = []
    for pkg in PKGS:
        st_mod = _mod(pkg, "state_transition")
        preset, spec, T, _ = _ctx(pkg)
        state, sbs = _decode(pkg, genesis, blocks[:6])
        sbs[-1].message.state_root = b"\xab" * 32
        rep = st_mod.EpochReplayer(state, preset, spec, T,
                                   verify_signatures=False)
        with pytest.raises(st_mod.WindowRootMismatch) as ei:
            rep.apply_window(sbs)
        named.append((ei.value.slot, ei.value.block_root))
    assert named[0] == named[1]
    assert named[0][0] == GAPPY_SLOTS[5]


def test_tampered_signature_names_the_same_block():
    """Real signatures (python backends): block 3 carries block 2's
    proposal signature; both replayers bisect to block 3."""
    genesis, _, blocks = _build([1, 2, 3, 4, 5], backend="python")
    named = []
    for pkg, bls in (("lighthouse_tpu", jbls), ("lighthouse_tpu_torch",
                                                  tbls)):
        prev = bls._active
        bls.set_backend("python")
        try:
            st_mod = _mod(pkg, "state_transition")
            preset, spec, T, _ = _ctx(pkg)
            state, sbs = _decode(pkg, genesis, blocks)
            sbs[3].signature = sbs[2].signature
            rep = st_mod.EpochReplayer(state, preset, spec, T,
                                       verify_signatures=True)
            with pytest.raises(st_mod.WindowSignaturesInvalid) as ei:
                rep.apply_window(sbs)
            named.append((ei.value.slot, ei.value.block_root))
        finally:
            bls._active = prev
    assert named[0] == named[1] == (
        4, _decode("lighthouse_tpu_torch", genesis, blocks)[1][3]
        .message.tree_hash_root())
