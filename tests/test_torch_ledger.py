"""The port's device ledger (``common/device_ledger.py``), the copies that
report to it, and the compile cache's warm-up, on the CPU.

Each test starts from ``LEDGER.reset()`` (other tests fill the process
ledger).  The accounting is held against the JAX package's own
``DeviceLedger`` fed the same calls (a fresh instance of each), and
against byte counts the test computes itself.
"""

import gc
import threading

import numpy as np
import pytest
import torch

from lighthouse_tpu.common import device_ledger as JL
from lighthouse_tpu_torch import device
from lighthouse_tpu_torch.common import compile_cache
from lighthouse_tpu_torch.common import device_ledger as L
from lighthouse_tpu_torch.common.device_ledger import LEDGER
from lighthouse_tpu_torch.common.knobs import KnobError, knob_float, knob_int
from lighthouse_tpu_torch.ops import device_tree as dt


@pytest.fixture(autouse=True)
def fresh_ledger():
    prev = device.default_device()
    device.set_default_device("cpu")
    LEDGER.reset()
    yield
    device.set_default_device(prev)


def _calls(ledger) -> None:
    """One fixed sequence of accounting calls (both packages' API)."""
    ledger.note_transfer("h2d", 100, subsystem="bls")
    ledger.note_transfer("d2h", 50, subsystem="slasher")
    with ledger.attribute("packed_cache"):
        ledger.note_transfer("h2d", 7)            # ambient wins
        with ledger.attribute("registry_mirror"):
            ledger.note_transfer("h2d", 3)        # innermost wins
            ledger.note_event("scatters")
        ledger.note_transfer("h2d", 2, ops=4)
        ledger.note_compile()
        ledger.note_transfer("h2d", 5, subsystem="kzg")  # explicit wins
    ledger.note_transfer("h2d", 11)               # no context: device_tree
    ledger.note_event("materializes", subsystem="proof_engine")
    ledger.note_dispatch("bls", 2.5)
    ledger.note_compile(key="compile_hits")       # unattributed
    ledger.mark_slot(7)
    ledger.note_transfer("h2d", 1, subsystem="staging")
    ledger.note_transfer("d2h", 32, subsystem="device_tree")
    ledger.mark_slot(8)
    ledger.note_transfer("h2d", 9, subsystem="bls")
    ledger.mark_slot(9)


_KEYS = ("h2d_bytes", "h2d_ops", "d2h_bytes", "d2h_ops", "dispatches",
         "device_ms", "compiles", "compile_hits", "scatters", "rebuilds",
         "materializes", "resident_bytes")


def test_accounting_equals_the_jax_ledger():
    port, ref = L.DeviceLedger(), JL.DeviceLedger()
    _calls(port)
    _calls(ref)
    ps, rs = port.snapshot(), ref.snapshot()
    assert set(ps["subsystems"]) == set(rs["subsystems"])
    for sub in ps["subsystems"]:
        for k in _KEYS:
            assert ps["subsystems"][sub][k] == rs["subsystems"][sub][k], \
                (sub, k)
    assert port.slot_deltas() == ref.slot_deltas()
    assert port.subsystem_totals(L.SUBSYSTEMS) == \
        ref.subsystem_totals(JL.SUBSYSTEMS)
    assert port.transfer_totals() == ref.transfer_totals()
    assert L.evaluate_budget(port.slot_deltas()) == \
        JL.evaluate_budget(ref.slot_deltas())
    assert ps["cuda_memory"] is None        # the device is the CPU


def test_subsystems_and_budgets_are_the_jax_packages():
    assert L.SUBSYSTEMS == JL.SUBSYSTEMS
    assert L.WARM_SLOT_BUDGET == JL.WARM_SLOT_BUDGET
    assert set(L.WARM_SLOT_BUDGET) == set(L.SUBSYSTEMS)


def test_unknown_subsystem_rejected():
    with pytest.raises(AssertionError):
        LEDGER.note_transfer("h2d", 1, subsystem="warp_drive")
    with pytest.raises(AssertionError):
        with LEDGER.attribute("warp_drive"):
            pass


def test_ambient_attribution_is_thread_local_and_exact():
    seen, n_threads, per = {}, 8, 300

    def worker(i):
        seen[i] = LEDGER.ambient()
        for _ in range(per):
            LEDGER.note_transfer("h2d", 3)          # no ambient here
            LEDGER.note_transfer("d2h", 1, subsystem="bls")

    with LEDGER.attribute("kzg"):
        ts = [threading.Thread(target=worker, args=(i,))
              for i in range(n_threads)]
        for t in ts:
            t.start()
        for t in ts:
            t.join()
        assert LEDGER.ambient() == "kzg"
    assert set(seen.values()) == {None}
    subs = LEDGER.snapshot()["subsystems"]
    assert subs["device_tree"]["h2d_bytes"] == 3 * n_threads * per
    assert subs["kzg"]["h2d_bytes"] == 0
    assert subs["bls"]["d2h_ops"] == n_threads * per


def test_budget_flags_the_reference_violation():
    deltas = [
        {"slot": 5, "subsystems": {
            "packed_cache": {"h2d_bytes": 100, "h2d_ops": 1,
                             "d2h_bytes": 0, "d2h_ops": 0}}},
        {"slot": 6, "subsystems": {
            "staging": {"h2d_bytes": 1, "h2d_ops": 1,
                        "d2h_bytes": 0, "d2h_ops": 0}}},
    ]
    out = L.evaluate_budget(deltas)
    assert not out["ok"]
    bad = [r for r in out["rows"] if not r["ok"]]
    assert [(r["subsystem"], r["direction"]) for r in bad] == \
        [("staging", "h2d")]
    assert bad[0]["violations"] == [6] and bad[0]["worst_slot"] == 6
    assert 0 < out["attainment"] < 1
    assert out == JL.evaluate_budget(deltas)
    cold = [dict(deltas[1], cold=True)]
    skipped = L.evaluate_budget(cold, include_cold=False)
    assert skipped["ok"] and skipped["cold_slots_skipped"] == [6]
    empty = L.evaluate_budget([])
    assert empty["ok"] and empty["attainment"] == 1.0


def test_slot_ring_is_bounded_and_quiet_slots_record_nothing():
    for s in range(100, 100 + L.SLOT_RING + 10):
        LEDGER.note_transfer("h2d", 1, subsystem="bls")
        LEDGER.mark_slot(s)
    assert len(LEDGER.slot_deltas()) == L.SLOT_RING
    LEDGER.mark_slot(500)
    LEDGER.mark_slot(501)                 # 500 was quiet
    assert 500 not in {d["slot"] for d in LEDGER.slot_deltas()}


def test_residency_watermark_release_and_gc():
    tok = LEDGER.residency("slasher")
    tok.set(1000)
    tok.set(400)                 # resident follows, high-water holds
    row = LEDGER.snapshot()["subsystems"]["slasher"]
    assert (row["resident_bytes"], row["high_water_bytes"]) == (400, 1000)
    tok.release()
    tok.release()                # idempotent
    assert LEDGER.snapshot()["subsystems"]["slasher"]["resident_bytes"] == 0

    class Owner:
        pass

    o = Owner()
    LEDGER.track(o, "kzg", 12345)
    assert LEDGER.snapshot()["subsystems"]["kzg"]["resident_bytes"] == 12345
    del o
    gc.collect()
    assert LEDGER.snapshot()["subsystems"]["kzg"]["resident_bytes"] == 0


def test_reset_reseeds_live_tokens_and_lock_is_reentrant():
    tok = LEDGER.residency("registry_mirror")
    tok.set(1000)
    LEDGER.reset()
    assert LEDGER.snapshot()["subsystems"]["registry_mirror"][
        "resident_bytes"] == 1000

    def reenter():
        with LEDGER._lock:       # a GC finalizer's release under the lock
            tok.release()

    t = threading.Thread(target=reenter, daemon=True)
    t.start()
    t.join(timeout=10)
    assert not t.is_alive()
    assert LEDGER.snapshot()["subsystems"]["registry_mirror"][
        "resident_bytes"] == 0


def test_copies_report_to_the_ledger_and_the_views_rebase():
    device.reset_transfer_counters()
    a = np.arange(10, dtype=np.uint32)
    t = device.to_device(a, "bls")
    with LEDGER.attribute("proof_engine"):
        device.to_device(a)
        device.to_host(t)
    device.to_device_async(a)             # no subsystem: device_tree
    subs = LEDGER.snapshot()["subsystems"]
    assert subs["bls"]["h2d_bytes"] == 40
    assert (subs["proof_engine"]["h2d_bytes"],
            subs["proof_engine"]["d2h_bytes"]) == (40, 40)
    assert subs["device_tree"]["h2d_bytes"] == 40
    assert device.transfer_totals() == {"h2d": 120, "d2h": 40}
    device.reset_transfer_counters()
    assert device.transfer_totals() == {"h2d": 0, "d2h": 0}


def test_device_tree_residency_events_and_legacy_view():
    dt.reset_residency_stats()
    leaves = np.arange(64 * 8, dtype=np.uint32).reshape(64, 8)
    tree = dt.DeviceTree.from_host_leaves(leaves)
    level_bytes = sum(lv.numel() * 4 for lv in tree.levels)
    row = LEDGER.snapshot()["subsystems"]["device_tree"]
    assert row["resident_bytes"] == level_bytes
    assert row["materializes"] == 1
    tree.scatter(np.array([3]), leaves[:1])
    tree.rebuild_device(torch.from_numpy(leaves.view(np.int32)).clone())
    snap = dt.residency_snapshot()
    assert snap["materializes"] == 1 and snap["scatters"] == 1 \
        and snap["rebuilds"] == 1
    # materialize + a bucket of 8 (index, row) pairs up; two roots down
    assert snap["bytes_pushed"] == leaves.nbytes + 8 * 8 + 8 * 32
    assert snap["bytes_pulled"] == 2 * 32
    sib = tree.share()
    sib.scatter(np.array([5]), leaves[:1])   # the clone's own buffers
    assert LEDGER.snapshot()["subsystems"]["device_tree"][
        "resident_bytes"] == 2 * level_bytes
    del tree, sib
    gc.collect()
    assert LEDGER.snapshot()["subsystems"]["device_tree"][
        "resident_bytes"] == 0
    dt.reset_residency_stats()
    assert set(dt.residency_snapshot().values()) == {0}


def test_ledger_has_no_off_switch(monkeypatch):
    """The ledger is the only count of the transfer bytes: the JAX
    package's on/off and ring-length knobs are not read by the port."""
    monkeypatch.setenv("LIGHTHOUSE_TPU_DEVICE_LEDGER", "0")
    fresh = L.DeviceLedger()
    fresh.note_transfer("h2d", 5, subsystem="bls")
    assert fresh.snapshot()["subsystems"]["bls"]["h2d_bytes"] == 5
    with pytest.raises(KnobError):
        knob_int("LIGHTHOUSE_TPU_DEVICE_LEDGER_SLOTS")


def _transfer_view():
    return device.reset_transfer_counters, device.transfer_totals, \
        ("bls", "h2d_bytes"), "h2d", 40


def _residency_view():
    return dt.reset_residency_stats, dt.residency_snapshot, \
        ("registry_mirror", "h2d_bytes"), "bytes_pushed", 40


@pytest.mark.parametrize("view", [_transfer_view, _residency_view])
def test_views_count_from_a_reset_after_their_rebase(view):
    rebase, read, _row, key, nbytes = view()
    LEDGER.note_transfer("h2d", 1000, subsystem="registry_mirror")
    LEDGER.note_transfer("h2d", 1000, subsystem="bls")
    rebase()
    LEDGER.reset()                       # every count before it is gone
    device.to_device(np.arange(10, dtype=np.uint32), "registry_mirror")
    assert read()[key] == nbytes
    rebase()
    assert read()[key] == 0


@pytest.mark.parametrize("view", [_transfer_view, _residency_view])
def test_views_raise_when_a_counter_runs_backwards(view):
    rebase, read, (sub, counter), _key, _n = view()
    LEDGER.note_transfer("h2d", 64, subsystem=sub)
    rebase()
    with LEDGER._lock:                   # a fault: the count went down
        LEDGER._sub[sub][counter] -= 32
    with pytest.raises(RuntimeError, match="ran backwards"):
        read()


def test_register_metrics_exports_the_families():
    from lighthouse_tpu_torch.common.metrics import REGISTRY
    LEDGER.note_transfer("h2d", 77, subsystem="proof_engine")
    LEDGER.register_metrics()
    text = REGISTRY.encode()
    assert ('device_transfer_bytes_total{subsystem="proof_engine",'
            'direction="h2d"} 77.0') in text
    assert "# TYPE device_resident_bytes gauge" in text


@pytest.mark.parametrize("raw,want", [(None, 2.0), ("0.5", 0.5),
                                      ("-3", 0.0), ("", 2.0)])
def test_knob_float_parses_and_clamps(raw, want, monkeypatch):
    if raw is None:
        monkeypatch.delenv("LIGHTHOUSE_TPU_PROOF_WINDOW_MS", raising=False)
    else:
        monkeypatch.setenv("LIGHTHOUSE_TPU_PROOF_WINDOW_MS", raw)
    assert knob_float("LIGHTHOUSE_TPU_PROOF_WINDOW_MS") == want


def test_knob_defaults_and_site_defaults(monkeypatch):
    monkeypatch.delenv("LIGHTHOUSE_TPU_PUSH_CHUNK_ROWS", raising=False)
    assert knob_int("LIGHTHOUSE_TPU_PUSH_CHUNK_ROWS") == 1 << 18
    assert knob_int("LIGHTHOUSE_TPU_PUSH_CHUNK_ROWS", default=1 << 17) \
        == 1 << 17
    monkeypatch.setenv("LIGHTHOUSE_TPU_PUSH_CHUNK_ROWS", "-1")
    assert knob_int("LIGHTHOUSE_TPU_PUSH_CHUNK_ROWS") == -1   # no minimum
    assert knob_int("LIGHTHOUSE_TPU_HOST_FASTPATH_MAX") == 4
    monkeypatch.setenv("LIGHTHOUSE_TPU_PROOF_MAX_BATCH", "x")
    with pytest.raises(KnobError, match="PROOF_MAX_BATCH"):
        knob_int("LIGHTHOUSE_TPU_PROOF_MAX_BATCH")


def test_warmup_skips_on_the_cpu_and_raises_without_a_gpu(monkeypatch):
    assert compile_cache.warmup() == {"skipped": "cpu", "compiled": []}
    assert compile_cache.library_names() == ["bls381", "bls381_phases",
                                             "kzg_fr", "sha256_merkle"]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    device.set_default_device("cuda")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        compile_cache.warmup()


def test_enable_sets_the_build_directory(tmp_path, monkeypatch):
    from lighthouse_tpu_torch.ops import cuda_build
    monkeypatch.setattr(cuda_build, "BUILD_DIR", cuda_build.BUILD_DIR)
    monkeypatch.setitem(compile_cache._state, "dir", None)
    assert not compile_cache.is_enabled()
    got = compile_cache.enable(str(tmp_path / "kernels"))
    assert got == compile_cache.cache_dir() == cuda_build.BUILD_DIR
    assert compile_cache.is_enabled()
    assert cuda_build.library_path("sha256_merkle").startswith(got)


def test_native_load_is_a_compile_hit(monkeypatch):
    """Loading a finished native build counts a ``compile_hits`` event
    under ``bls`` (the build itself, when it runs, one ``compiles``)."""
    from lighthouse_tpu_torch.crypto import native
    assert native.available(block=True)
    monkeypatch.setattr(native, "_lib", None)
    LEDGER.reset()
    assert native.available(block=True)
    row = LEDGER.snapshot()["subsystems"]["bls"]
    assert (row["compiles"], row["compile_hits"]) == (0, 1)
