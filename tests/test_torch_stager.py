"""The port's chunk stager (``parallel/pipeline.py`` ``ChunkStager``) and the
cold builds that stream through it, on the CPU.

The stager yields chunks in order, stops its thread when the consumer
leaves early, and stages a failed chunk again (counted).  The chunk-staged
builds must be raw equal to the one-copy builds and to the JAX package:
``merkle_levels_device`` at 2^10 leaves in 2^7-row chunks against the JAX
package's host-cache levels; the registry's cold build and its device
mirror, chunked through ``LIGHTHOUSE_TPU_PUSH_CHUNK_ROWS``, against the
unchunked ones and the JAX package's ``tree_hash_root``.
"""

import threading

import numpy as np
import pytest
import torch

from lighthouse_tpu.ops import tree_cache as JTC
from lighthouse_tpu.types.chain_spec import ForkName as JForkName
from lighthouse_tpu.types.factory import spec_types as jspec_types
from lighthouse_tpu.types.presets import MAINNET as JMAINNET
from lighthouse_tpu.types.validators import ValidatorRegistry as JRegistry
from lighthouse_tpu_torch import device
from lighthouse_tpu_torch.common.device_ledger import LEDGER
from lighthouse_tpu_torch.ops import merkle_kernel as mk
from lighthouse_tpu_torch.ops.tree_cache import fold_zero_cap
from lighthouse_tpu_torch.parallel import pipeline
from lighthouse_tpu_torch.parallel.pipeline import ChunkStager
from lighthouse_tpu_torch.types import validators as tv
from lighthouse_tpu_torch.types.carry import (registry_from_columns,
                                              state_from_ssz)
from lighthouse_tpu_torch.types.device_state import materialize_state


@pytest.fixture(autouse=True, scope="module")
def _cpu():
    prev, threads = device.default_device(), torch.get_num_threads()
    device.set_default_device("cpu")
    torch.set_num_threads(1)
    yield
    device.set_default_device(prev)
    torch.set_num_threads(threads)


def _chunks(n):
    return [np.full((4, 8), i, np.uint32) for i in range(n)]


@pytest.mark.parametrize("depth", [1, 2, 4])
def test_chunks_arrive_in_order_and_are_counted(depth):
    LEDGER.reset()
    stager = ChunkStager(_chunks(7), depth=depth)
    got = [int(c[0, 0]) for c in stager]
    assert got == list(range(7))
    assert stager.fallbacks == 0 and stager.transfer_s >= 0
    assert stager.wait_s >= 0
    row = LEDGER.snapshot()["subsystems"]["staging"]
    assert (row["h2d_bytes"], row["h2d_ops"]) == (7 * 4 * 8 * 4, 7)


def test_dict_chunks_and_subsystem():
    LEDGER.reset()
    chunks = [{"a": np.arange(3, dtype=np.uint32) + i,
               "b": np.ones((2, 2), np.uint64) * i} for i in range(3)]
    out = list(ChunkStager(chunks, subsystem="registry_mirror"))
    assert [int(c["a"][0]) for c in out] == [0, 1, 2]
    assert out[2]["b"].dtype == torch.int64 and int(out[2]["b"][1, 1]) == 2
    assert LEDGER.snapshot()["subsystems"]["registry_mirror"][
        "h2d_bytes"] == 3 * (12 + 32)


def test_abort_midway_stops_the_thread():
    started = threading.Event()

    def slow_stage(chunk):
        started.set()
        return pipeline.sync_stage_arrays(chunk)

    stager = ChunkStager(_chunks(50), stage=slow_stage, depth=1)
    for i, c in enumerate(stager):
        if i == 2:
            break
    assert started.is_set()
    assert not stager._thread.is_alive()      # joined on the way out
    stager.join()                             # idempotent


def test_failed_stage_is_staged_again_and_counted():
    fails = {1, 4}

    def flaky(chunk):
        if int(chunk[0, 0]) in fails:
            raise RuntimeError("copy fault")
        return pipeline.sync_stage_arrays(chunk)

    stager = ChunkStager(_chunks(6), stage=flaky)
    got = [int(c[0, 0]) for c in stager]
    assert got == list(range(6))
    assert stager.fallbacks == 2


class _Fatal(BaseException):
    """A failure the per-chunk retry does not catch."""


def test_a_dead_stager_thread_raises_instead_of_hanging():
    def fatal(chunk):
        raise _Fatal("the stager thread died")

    stager = ChunkStager(_chunks(3), stage=fatal)
    with pytest.raises(RuntimeError, match="stager failed"):
        list(stager)
    assert not stager._thread.is_alive()


def _leaves(seed, n):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 2 ** 32, (n, 8), dtype=np.uint64).astype(
        np.uint32)


def test_chunked_levels_equal_monolithic_and_the_jax_levels():
    leaves = _leaves(3, 1 << 10)
    mk.reset_push_stats()
    r_one, one = mk.merkle_levels_device(leaves, chunk_rows=0)
    assert mk.LAST_PUSH_STATS == {}
    r_ch, ch = mk.merkle_levels_device(leaves, chunk_rows=1 << 7)
    assert len(one) == len(ch) == 11
    for a, b in zip(one, ch):
        assert torch.equal(a, b)
    assert np.array_equal(r_one, r_ch)
    stats = mk.LAST_PUSH_STATS
    assert stats["builds"] == 1 and stats["chunks"] == 8
    assert stats["staging_fallbacks"] == 0
    assert {"wait_ms", "transfer_ms", "overlap_ms", "wall_ms"} <= set(stats)
    jcache = JTC.IncrementalMerkleCache(1 << 10, False)
    jroot = jcache._rebuild(leaves)
    assert np.array_equal(r_ch, jroot)
    for lv, jlv in zip(ch, jcache.levels):
        assert np.array_equal(lv.numpy().view(np.uint32), jlv)


@pytest.mark.parametrize("knob,chunks", [("256", 4), ("300", 4),
                                         ("0", 1), ("4096", 1)])
def test_push_chunk_knob(knob, chunks, monkeypatch):
    """The knob rounds down to a power of two; 0 or a chunk as wide as
    the tree copies once."""
    monkeypatch.setenv("LIGHTHOUSE_TPU_PUSH_CHUNK_ROWS", knob)
    mk.reset_push_stats()
    mk.merkle_levels_device(_leaves(4, 1 << 10))
    assert mk.LAST_PUSH_STATS.get("chunks", 1) == chunks


def _jax_registry(n, seed):
    rng = np.random.default_rng(seed)
    reg = JRegistry(n)
    reg._n = n
    act = rng.integers(0, 1000, n).astype(np.uint64)
    reg.init_columns(
        pubkey=rng.integers(0, 256, (n, 48), dtype=np.uint8),
        withdrawal_credentials=rng.integers(0, 256, (n, 32), dtype=np.uint8),
        effective_balance=(rng.integers(0, 33, n) * 10 ** 9).astype(
            np.uint64),
        slashed=rng.random(n) < 0.1,
        activation_eligibility_epoch=act,
        activation_epoch=act + np.uint64(1),
        exit_epoch=rng.integers(0, 2 ** 40, n).astype(np.uint64),
        withdrawable_epoch=rng.integers(0, 2 ** 40, n).astype(np.uint64))
    return reg


def _port_registry(jreg):
    return registry_from_columns(
        {c: np.array(getattr(jreg, "_" + c)[:len(jreg)])
         for c in tv.ValidatorRegistry._COLUMNS})


LIMIT = JMAINNET.VALIDATOR_REGISTRY_LIMIT
DEPTH = (LIMIT - 1).bit_length()


@pytest.mark.parametrize("n", [300, 512])
def test_chunked_registry_cold_build_and_mirror(n, monkeypatch):
    jreg = _jax_registry(n, seed=n)
    want = jreg.hash_tree_root(LIMIT)
    reg = _port_registry(jreg)
    w = 1 << (n - 1).bit_length()
    r_one, one = tv.registry_cold_device(reg, chunk_rows=0)
    r_ch, ch = tv.registry_cold_device(reg, chunk_rows=64)
    assert tv.LAST_COLD_TIMINGS["push_chunks"] == w // 64
    assert tv.LAST_COLD_TIMINGS["push_fallbacks"] == 0
    for a, b in zip(one, ch):
        assert torch.equal(a, b)
    assert fold_zero_cap(r_ch, len(ch) - 1, DEPTH, True, n) == want

    monkeypatch.setenv("LIGHTHOUSE_TPU_PUSH_CHUNK_ROWS", "0")
    flat = tv.DeviceRegistryMirror.materialize(reg)
    monkeypatch.setenv("LIGHTHOUSE_TPU_PUSH_CHUNK_ROWS", "64")
    LEDGER.reset()
    before = LEDGER.snapshot()["subsystems"]["registry_mirror"][
        "resident_bytes"]
    mirror = tv.DeviceRegistryMirror.materialize(reg)
    assert tv.LAST_COLD_TIMINGS["push_chunks"] == w // 64
    for k in flat.cols:
        assert torch.equal(flat.cols[k], mirror.cols[k])
    for a, b in zip(flat.tree.levels, mirror.tree.levels):
        assert torch.equal(a, b)
    root = fold_zero_cap(mirror.tree.root_words(), len(ch) - 1, DEPTH,
                         True, n)
    assert root == want
    row = LEDGER.snapshot()["subsystems"]["registry_mirror"]
    assert row["materializes"] == 1
    assert row["h2d_ops"] == (w // 64) * len(mirror.cols)
    assert row["resident_bytes"] - before == sum(
        v.numel() * v.element_size() for v in mirror.cols.values()) + sum(
        lv.numel() * lv.element_size() for lv in mirror.tree.levels)


def test_chunk_staged_materialized_state_root(monkeypatch):
    """A whole state materialized with its registry streamed in chunks
    roots like the JAX package, before and after a scatter."""
    n = 100
    jstate = jspec_types(JMAINNET).state_cls(JForkName.CAPELLA)()
    jstate.validators = _jax_registry(n, seed=9)
    rng = np.random.default_rng(9)
    jstate.balances = rng.integers(0, 40 * 10 ** 9, n).astype(np.uint64)
    jstate.slot = 77
    state = state_from_ssz(type(jstate).serialize(jstate), JMAINNET,
                           JForkName.CAPELLA)
    monkeypatch.setenv("LIGHTHOUSE_TPU_PUSH_CHUNK_ROWS", "32")
    assert materialize_state(state)
    assert tv.LAST_COLD_TIMINGS["push_chunks"] == 4
    assert state.tree_hash_root() == jstate.tree_hash_root()
    for s in (state, jstate):
        s.validators.wcol("effective_balance")[7] = np.uint64(5 * 10 ** 9)
        s.balances[3] = np.uint64(1)
    assert state.tree_hash_root() == jstate.tree_hash_root()
