"""The port's staged executor (``parallel/pipeline.py``) on the CPU: item
order and results, the ledger's staged bytes, the one retry after a staging
fault, and the overlap statistics; and the stage profile, which
times the GPU only."""

import numpy as np
import pytest
import torch

from lighthouse_tpu_torch import device
from lighthouse_tpu_torch.common.device_ledger import LEDGER
from lighthouse_tpu_torch.crypto import profiling
from lighthouse_tpu_torch.parallel import pipeline
from lighthouse_tpu_torch.parallel.pipeline import StagedExecutor, stage_arrays


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The plain versions run thousands of small ops: one torch thread per
    test worker (for the module's fixtures too) keeps parallel workers from
    oversubscribing the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def on_cpu():
    prev = device.default_device()
    device.set_default_device("cpu")
    yield
    device.set_default_device(prev)


def _prep(i):
    return (np.full((2, 3), i, np.uint32), np.arange(i + 1, dtype=np.int32),
            i)


def test_map_stages_every_array_and_keeps_order():
    LEDGER.reset()
    ex = StagedExecutor("t", subsystem="bls")
    out = ex.map(range(3), _prep,
                 lambda st: (int(st[0].sum()), st[1].shape[0], st[2]))
    assert out == [(0, 1, 0), (6, 2, 1), (12, 3, 2)]
    # the staged bytes are the device ledger's, under the executor's
    # subsystem
    bls_row = LEDGER.snapshot()["subsystems"]["bls"]
    assert bls_row["h2d_bytes"] == 3 * 24 + 4 * (1 + 2 + 3)
    assert bls_row["h2d_ops"] == 6
    assert ex.stats["items"] == 3 and ex.stats["fallbacks"] == 0
    # marshalling after the first dispatch ran with device work queued
    assert 0 < ex.overlap_efficiency() < 1
    staged = stage_arrays((np.ones(2, np.uint32), 4), "bls")
    assert staged[1] == 4 and staged[0].dtype == torch.int32


def test_one_retry_after_a_fault_then_it_propagates(monkeypatch):
    fails = {"stage": 1}

    def flaky_stage(host, subsystem):
        if fails["stage"]:
            fails["stage"] -= 1
            raise RuntimeError("transfer fault")
        return stage_arrays(host, subsystem)

    monkeypatch.setattr(pipeline, "stage_arrays", flaky_stage)
    ex = StagedExecutor("t")
    assert ex.map([5, 7], _prep, lambda st: int(st[0][0, 0])) == [5, 7]
    assert ex.stats["fallbacks"] == 1

    def broken(*_args):
        raise ValueError("always")

    # a dispatch fault is not retried
    ex = StagedExecutor("t")
    with pytest.raises(ValueError, match="always"):
        ex.map([1], _prep, broken)
    assert ex.stats["fallbacks"] == 0
    # nor is a second staging fault
    monkeypatch.setattr(pipeline, "stage_arrays", broken)
    monkeypatch.setattr(pipeline, "sync_stage_arrays", broken)
    ex = StagedExecutor("t")
    with pytest.raises(ValueError, match="always"):
        ex.map([1], _prep, lambda st: 0)
    assert ex.stats["fallbacks"] == 1
    assert StagedExecutor("t").overlap_efficiency() is None


def test_stage_profile_needs_the_gpu():
    with pytest.raises(RuntimeError, match="times the GPU"):
        profiling.profile_stages(n=1, C=2)
