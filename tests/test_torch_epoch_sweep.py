"""The port's fused epoch sweep as torch ops, held exactly against numpy.

``per_epoch_device.sweep`` carries u64 columns as int64 bit patterns; its
unsigned comparison, min/max and floor division must give the numpy
sweep's bits on every input, values near 2^64 included.  Each case builds
a seeded state in the JAX package (``testing.random_states``), carries it
into the port by its SSZ bytes, and runs the fused inactivity/rewards
step three ways: the JAX package's numpy sweep, the port's numpy sweep
(``LIGHTHOUSE_TPU_EPOCH_DEVICE`` off) and the port's torch sweep (on).
Scores, balances, rewards and penalties must be equal exactly
(tolerance 0); so must the whole ``process_epoch`` post-state against the
JAX package's, on a host state and on a materialized (device-column)
state.  The torch ops run on CPU tensors here.
"""

import numpy as np
import pytest
import torch

from lighthouse_tpu.state_transition import per_epoch as jpe
from lighthouse_tpu.testing.random_states import random_epoch_state
from lighthouse_tpu.types.chain_spec import ChainSpec as JChainSpec
from lighthouse_tpu.types.chain_spec import ForkName as JForkName
from lighthouse_tpu.types.factory import spec_types as jspec_types
from lighthouse_tpu.types.presets import MINIMAL as JMINIMAL
from lighthouse_tpu_torch import device
from lighthouse_tpu_torch.state_transition import per_epoch as tpe
from lighthouse_tpu_torch.state_transition import per_epoch_device as ped
from lighthouse_tpu_torch.types import MINIMAL, ChainSpec, ForkName
from lighthouse_tpu_torch.types.carry import state_from_ssz
from lighthouse_tpu_torch.types.device_state import materialize_state

U64 = 2 ** 64
FORK = JForkName.CAPELLA


@pytest.fixture(autouse=True, scope="module")
def _cpu():
    prev, threads = device.default_device(), torch.get_num_threads()
    device.set_default_device("cpu")
    torch.set_num_threads(1)
    yield
    device.set_default_device(prev)
    torch.set_num_threads(threads)


def _ser(state) -> bytes:
    return type(state).serialize(state)


def _states(seed: int, n: int, in_leak: bool, extreme: bool):
    """A JAX-package epoch state and its port copy (by SSZ bytes).
    ``extreme`` puts a quarter of the scores, balances and effective
    balances within 2^20 of 2^64."""
    rng = np.random.default_rng(seed)
    T = jspec_types(JMINIMAL)
    js = random_epoch_state(rng, n, T, JMINIMAL, FORK)
    epoch = int(js.slot) // JMINIMAL.SLOTS_PER_EPOCH
    if in_leak:  # far enough from finality; no sync-committee boundary
        epoch = max(epoch, 9)
        while (epoch + 1) % JMINIMAL.EPOCHS_PER_SYNC_COMMITTEE_PERIOD == 0:
            epoch += 1
        js.slot = (epoch + 1) * JMINIMAL.SLOTS_PER_EPOCH - 1
    # previous_epoch - finalized > MIN_EPOCHS_TO_INACTIVITY_PENALTY ⇔ leak
    fin = max(epoch - 1 - 5, 0) if in_leak else epoch - 2
    js.finalized_checkpoint = T.Checkpoint(epoch=fin, root=b"\x01" * 32)
    if extreme:
        def near(mask):
            k = int(mask.sum())
            return np.uint64(U64 - 1) - rng.integers(0, 1 << 20, k,
                                                     dtype=np.uint64)

        scores = np.array(js.inactivity_scores, dtype=np.uint64)
        pick = rng.random(n) < 0.25
        scores[pick] = near(pick)
        js.inactivity_scores = scores
        bal = np.array(js.balances, dtype=np.uint64)
        pick = rng.random(n) < 0.25
        bal[pick] = near(pick)
        js.balances = bal
        eff = js.validators.wcol("effective_balance")
        pick = rng.random(n) < 0.25
        eff[pick] = near(pick)
    assert jpe.is_in_inactivity_leak(js, JMINIMAL) == in_leak
    ps = state_from_ssz(_ser(js), "minimal", "capella")
    return js, ps


def _jax_sweep(js):
    spec = JChainSpec.minimal()
    ctx = jpe.build_epoch_context(js, JMINIMAL)
    summary = jpe.EpochSummary()
    jpe._fused_inactivity_and_rewards(js, FORK, JMINIMAL, spec, ctx,
                                      summary, {})
    return summary


def _port_sweep(ps, on: bool, monkeypatch):
    monkeypatch.setenv("LIGHTHOUSE_TPU_EPOCH_DEVICE", "1" if on else "0")
    spec = ChainSpec.minimal()
    ctx = tpe.build_epoch_context(ps, MINIMAL)
    summary = tpe.EpochSummary()
    timings: dict = {}
    tpe._fused_inactivity_and_rewards(ps, ForkName.CAPELLA, MINIMAL, spec,
                                      ctx, summary, timings)
    assert timings.get("device", False) is on
    return summary


def _cols(state, summary) -> dict:
    return {"scores": np.asarray(state.inactivity_scores, dtype=np.uint64),
            "balances": np.asarray(state.balances, dtype=np.uint64),
            "rewards": np.asarray(summary.rewards, dtype=np.uint64),
            "penalties": np.asarray(summary.penalties, dtype=np.uint64)}


@pytest.mark.parametrize("in_leak", [False, True], ids=["no_leak", "leak"])
@pytest.mark.parametrize("extreme", [False, True], ids=["spec", "near_2_64"])
def test_torch_sweep_equals_numpy_sweeps(in_leak, extreme, monkeypatch):
    js, ps = _states(7 + 2 * in_leak + extreme, 3000, in_leak, extreme)
    ps_np = state_from_ssz(_ser(js), "minimal", "capella")
    want = _cols(js, _jax_sweep(js))
    port_np = _cols(ps_np, _port_sweep(ps_np, False, monkeypatch))
    port_torch = _cols(ps, _port_sweep(ps, True, monkeypatch))
    if extreme:  # the adversarial values really are near 2^64
        assert int(want["scores"].max()) > U64 - (1 << 21)
    for name in want:
        np.testing.assert_array_equal(port_np[name], want[name], name)
        np.testing.assert_array_equal(port_torch[name], want[name], name)


_EDGES = [0, 1, 2, 3, 63, 64, 10 ** 9, 2 ** 32 - 1, 2 ** 32, 2 ** 62,
          2 ** 63 - 1, 2 ** 63, 2 ** 63 + 1, U64 - 10 ** 9, U64 - 2, U64 - 1]


def _t(vals) -> torch.Tensor:
    return torch.from_numpy(np.array(vals, dtype=np.uint64).view(np.int64))


def _u(t: torch.Tensor) -> list:
    return [int(v) for v in t.numpy().view(np.uint64)]


@pytest.mark.parametrize("d", [1, 2, 3, 7, 64, 10 ** 9, 2 ** 26 * 3,
                               2 ** 62 + 1, 2 ** 63 - 1, 2 ** 63,
                               2 ** 63 + 5, U64 - 1])
def test_unsigned_helpers_on_edges(d):
    """``_udiv`` / ``_ult`` / ``_umin`` / ``_umax`` against python ints on
    the edges of the u64 range (exact)."""
    xs = _EDGES + [d - 1, d, d + 1 if d + 1 < U64 else 0, 2 * d % U64]
    x = _t(xs)
    assert _u(ped._udiv(x, d)) == [v // d for v in xs]
    y = _t(list(reversed(xs)))
    ys = list(reversed(xs))
    assert ped._ult(x, y).tolist() == [a < b for a, b in zip(xs, ys)]
    assert ped._ult(x, d).tolist() == [a < d for a in xs]
    assert _u(ped._umin(x, y)) == [min(a, b) for a, b in zip(xs, ys)]
    assert _u(ped._umin(x, d)) == [min(a, d) for a in xs]
    assert _u(ped._umax(x, d)) == [max(a, d) for a in xs]


@pytest.mark.parametrize("materialized", [False, True],
                         ids=["host", "device_columns"])
def test_process_epoch_device_sweep_equals_reference(materialized,
                                                     monkeypatch):
    """Whole ``process_epoch`` with the torch sweep on equals the JAX
    package's numpy epoch, byte for byte, and the post-state roots agree;
    on a materialized state the sweep's scores and balances are adopted
    tensors and the warm root re-reduces them."""
    js, ps = _states(31, 2048, False, False)
    if materialized:
        assert materialize_state(ps)
    jpe.process_epoch(js, FORK, JMINIMAL, JChainSpec.minimal(),
                      jspec_types(JMINIMAL))
    monkeypatch.setenv("LIGHTHOUSE_TPU_EPOCH_DEVICE", "1")
    from lighthouse_tpu_torch.types.factory import spec_types
    tpe.process_epoch(ps, ForkName.CAPELLA, MINIMAL, ChainSpec.minimal(),
                      spec_types(MINIMAL))
    assert tpe.LAST_EPOCH_TIMINGS.get("device") is True
    if materialized:
        assert ps.__dict__["balances"]._adopted
    assert ps.tree_hash_root() == js.tree_hash_root()
    assert _ser(ps) == _ser(js)


@pytest.mark.parametrize("in_leak", [False, True], ids=["no_leak", "leak"])
@pytest.mark.parametrize("epoch_device", ["0", "1"],
                         ids=["numpy_sweep", "torch_sweep"])
def test_process_epoch_equals_reference_stepwise(in_leak, epoch_device,
                                                 monkeypatch):
    """The port has only the single-pass epoch; its oracle is the JAX
    package's stepwise epoch (one spec step at a time): the port's
    ``process_epoch``, sweep on numpy or on torch, equals it byte for
    byte."""
    js, ps = _states(41 + in_leak, 2048, in_leak, False)
    jpe.process_epoch_stepwise(js, FORK, JMINIMAL, JChainSpec.minimal(),
                               jspec_types(JMINIMAL))
    monkeypatch.setenv("LIGHTHOUSE_TPU_EPOCH_DEVICE", epoch_device)
    from lighthouse_tpu_torch.types.factory import spec_types
    tpe.process_epoch(ps, ForkName.CAPELLA, MINIMAL, ChainSpec.minimal(),
                      spec_types(MINIMAL))
    assert tpe.LAST_EPOCH_TIMINGS.get("device", False) is (
        epoch_device == "1")
    assert _ser(ps) == _ser(js)


def test_device_sweep_raises_instead_of_falling_back(monkeypatch):
    """With the knob on, a sweep the device cannot run raises: the port
    has no numpy fallback."""
    js, ps = _states(5, 256, False, False)

    def broken(*a, **k):
        raise RuntimeError("device sweep failed")

    monkeypatch.setattr(ped, "sweep", broken)
    with pytest.raises(RuntimeError, match="device sweep failed"):
        _port_sweep(ps, True, monkeypatch)
