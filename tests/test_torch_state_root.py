"""The port's BeaconState root on the CPU, bit for bit against the JAX package.

A MAINNET Capella state is built in the JAX package from a numpy seed and
carried into the port through its SSZ bytes (``types.carry.
state_from_ssz``).  The port's three root paths — uncached
(``type(state).hash_tree_root``), host-cached (``tree_hash_root`` with the
incremental caches) and materialized (device-resident registry mirror and
packed-column trees) — must each equal the JAX package's
``tree_hash_root()`` through randomised mutation rounds, copy-on-write
clones and a registry append across a power-of-two boundary.

The port's kernels run as their plain versions here (CPU tensors).
"""

import numpy as np
import pytest
import torch

from lighthouse_tpu.types.chain_spec import ForkName as JForkName
from lighthouse_tpu.types.factory import spec_types as jspec_types
from lighthouse_tpu.types.presets import MAINNET as JMAINNET
from lighthouse_tpu.types.validators import Validator as JValidator
from lighthouse_tpu.types.validators import ValidatorRegistry as JRegistry
from lighthouse_tpu_torch import device
from lighthouse_tpu_torch.ops import merkle_kernel as mk
from lighthouse_tpu_torch.types import validators as tv
from lighthouse_tpu_torch.types.carry import (registry_from_columns,
                                              state_from_ssz)
from lighthouse_tpu_torch.types.device_state import (DeviceColumn,
                                                     materialize_state,
                                                     store_column)
from lighthouse_tpu_torch.types.validators import Validator as TValidator

FAR = 2 ** 64 - 1


@pytest.fixture(autouse=True, scope="module")
def _cpu():
    prev, threads = device.default_device(), torch.get_num_threads()
    device.set_default_device("cpu")
    torch.set_num_threads(1)
    yield
    device.set_default_device(prev)
    torch.set_num_threads(threads)


def _jax_state(n: int, seed: int):
    rng = np.random.default_rng(seed)
    state = jspec_types(JMAINNET).state_cls(JForkName.CAPELLA)()
    reg = JRegistry(n)
    reg._n = n
    reg.init_columns(
        pubkey=rng.integers(0, 256, (n, 48), dtype=np.uint8),
        withdrawal_credentials=rng.integers(0, 256, (n, 32), dtype=np.uint8),
        effective_balance=(rng.integers(0, 33, n) * 10 ** 9).astype(
            np.uint64),
        slashed=rng.random(n) < 0.1,
        activation_epoch=rng.integers(0, 1000, n).astype(np.uint64))
    state.validators = reg
    state.balances = rng.integers(0, 40 * 10 ** 9, n).astype(np.uint64)
    state.previous_epoch_participation = rng.integers(0, 8, n).astype(
        np.uint8)
    state.current_epoch_participation = rng.integers(0, 8, n).astype(np.uint8)
    state.inactivity_scores = rng.integers(0, 100, n).astype(np.uint64)
    state.slot = 12345
    state.block_roots[:40] = rng.integers(0, 256, (40, 32), dtype=np.uint8)
    return state


def _carry(jstate):
    return state_from_ssz(type(jstate).serialize(jstate), JMAINNET,
                          JForkName.CAPELLA)


def _uncached(state) -> bytes:
    return type(state).hash_tree_root(state)


def _validator(cls, rng):
    return cls(
        pubkey=rng.integers(0, 256, 48, dtype=np.uint8).tobytes(),
        withdrawal_credentials=rng.integers(0, 256, 32,
                                            dtype=np.uint8).tobytes(),
        effective_balance=int(rng.integers(0, 33)) * 10 ** 9,
        slashed=bool(rng.random() < 0.5),
        activation_eligibility_epoch=int(rng.integers(0, 10)),
        activation_epoch=int(rng.integers(0, 10)),
        exit_epoch=FAR,
        withdrawable_epoch=FAR)


def _mutate(s, seed: int, vcls) -> None:
    """One round of mixed writes, identical for every state given the
    same seed (each state gets its own generator)."""
    rng = np.random.default_rng(seed)
    n = len(s.validators)
    for _ in range(int(rng.integers(1, 4))):
        i = int(rng.integers(0, n))
        col = ("effective_balance", "exit_epoch", "withdrawable_epoch")[
            int(rng.integers(0, 3))]
        s.validators.wcol(col)[i] = np.uint64(rng.integers(0, 1 << 40))
    s.validators.wcol("slashed")[int(rng.integers(0, n))] = True
    s.validators.set(int(rng.integers(0, n)), _validator(vcls, rng))
    idx = np.unique(rng.integers(0, n, 5))
    s.balances[idx] = np.uint64(rng.integers(0, 1 << 40))
    s.previous_epoch_participation[int(rng.integers(0, n))] = np.uint8(7)
    bal = np.asarray(s.inactivity_scores, dtype=np.uint64).copy()
    touched = np.unique(rng.integers(0, n, 3))
    bal[touched] += np.uint64(3)
    store_column(s, "inactivity_scores", bal, touched=touched)
    s.slashings = np.asarray(s.slashings).copy()
    s.slashings[int(rng.integers(0, len(s.slashings)))] = np.uint64(
        rng.integers(0, 1 << 30))


def test_carried_state_is_the_same_state():
    jstate = _jax_state(70, seed=1)
    state = _carry(jstate)
    assert type(state).serialize(state) == type(jstate).serialize(jstate)
    assert len(state.validators) == 70


def test_three_paths_match_reference_under_mutation():
    jstate = _jax_state(70, seed=2)
    cached = _carry(jstate)
    dev = _carry(jstate)
    assert materialize_state(dev)
    assert isinstance(dev.__dict__["balances"], DeviceColumn)
    ref = jstate.tree_hash_root()
    assert _uncached(cached) == ref
    assert cached.tree_hash_root() == ref
    assert dev.tree_hash_root() == ref

    for rnd in range(4):
        for s, vcls in ((jstate, JValidator), (cached, TValidator),
                        (dev, TValidator)):
            _mutate(s, 1000 + rnd, vcls)
        if rnd == 1:
            dev.tree_hash_root()  # desynchronise the cache cadences
        ref = jstate.tree_hash_root()
        assert cached.tree_hash_root() == ref, f"host-cached, round {rnd}"
        assert dev.tree_hash_root() == ref, f"materialized, round {rnd}"
    assert _uncached(dev) == ref


def test_append_across_power_of_two_boundary():
    jstate = _jax_state(62, seed=3)
    cached, dev = _carry(jstate), _carry(jstate)
    assert materialize_state(dev)
    assert dev.tree_hash_root() == jstate.tree_hash_root()
    cached.tree_hash_root()
    for s, vcls in ((jstate, JValidator), (cached, TValidator),
                    (dev, TValidator)):
        rng = np.random.default_rng(4)
        for _ in range(5):  # 62 → 67 records: the record tree 64 → 128
            s.validators.append(_validator(vcls, rng))
            s.balances = np.concatenate(
                [np.asarray(s.balances, dtype=np.uint64),
                 np.array([32 * 10 ** 9], dtype=np.uint64)])
    ref = jstate.tree_hash_root()
    assert cached.tree_hash_root() == ref
    assert dev.tree_hash_root() == ref
    assert _uncached(cached) == ref


def test_materialized_copy_on_write():
    """A clone shares every device buffer; writes on either side clone
    first, so neither lineage sees the other's mutation."""
    jstate = _jax_state(40, seed=5)
    dev = _carry(jstate)
    assert materialize_state(dev)
    r0 = dev.tree_hash_root()
    clone = dev.copy()
    jclone = jstate.copy()
    for s in (clone, jclone):
        s.balances[0] = np.uint64(1)
        s.validators.wcol("effective_balance")[2] = np.uint64(3)
    assert clone.tree_hash_root() == jclone.tree_hash_root() != r0
    assert dev.tree_hash_root() == r0 == jstate.tree_hash_root()
    for s in (dev, jstate):
        s.validators.wcol("exit_epoch")[7] = np.uint64(9)
        s.balances[7] = np.uint64(9)
    assert dev.tree_hash_root() == jstate.tree_hash_root()
    assert clone.tree_hash_root() == jclone.tree_hash_root()


def test_adopted_device_column_roots_without_pull():
    """A torch tensor stored into a materialized column is adopted: the
    root repacks it on the device and matches the reference assigning the
    same values."""
    jstate = _jax_state(50, seed=6)
    dev = _carry(jstate)
    assert materialize_state(dev)
    dev.tree_hash_root()
    vals = np.random.default_rng(7).integers(0, 1 << 40, 50).astype(
        np.uint64)
    store_column(dev, "balances", torch.tensor(vals.view(np.int64)))
    jstate.balances = vals
    assert dev.__dict__["balances"]._adopted
    assert dev.tree_hash_root() == jstate.tree_hash_root()
    dev.balances[4] = np.uint64(5)  # host write after adoption
    jstate.balances[4] = np.uint64(5)
    assert dev.tree_hash_root() == jstate.tree_hash_root()


def test_registry_from_columns_and_fused_registry_root():
    jstate = _jax_state(128, seed=8)
    jreg = jstate.validators
    reg = registry_from_columns({c: jreg.col(c) for c in jreg._COLUMNS})
    limit = JMAINNET.VALIDATOR_REGISTRY_LIMIT
    ref = jreg.hash_tree_root(limit)
    assert reg.hash_tree_root(limit) == ref
    before = dict(mk.LAUNCHES)
    cols = tv.registry_device_columns(reg)
    assert tv.registry_root_device(cols, 128, limit) == ref
    assert mk.LAUNCHES == before  # CPU tensors: plain versions only
    with pytest.raises(ValueError):
        tv.registry_root_device(cols, 100, limit)


def test_record_roots_device_batch_matches_host():
    """Above HOST_DISPATCH_THRESHOLD records the roots are one device
    batch; below it host hashlib.  Both agree with the reference."""
    jstate = _jax_state(4100, seed=9)
    jreg = jstate.validators
    reg = registry_from_columns({c: jreg.col(c) for c in jreg._COLUMNS})
    got = reg.record_roots_words()
    assert np.array_equal(got, jreg.record_roots_words())
    idx = np.array([0, 17, 4099])
    assert np.array_equal(reg.record_roots_words(idx), got[idx])
