"""The port's state transition on the CPU, byte for byte against the JAX
package.

- Shuffling, committees and proposer indices: ``shuffled_positions``,
  ``compute_proposer_index`` and every committee and proposer of a seeded
  registry's epochs equal the JAX package's (exact).
- A chain: the JAX package's ``StateHarness`` builds a MINIMAL Capella
  chain of 4 epochs + 1 slot (64 validators, the fake BLS backend) with a
  deposit, a voluntary exit, a proposer slashing and an attester slashing.
  Each block is carried into the port by its SSZ bytes and applied by the
  port's ``state_transition`` (``VERIFY_BULK``: the overlapped signature
  dispatch runs, on the fake backend); after every block the port's
  post-state SSZ bytes equal the reference's.  The replay runs with the
  epoch sweep on numpy and on torch (``LIGHTHOUSE_TPU_EPOCH_DEVICE``).
"""

import numpy as np
import pytest
import torch

from lighthouse_tpu.crypto import bls as jbls
from lighthouse_tpu.state_transition import committees as jcom
from lighthouse_tpu.state_transition import shuffle as jshuf
from lighthouse_tpu.testing.harness import StateHarness as JHarness
from lighthouse_tpu.testing.random_states import random_epoch_state
from lighthouse_tpu.types.chain_spec import ForkName as JForkName
from lighthouse_tpu.types.factory import spec_types as jspec_types
from lighthouse_tpu.types.presets import MINIMAL as JMINIMAL
from lighthouse_tpu_torch import device
from lighthouse_tpu_torch.crypto import bls as tbls
from lighthouse_tpu_torch.state_transition import committees as tcom
from lighthouse_tpu_torch.state_transition import shuffle as tshuf
from lighthouse_tpu_torch.state_transition import state_transition
from lighthouse_tpu_torch.types import MINIMAL, ChainSpec, ForkName
from lighthouse_tpu_torch.types.carry import signed_block_from_ssz, \
    state_from_ssz
from lighthouse_tpu_torch.types.factory import spec_types

CHAIN_SLOTS = 4 * 8 + 1          # 4 MINIMAL epochs + 1 slot


@pytest.fixture(autouse=True, scope="module")
def _cpu():
    prev, threads = device.default_device(), torch.get_num_threads()
    device.set_default_device("cpu")
    torch.set_num_threads(1)
    yield
    device.set_default_device(prev)
    torch.set_num_threads(threads)


def _ser(obj) -> bytes:
    return type(obj).serialize(obj)


@pytest.mark.parametrize("count", [1, 2, 97, 1000, 4096])
def test_shuffled_positions_and_proposer_equal_reference(count):
    rng = np.random.default_rng(count)
    for _ in range(3):
        seed = rng.bytes(32)
        np.testing.assert_array_equal(
            tshuf.shuffled_positions(count, seed, 10),
            jshuf.shuffled_positions(count, seed, 10))
        eff = (rng.integers(0, 33, count) * 10 ** 9).astype(np.uint64)
        eff[0] = 32 * 10 ** 9       # at least one candidate passes
        idx = np.arange(count, dtype=np.uint64)
        assert tshuf.compute_proposer_index(eff, idx, seed, 10, 32 * 10 ** 9) \
            == jshuf.compute_proposer_index(eff, idx, seed, 10, 32 * 10 ** 9)


@pytest.mark.parametrize("n", [64, 1500])
def test_committees_and_proposers_equal_reference(n):
    """Every committee of two epochs and every slot's proposer of a seeded
    registry (carried by SSZ bytes) equal the JAX package's."""
    js = random_epoch_state(np.random.default_rng(n), n,
                            jspec_types(JMINIMAL), JMINIMAL,
                            JForkName.CAPELLA)
    ps = state_from_ssz(_ser(js), "minimal", "capella")
    slot = int(js.slot)
    epoch = slot // MINIMAL.SLOTS_PER_EPOCH
    for e in (epoch - 1, epoch):
        jc = jcom.CommitteeCache(js, e, JMINIMAL)
        pc = tcom.CommitteeCache(ps, e, MINIMAL)
        np.testing.assert_array_equal(pc.shuffled, jc.shuffled)
        assert pc.committees_per_slot == jc.committees_per_slot
        for s in range(e * 8, e * 8 + 8):
            for a, b in zip(pc.committees_at_slot(s),
                            jc.committees_at_slot(s)):
                np.testing.assert_array_equal(a, b)
    for s in range(epoch * 8, slot + 1):
        assert tcom.get_beacon_proposer_index(ps, MINIMAL, slot=s) == \
            jcom.get_beacon_proposer_index(js, JMINIMAL, slot=s)


@pytest.fixture(scope="module")
def reference_chain():
    """The JAX package's chain: genesis bytes, then per block the block's
    bytes, its fork, the eth1_data the harness pre-set on the live state
    before building it (a deposit's), and the post-state bytes."""
    prev = jbls._active
    jbls.set_backend("fake")
    try:
        h = JHarness(64)
        h.spec.shard_committee_period = 0    # exits from genesis on
        genesis = _ser(h.state)
        out = []
        ops = {3: "deposit", 6: "exit", 9: "proposer_slashing",
               12: "attester_slashing"}
        i = 0
        while int(h.state.slot) < CHAIN_SLOTS:
            kw = {}
            op = ops.get(i)
            if op == "deposit":
                h.make_deposit(64)
            elif op == "exit":
                kw["voluntary_exits"] = [h.make_exit(h.state, 5)]
            elif op == "proposer_slashing":
                kw["proposer_slashings"] = [
                    h.make_proposer_slashing(h.state, 3)]
            elif op == "attester_slashing":
                kw["attester_slashings"] = [
                    h.make_attester_slashing(h.state, [10, 11])]
            sb = h.build_block(**kw)
            eth1 = _ser(h.state.eth1_data)
            h.apply_block(sb)
            out.append((_ser(sb), h.fork_at(int(sb.message.slot)).value,
                        eth1, _ser(h.state)))
            i += 1
        st = h.state
        slashed = st.validators.col("slashed")
        assert len(st.validators) == 65                  # the deposit
        assert bool(slashed[3]) and bool(slashed[10]) and bool(slashed[11])
        assert int(st.validators.col("exit_epoch")[5]) < 2 ** 64 - 1
        assert int(st.finalized_checkpoint.epoch) >= 1   # finality moved
        return genesis, out
    finally:
        jbls._active = prev


@pytest.mark.parametrize("epoch_device", ["0", "1"],
                         ids=["numpy_sweep", "torch_sweep"])
def test_chain_post_states_equal_reference(reference_chain, epoch_device,
                                           monkeypatch):
    monkeypatch.setenv("LIGHTHOUSE_TPU_EPOCH_DEVICE", epoch_device)
    genesis, blocks = reference_chain
    prev = tbls._active
    tbls.set_backend("fake")
    try:
        spec = ChainSpec.minimal().with_forks_at_genesis(ForkName.CAPELLA)
        spec.shard_committee_period = 0
        T = spec_types(MINIMAL)
        state = state_from_ssz(genesis, "minimal", "capella")
        for k, (block, fork, eth1, want) in enumerate(blocks):
            state.eth1_data = T.Eth1Data.deserialize(eth1)
            sb = signed_block_from_ssz(block, "minimal", fork)
            state = state_transition(state, sb, MINIMAL, spec, T)
            assert _ser(state) == want, f"block {k} (slot {sb.message.slot})"
    finally:
        tbls._active = prev
