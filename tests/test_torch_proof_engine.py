"""The port's Merkle proof engine (``ops/proof_engine.py``) and host proofs
(``ops/merkle_proof.py``), on the CPU.

Branches and multiproofs gathered from a ``DeviceTree`` must equal the JAX
package's host ``MerkleTree`` proofs and verify; the ``ProofServer``'s
state proofs of every field of a small seeded Capella state must equal the
JAX package's ``light_client.state_field_proof`` and ``ProofServer``
output byte for byte, with the device gather and with the host walk
(``LIGHTHOUSE_TPU_PROOF_DEVICE=0``).  The gather's device→host copy is 32
bytes per distinct node; concurrent requests share one tree build and one
gather; a failed gather raises.
"""

import threading

import numpy as np
import pytest
import torch

from lighthouse_tpu import light_client as JLC
from lighthouse_tpu.ops import merkle_proof as JMP
from lighthouse_tpu.ops import proof_engine as JPE
from lighthouse_tpu.types.chain_spec import ForkName as JForkName
from lighthouse_tpu.types.factory import spec_types as jspec_types
from lighthouse_tpu.types.presets import MAINNET as JMAINNET
from lighthouse_tpu.types.validators import ValidatorRegistry as JRegistry
from lighthouse_tpu_torch import device
from lighthouse_tpu_torch.common.device_ledger import LEDGER
from lighthouse_tpu_torch.ops import merkle_proof as MP
from lighthouse_tpu_torch.ops import proof_engine as PE
from lighthouse_tpu_torch.ops.device_tree import DeviceTree
from lighthouse_tpu_torch.types.carry import state_from_ssz


@pytest.fixture(autouse=True, scope="module")
def _cpu():
    prev, threads = device.default_device(), torch.get_num_threads()
    device.set_default_device("cpu")
    torch.set_num_threads(1)
    yield
    device.set_default_device(prev)
    torch.set_num_threads(threads)


def _leaf_bytes(seed, n):
    rng = np.random.default_rng(seed)
    return [rng.bytes(32) for _ in range(n)]


def _tree(leaves, depth):
    """(port DeviceTree over the zero-padded leaves, JAX MerkleTree)."""
    jt = JMP.MerkleTree(depth)
    for leaf in leaves:
        jt.push_leaf(leaf)
    rows = leaves + [b"\x00" * 32] * ((1 << depth) - len(leaves))
    plane = np.frombuffer(b"".join(rows), ">u4").astype(
        np.uint32).reshape(-1, 8)
    return DeviceTree.from_host_leaves(plane), jt


@pytest.mark.parametrize("n,depth", [(1, 0), (5, 3), (37, 6), (256, 8)])
def test_device_branches_equal_merkle_tree_proofs(n, depth):
    leaves = _leaf_bytes(n, n)
    tree, jt = _tree(leaves, depth)
    eng = PE.DeviceProofEngine(tree)
    idx = sorted({0, n - 1, n // 2, min(n, (1 << depth) - 1)})
    branches = eng.branches([(1 << depth) + i for i in idx])
    pt = MP.MerkleTree(depth)
    for leaf in leaves:
        pt.push_leaf(leaf)
    assert pt.root() == jt.root()
    for i in idx:
        br = branches[(1 << depth) + i]
        assert br == jt.proof(i) == pt.proof(i)
        leaf = leaves[i] if i < n else b"\x00" * 32
        assert MP.verify_merkle_proof(leaf, br, depth, i, jt.root())
        assert JMP.verify_merkle_proof(leaf, br, depth, i, jt.root())


def test_interior_nodes_and_the_d2h_bytes():
    leaves = _leaf_bytes(9, 64)
    tree, jt = _tree(leaves, 6)
    eng = PE.DeviceProofEngine(tree)
    LEDGER.reset()
    gs = [1, 2, 3, 5, 64, 100, 127, 100, 3]
    nodes = eng.extract_nodes(gs)
    levels = jt._levels()
    for g in set(gs):
        d = g.bit_length() - 1
        assert nodes[g] == levels[6 - d][g - (1 << d)]
    row = LEDGER.snapshot()["subsystems"]["proof_engine"]
    assert row["d2h_bytes"] == 32 * len(set(gs)) and row["d2h_ops"] == 1
    assert row["h2d_ops"] == 1 and row["dispatches"] == 1


@pytest.mark.parametrize("gset", [[70, 71], [64, 127, 9], [2, 64], [1]])
def test_multiproof_verifies_and_equals_the_jax_helpers(gset):
    leaves = _leaf_bytes(11, 40)
    tree, jt = _tree(leaves, 6)
    got_leaves, proof, helpers = PE.DeviceProofEngine(tree).multiproof(gset)
    assert helpers == JPE.helper_gindices(gset)
    assert PE.verify_merkle_multiproof(got_leaves, proof, gset, jt.root())
    assert JPE.verify_merkle_multiproof(got_leaves, proof, gset, jt.root())
    assert not PE.verify_merkle_multiproof(got_leaves, proof[::-1] + [],
                                           gset, b"\x01" * 32)


@pytest.mark.parametrize("g", [1, 2, 7, 100, 1 << 20])
def test_gindex_helpers_equal_the_jax_package(g):
    assert PE.branch_gindices(g) == JPE.branch_gindices(g)
    assert PE.path_gindices(g) == JPE.path_gindices(g)
    assert PE.helper_gindices([g, g ^ 1]) == JPE.helper_gindices([g, g ^ 1])


@pytest.mark.parametrize("bad", [0, -1, 128])
def test_bad_gindex_raises(bad):
    tree, _jt = _tree(_leaf_bytes(1, 64), 6)
    with pytest.raises(ValueError, match="gindex"):
        PE.DeviceProofEngine(tree).branches([bad])


def test_deposit_tree_equals_the_jax_package():
    jd, pd = JMP.DepositTree(), MP.DepositTree()
    for leaf in _leaf_bytes(5, 5):
        jd.push(leaf)
        pd.push(leaf)
    assert pd.root() == jd.root() and pd.count == 5
    assert pd.proof(3) == jd.proof(3)
    assert MP.verify_merkle_proof(_leaf_bytes(5, 5)[3], pd.proof(3), 33, 3,
                                  pd.root())


# ---------------------------------------------------------------------------
# ProofServer over a small Capella state
# ---------------------------------------------------------------------------

def _states(n=64, seed=17):
    rng = np.random.default_rng(seed)
    jstate = jspec_types(JMAINNET).state_cls(JForkName.CAPELLA)()
    reg = JRegistry(n)
    reg._n = n
    reg.init_columns(
        pubkey=rng.integers(0, 256, (n, 48), dtype=np.uint8),
        withdrawal_credentials=rng.integers(0, 256, (n, 32), dtype=np.uint8),
        effective_balance=(rng.integers(0, 33, n) * 10 ** 9).astype(
            np.uint64),
        activation_epoch=rng.integers(0, 1000, n).astype(np.uint64))
    jstate.validators = reg
    jstate.balances = rng.integers(0, 40 * 10 ** 9, n).astype(np.uint64)
    jstate.slot = 4242
    jstate.block_roots[:9] = rng.integers(0, 256, (9, 32), dtype=np.uint8)
    state = state_from_ssz(type(jstate).serialize(jstate), JMAINNET,
                           JForkName.CAPELLA)
    return jstate, state


@pytest.fixture(scope="module")
def states():
    return _states()


def test_field_branch_of_every_field_equals_light_client(states):
    jstate, state = states
    root = jstate.tree_hash_root()
    assert state.tree_hash_root() == root
    server = PE.ProofServer(window_ms=0)
    names = list(type(state).FIELDS)
    assert names == list(type(jstate).FIELDS)
    for name in names:
        got = server.field_branch(state, name)
        assert got == JLC.state_field_proof(jstate, name)
        field_root = type(jstate).FIELDS[name].hash_tree_root(
            getattr(jstate, name))
        assert JLC.verify_field_proof(field_root, got[0], got[1], root)
    stats = server.stats()
    assert stats["device_served"] == len(names) and stats["host_served"] == 0
    assert stats["cached_state_trees"] == 1


def test_state_proof_and_multiproof_equal_the_jax_server(states):
    jstate, state = states
    width = 1 << (len(type(state).FIELDS) - 1).bit_length()
    gs = [width + i for i in range(len(type(state).FIELDS))] + [2, 3, 9]
    got = PE.ProofServer(window_ms=0).state_proof(state, gs)
    assert got == JPE.ProofServer(window_ms=0).state_proof(jstate, gs)
    multi = PE.ProofServer(window_ms=0).state_multiproof(state, gs[:5])
    assert multi == JPE.ProofServer(window_ms=0).state_multiproof(jstate,
                                                                  gs[:5])
    assert PE.verify_merkle_multiproof(multi[0], multi[1], gs[:5],
                                       state.tree_hash_root())


def test_host_walk_oracle_is_byte_equal(states, monkeypatch):
    _jstate, state = states
    width = 1 << (len(type(state).FIELDS) - 1).bit_length()
    gs = [width + i for i in range(len(type(state).FIELDS))]
    device_side = PE.ProofServer(window_ms=0)
    want = device_side.state_proof(state, gs)
    monkeypatch.setenv("LIGHTHOUSE_TPU_PROOF_DEVICE", "0")
    host_side = PE.ProofServer(window_ms=0)
    assert host_side.state_proof(state, gs) == want
    assert host_side.stats()["host_served"] == 1
    assert host_side.stats()["device_served"] == 0


def test_a_failed_gather_raises_instead_of_walking(states, monkeypatch):
    _jstate, state = states

    def broken(self, gindices):
        raise RuntimeError("device gather failed")

    monkeypatch.setattr(PE.DeviceProofEngine, "extract_nodes", broken)
    server = PE.ProofServer(window_ms=0)
    with pytest.raises(RuntimeError, match="gather failed"):
        server.field_branch(state, "slot")
    assert server.stats()["host_served"] == 0


def test_state_proof_validates_gindices(states):
    _jstate, state = states
    server = PE.ProofServer(window_ms=0)
    with pytest.raises(ValueError):
        server.state_proof(state, [0])
    with pytest.raises(ValueError):
        server.state_proof(state, [1 << 10])


def test_concurrent_requests_share_one_build_and_one_gather(monkeypatch):
    jstate, state = _states(n=32, seed=23)
    state.tree_hash_root()     # the state's hash cache is warm, as a head's
    builds = []
    real = DeviceTree.from_host_leaves.__func__

    def counting(cls, leaves):
        builds.append(leaves.shape[0])
        return real(cls, leaves)

    monkeypatch.setattr(DeviceTree, "from_host_leaves",
                        classmethod(counting))
    server = PE.ProofServer(window_ms=200, max_batch=1024)
    names = list(type(state).FIELDS)[:8]
    barrier = threading.Barrier(len(names))
    out, errors = {}, []

    def request(name):
        try:
            barrier.wait()
            out[name] = server.field_branch(state, name)
        except Exception as e:  # noqa: BLE001 — reported below
            errors.append(e)

    threads = [threading.Thread(target=request, args=(n,)) for n in names]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errors
    assert len(builds) == 1
    stats = server.stats()
    assert stats["requests"] == len(names)
    assert stats["dispatches"] < len(names)
    assert stats["coalesced"] > 0        # the shared upper siblings
    for name in names:
        assert out[name] == JLC.state_field_proof(jstate, name)
