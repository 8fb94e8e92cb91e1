"""The port's Merkle layer on the CPU, bit for bit against the JAX package.

The JAX side runs as its own CPU tests run it: the Pallas sub-tree kernel
through ``_chunk_roots_natural_impl(..., use_kernel=False)`` (the shared
``_halves_reduce`` body), tree levels through ``_levels_body(use_kernel=
False)``.  The port runs its kernels' plain versions (its wrappers take
them for CPU tensors).  Hashes have no tolerance: every comparison is
exact.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from lighthouse_tpu.ops import device_tree as jdt
from lighthouse_tpu.ops import merkle as jm
from lighthouse_tpu.ops import merkle_kernel as jmk
from lighthouse_tpu.ops import tree_cache as jtc
from lighthouse_tpu.ops.sha256 import words_to_bytes
from lighthouse_tpu_torch import device
from lighthouse_tpu_torch.ops import device_tree as dt
from lighthouse_tpu_torch.ops import merkle as tm
from lighthouse_tpu_torch.ops import merkle_kernel as mk
from lighthouse_tpu_torch.ops import tree_cache as ttc


@pytest.fixture(autouse=True, scope="module")
def _cpu():
    prev, threads = device.default_device(), torch.get_num_threads()
    device.set_default_device("cpu")
    torch.set_num_threads(1)
    yield
    device.set_default_device(prev)
    torch.set_num_threads(threads)


def _leaves(seed, n):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 2 ** 32, size=(n, 8), dtype=np.uint64).astype(
        np.uint32)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a).view(np.int32))


def _host_root(leaves, depth):
    chunks = [row.astype(">u4").tobytes() for row in leaves]
    return jm.merkleize_host(chunks, limit=1 << depth)


@pytest.mark.parametrize("chunk_log2,n_log2",
                         [(3, 3), (3, 5), (4, 4), (4, 7)])
def test_chunk_roots_natural_matches_reference(chunk_log2, n_log2):
    leaves = _leaves(n_log2, 1 << n_log2)
    ref = np.asarray(jmk._chunk_roots_natural_impl(
        jnp.asarray(leaves), chunk_log2, use_kernel=False))
    got = mk.chunk_roots_natural(_t(leaves), chunk_log2)
    assert np.array_equal(got.numpy().view(np.uint32), ref)


@pytest.mark.parametrize("n,chunk_log2", [(8, 4), (24, 4), (2048, 11),
                                          (8, 0)])
def test_chunk_roots_natural_rejects_bad_shapes(n, chunk_log2):
    """Fewer leaves than a chunk, a ragged last chunk, and a chunk size
    the CUDA kernel does not take (one block of 2^(c-1) ≤ 512 threads)
    are refused on every device."""
    with pytest.raises(ValueError):
        mk.chunk_roots_natural(_t(_leaves(0, n)), chunk_log2)


@pytest.mark.parametrize("n_log2,depth", [(3, 3), (5, 9), (7, 40)])
def test_merkle_root_chunked_matches_reference(n_log2, depth):
    leaves = _leaves(100 + depth, 1 << n_log2)
    ref = jmk.merkle_root_chunked(leaves, depth, chunk_log2=3,
                                  use_kernel=False)
    got = mk.merkle_root_chunked(leaves, depth, chunk_log2=3)
    assert np.array_equal(got, ref)
    assert words_to_bytes(got) == _host_root(leaves, depth)


@pytest.mark.parametrize("n", [1, 2, 64])
def test_tree_levels_match_reference_levels_body(n):
    leaves = _leaves(n, n)
    ref = jmk._levels_body(jnp.asarray(leaves), use_kernel=False)
    got = mk.tree_levels(_t(leaves))
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        assert np.array_equal(g.numpy().view(np.uint32), np.asarray(r))


@pytest.mark.parametrize("n,depth,base", [(8, 5, 0), (16, 12, 3)])
def test_merkleize_matches_reference(n, depth, base):
    leaves = _leaves(7 * n, n)
    ref = jm.merkleize_auto(leaves, depth, base_level=base)
    assert np.array_equal(tm.merkleize_auto(leaves, depth, base), ref)
    assert np.array_equal(tm.merkleize(leaves, depth, base), ref)


def _pair(seed, w):
    """A JAX DeviceTree and a port DeviceTree over the same leaves."""
    leaves = _leaves(seed, w)
    return (jdt.DeviceTree.from_host_leaves(leaves),
            dt.DeviceTree.from_host_leaves(leaves), leaves)


def test_device_tree_scatter_roots_match_reference():
    jtree, ttree, leaves = _pair(11, 64)
    assert np.array_equal(ttree.root_words(), jtree.root_words())
    rng = np.random.default_rng(12)
    for k in (1, 3, 9, 20):
        idx = np.sort(rng.choice(64, k, replace=False))
        rows = _leaves(int(rng.integers(1 << 30)), k)
        leaves[idx] = rows
        got = ttree.scatter(idx, rows)
        assert np.array_equal(got, jtree.scatter(idx, rows))
        assert np.array_equal(got, tm.merkleize_auto(leaves, 6))
    for g, r in zip(ttree.pull_levels(), jtree.pull_levels()):
        assert np.array_equal(g, r)


def test_device_tree_share_then_scatter_leaves_sibling_unchanged():
    """Copy-on-write: the port updates levels in place, so a write to
    either side of a share() must clone first — in both directions."""
    jtree, ttree, leaves = _pair(21, 32)
    r0 = ttree.root_words()
    child = ttree.share()
    got = child.scatter(np.array([3]), _leaves(22, 1))
    assert not np.array_equal(got, r0)
    assert np.array_equal(ttree.root_words(), r0)
    assert np.array_equal(ttree.pull_levels()[0], leaves)

    sib = child.share()
    r_child = child.root_words()
    ttree.scatter(np.array([5, 6]), _leaves(23, 2))
    sib.scatter(np.array([0]), _leaves(24, 1))
    assert np.array_equal(child.root_words(), r_child)
    # The reference agrees with every lineage.
    jchild = jtree.share()
    assert np.array_equal(jchild.scatter(np.array([3]), _leaves(22, 1)),
                          r_child)
    assert np.array_equal(jtree.scatter(np.array([5, 6]), _leaves(23, 2)),
                          ttree.root_words())


def test_device_tree_rebuild_and_transfer_bytes():
    _jtree, ttree, leaves = _pair(31, 128)
    device.reset_transfer_counters()
    ttree.scatter(np.array([7]), _leaves(32, 1))
    # One bucket of 8 (index, row) pairs up, one root down.
    assert device.transfer_totals() == {"h2d": 8 * 8 + 8 * 32, "d2h": 32}
    fresh = _leaves(33, 128)
    assert np.array_equal(ttree.rebuild_device(_t(fresh)),
                          tm.merkleize_auto(fresh, 7))


@pytest.mark.parametrize("k", [3, 8, 9])
def test_pad_bucket_matches_reference(k):
    idx = np.arange(k) * 3
    rows = _leaves(41, k)
    got_idx, got_rows = dt.pad_bucket(idx, rows)
    ref_idx, ref_rows = jdt.pad_bucket(idx, rows)
    assert np.array_equal(got_idx, ref_idx)
    assert np.array_equal(got_rows, ref_rows)


def test_zero_hashes_match_reference():
    assert tm.ZERO_HASHES_BYTES == jm.ZERO_HASHES_BYTES
    assert np.array_equal(tm.ZERO_HASHES, jm.ZERO_HASHES)


@pytest.mark.parametrize("mixin", [False, True])
def test_incremental_cache_matches_reference(mixin):
    """Same roots as the reference cache, and the same HASH_COUNT of
    compressions for each step (dirty-path walks vs rebuilds)."""
    rng = np.random.default_rng(51)
    ref = jtc.IncrementalMerkleCache(1 << 20, mixin_length=mixin)
    got = ttc.IncrementalMerkleCache(1 << 20, mixin_length=mixin)

    def step(call):
        j0, t0 = jtc.HASH_COUNT[0], ttc.HASH_COUNT[0]
        r_got, r_ref = call(got), call(ref)
        assert r_got == r_ref
        assert ttc.HASH_COUNT[0] - t0 == jtc.HASH_COUNT[0] - j0

    leaves = _leaves(52, 40)
    step(lambda c: c.root_words(leaves))
    for k in (1, 4, 30):
        idx = np.sort(rng.choice(40, k, replace=False))
        leaves[idx] = _leaves(int(rng.integers(1 << 30)), k)
        step(lambda c: c.root_words(leaves))
    rows = _leaves(53, 2)
    idx = np.array([2, 33])
    step(lambda c: c.update_rows(idx, rows, 40))
    step(lambda c: c.copy().root_words(leaves))
