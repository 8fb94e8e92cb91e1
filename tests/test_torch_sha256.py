"""The port's plain ``hash64`` and the ``hash64`` kernel wrapper on the CPU,
held bit for bit against the JAX package (``ops.sha256.hash64`` and the
Pallas kernel's eager ``hash64_planes``) and against hashlib.

Inputs include words with the sign bit set and all-ones words: they catch
an arithmetic (sign-extending) right shift or a lost carry in the int32 /
int64 emulation of u32 arithmetic.
"""

import hashlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from lighthouse_tpu.ops import merkle_kernel as jmk
from lighthouse_tpu.ops import sha256 as jsha
from lighthouse_tpu_torch import device
from lighthouse_tpu_torch.ops import merkle_kernel as mk
from lighthouse_tpu_torch.ops import sha256 as tsha


@pytest.fixture(autouse=True, scope="module")
def _cpu():
    prev, threads = device.default_device(), torch.get_num_threads()
    device.set_default_device("cpu")
    torch.set_num_threads(1)
    yield
    device.set_default_device(prev)
    torch.set_num_threads(threads)


def _words(rng, n):
    w = rng.integers(0, 2 ** 32, size=(n, 8), dtype=np.uint64).astype(
        np.uint32)
    w[0] = 0xFFFFFFFF                  # all ones
    w[1] = 0x80000000                  # sign bit only
    w[2] = np.arange(8, dtype=np.uint32) << np.uint32(28)  # high nibbles
    w[3] = 0
    return w


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a).view(np.int32))


def _hashlib(left, right):
    return np.stack([np.frombuffer(hashlib.sha256(
        left[i].astype(">u4").tobytes() + right[i].astype(">u4").tobytes()
    ).digest(), dtype=">u4").astype(np.uint32) for i in range(len(left))])


def test_constants_match_reference():
    assert np.array_equal(tsha._K, jsha._K)
    assert np.array_equal(tsha._IV, jsha._IV)
    assert np.array_equal(tsha._PAD64_KW, jsha._PAD64_KW)


@pytest.mark.parametrize("n", [4, 37])
def test_plain_hash64_matches_jax_and_hashlib(n):
    rng = np.random.default_rng(n)
    left, right = _words(rng, n), _words(rng, n)[::-1].copy()
    got = tsha.hash64(_t(left), _t(right)).numpy().view(np.uint32)
    ref = np.asarray(jsha.hash64(jnp.asarray(left), jnp.asarray(right)))
    assert np.array_equal(got, ref)
    assert np.array_equal(got, _hashlib(left, right))


def test_plain_hash64_matches_pallas_planes_body():
    rng = np.random.default_rng(3)
    left, right = _words(rng, 6), _words(rng, 6)
    planes = jmk.hash64_planes([jnp.asarray(left[:, w]) for w in range(8)],
                               [jnp.asarray(right[:, w]) for w in range(8)])
    ref = np.stack([np.asarray(p) for p in planes], axis=1)
    got = mk.hash64_plain(_t(left), _t(right)).numpy().view(np.uint32)
    assert np.array_equal(got, ref)


def test_plain_hash64_keeps_leading_shape():
    rng = np.random.default_rng(5)
    left = _words(rng, 12).reshape(3, 4, 8)
    right = _words(rng, 12).reshape(3, 4, 8)
    got = tsha.hash64(_t(left), _t(right)).numpy().view(np.uint32)
    assert got.shape == (3, 4, 8)
    assert np.array_equal(got.reshape(12, 8),
                          _hashlib(left.reshape(12, 8), right.reshape(12, 8)))


def test_kernel_wrapper_takes_strided_rows_on_cpu():
    """A tree level (``cur[0::2]``, ``cur[1::2]``) and the pubkey
    pre-hash shape (the first 8 words of 12-word rows) go through the
    wrapper as strided views; on a CPU tensor it runs the plain version
    and launches nothing."""
    rng = np.random.default_rng(9)
    cur = _words(rng, 16)
    before = dict(mk.LAUNCHES)
    got = mk.hash64_kernel(_t(cur)[0::2], _t(cur)[1::2])
    assert np.array_equal(got.numpy().view(np.uint32),
                          _hashlib(cur[0::2], cur[1::2]))
    pk = rng.integers(0, 2 ** 32, size=(5, 12), dtype=np.uint64).astype(
        np.uint32)
    hi = np.zeros((5, 8), np.uint32)
    hi[:, :4] = pk[:, 8:]
    got = mk.hash64_kernel(_t(pk)[:, :8], _t(hi))
    assert np.array_equal(got.numpy().view(np.uint32),
                          _hashlib(pk[:, :8], hi))
    assert mk.LAUNCHES == before


@pytest.mark.parametrize("bad", ["dtype", "shape", "mismatch", "cols"])
def test_kernel_wrapper_rejects_bad_inputs(bad):
    x = torch.zeros((4, 8), dtype=torch.int32)
    y = torch.zeros((4, 8), dtype=torch.int32)
    if bad == "dtype":
        x = x.to(torch.int64)
    elif bad == "shape":
        x = torch.zeros((4, 7), dtype=torch.int32)
    elif bad == "mismatch":
        y = torch.zeros((3, 8), dtype=torch.int32)
    else:
        x = torch.zeros((8, 4), dtype=torch.int32).t()
    with pytest.raises((TypeError, ValueError)):
        mk.hash64_kernel(x, y)
