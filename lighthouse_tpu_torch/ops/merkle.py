"""SSZ Merkleization: level-by-level batched ``hash64`` reductions.

Port of ``lighthouse_tpu/ops/merkle.py``.  A device reduction hashes one
whole tree level per ``hash64`` launch (the CUDA kernel of
:mod:`.merkle_kernel` on a GPU, its plain torch version on the CPU);
small trees stay on host hashlib, where a launch per level would cost
more than the hashing.  Zero-subtree padding uses the precomputed
zero-hash table (``ZERO_HASHES``, to depth 64).

Leaves are ``(n, 8)`` u32 words (32-byte chunks as big-endian words):
numpy ``uint32`` on the host, int32 bit patterns on the device.
"""

from __future__ import annotations

import hashlib

import numpy as np
import torch

from ..device import to_device, to_host
from .sha256 import bytes_to_words

MAX_TREE_DEPTH = 64

# ZERO_HASHES[i] = root of a depth-i tree of zero leaves.
_zh = [b"\x00" * 32]
for _ in range(MAX_TREE_DEPTH):
    _zh.append(hashlib.sha256(_zh[-1] + _zh[-1]).digest())
ZERO_HASHES = np.stack([bytes_to_words(h) for h in _zh])  # (65, 8) uint32
ZERO_HASHES_BYTES = list(_zh)



def _next_pow2(n: int) -> int:
    return 1 if n <= 1 else 1 << (n - 1).bit_length()


# Below this many nodes a batch is dispatched on the host: per-launch
# overhead dwarfs the hash work, mirroring how the reference only
# parallelises the big trees (``tree_hash_cache.rs:25-33``).
HOST_DISPATCH_THRESHOLD = 4096


def hash64_host_words(left: np.ndarray, right: np.ndarray) -> np.ndarray:
    """Host hashlib ``hash64`` over ``(n, 8)`` u32 words.

    One interleaved buffer + one conversion pass: this sits on the per-slot
    incremental-root path (~150 calls/root), where the per-call numpy
    marshalling used to cost more than the hashing itself.
    """
    shape = left.shape
    l2 = left.reshape(-1, 8)
    r2 = right.reshape(-1, 8)
    n = l2.shape[0]
    buf = np.empty((n, 16), dtype=np.uint32)
    buf[:, :8] = l2
    buf[:, 8:] = r2
    msgs = buf.astype(">u4", copy=False).tobytes()
    out = bytearray(32 * n)
    sha256 = hashlib.sha256
    for i in range(n):
        out[32 * i:32 * i + 32] = sha256(msgs[64 * i:64 * i + 64]).digest()
    return (np.frombuffer(bytes(out), dtype=">u4").astype(np.uint32)
            .reshape(shape))


def merkleize(leaves, depth: int, base_level: int = 0) -> np.ndarray:
    """Root of a depth-``depth`` tree over ``leaves`` ``(n, 8)``, n = 2^k ≤
    2^depth, reduced on the device one level per ``hash64`` launch.

    The first ``log2(n)`` levels reduce the real leaves; the remaining
    levels combine with the zero-hash of that level on the host (the
    standard ``merkleize_padded`` trick — no materialised padding).

    ``base_level``: tree level the input nodes already sit at (0 = 32-byte
    chunks), so that zero-subtree padding uses the right ``ZERO_HASHES``
    entries; ``depth`` is the total tree depth counted from level 0.
    Returns the ``(8,)`` u32 root words on the host.
    """
    from .merkle_kernel import hash64_kernel

    n = leaves.shape[0]
    assert n == _next_pow2(n), "pad leaf count to a power of two first"
    assert base_level + (n - 1).bit_length() <= depth, \
        f"{n} nodes at level {base_level} overflow a depth-{depth} tree"
    level = (leaves if isinstance(leaves, torch.Tensor)
             else to_device(np.asarray(leaves, dtype=np.uint32), "staging"))
    lvl = base_level
    while level.shape[0] > 1:
        level = hash64_kernel(level[0::2], level[1::2])
        lvl += 1
    root = to_host(level[0], "staging")
    while lvl < depth:
        root = hash64_host_words(root[None], ZERO_HASHES[lvl][None])[0]
        lvl += 1
    return root


def merkleize_auto(leaves: np.ndarray, depth: int,
                   base_level: int = 0) -> np.ndarray:
    """:func:`merkleize` with host dispatch for small batches.

    Same contract (power-of-two ``(n, 8)`` u32 leaves, total tree ``depth``);
    returns an ``(8,)`` u32 root on the host.
    """
    n = leaves.shape[0]
    assert n == _next_pow2(n), "pad leaf count to a power of two first"
    if n > HOST_DISPATCH_THRESHOLD:
        return merkleize(leaves, depth, base_level)
    level = np.asarray(leaves, dtype=np.uint32)
    lvl = base_level
    while level.shape[0] > 1:
        level = hash64_host_words(level[0::2], level[1::2])
        lvl += 1
    root = level[0]
    while lvl < depth:
        root = hash64_host_words(root[None], ZERO_HASHES[lvl][None])[0]
        lvl += 1
    return root


# ---------------------------------------------------------------------------
# Host-side reference (ground truth + cold paths)
# ---------------------------------------------------------------------------

def merkleize_host(chunks: list[bytes], limit: int | None = None) -> bytes:
    """Host merkleize per the SSZ spec (power-of-two zero padding up to limit)."""
    count = len(chunks)
    if limit is not None and count > limit:
        raise ValueError(f"{count} chunks exceeds limit {limit}")
    width = _next_pow2(count if limit is None else limit)
    depth = width.bit_length() - 1
    if count == 0:
        return ZERO_HASHES_BYTES[depth]
    level = list(chunks)
    for d in range(depth):
        if len(level) % 2 == 1:
            level.append(ZERO_HASHES_BYTES[d])
        level = [hashlib.sha256(level[i] + level[i + 1]).digest()
                 for i in range(0, len(level), 2)]
    return level[0]


def mix_in_length_host(root: bytes, length: int) -> bytes:
    return hashlib.sha256(root + length.to_bytes(32, "little")).digest()
