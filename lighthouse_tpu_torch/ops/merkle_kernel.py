"""The SHA-256 Merkle kernels: CUDA wrappers and their plain versions.

Port of ``lighthouse_tpu/ops/merkle_kernel.py``.  The two Pallas kernels
of the JAX package become two CUDA kernels written for Hopper
(``csrc/sha256_merkle.cu``, built at first use by :mod:`.cuda_build`):

- :func:`hash64_kernel` — batched ``hash32_concat`` of digest pairs, one
  thread per digest, left and right given as pointer + row stride
  (replaces ``_hash64_pallas_kernel`` / ``hash64_pallas``);
- :func:`chunk_roots_natural` — the root of every ``2^chunk_log2``-leaf
  chunk, one thread block per chunk reducing in shared memory (replaces
  ``_subtree_kernel`` / ``chunk_roots``).

Beside each wrapper sits its plain PyTorch version (:func:`hash64_plain`,
:func:`chunk_roots_plain`).  A wrapper runs the plain version only for a
tensor on the CPU; for a CUDA tensor it launches its kernel or raises.
:data:`LAUNCHES` counts kernel launches per wrapper.

Digests are ``(n, 8)`` int32 tensors holding big-endian u32 words.  The
TPU layout tricks do not carry over: there are no word planes, no
bit-reversed leaf order and no 2^15-lane padding; any n is accepted.
"""

from __future__ import annotations

import ctypes
import time

import numpy as np
import torch

from ..device import to_device, to_host
from .sha256 import hash64 as _hash64_torch

# Leaves per chunk of the sub-tree kernel: 2^10 leaves = 512 threads and
# 16 KiB of shared memory per block (the TPU kernel's 2^15 was set by its
# VMEM budget).  The kernel takes 1 ≤ chunk_log2 ≤ MAX_CHUNK_LOG2; its
# __launch_bounds__(512) leaves each thread up to 128 registers.
CHUNK_LOG2 = 10
MAX_CHUNK_LOG2 = 10

LAUNCHES = {"hash64": 0, "subtree": 0}

_LIB = "sha256_merkle"
_P, _LL, _I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
_SIGNATURES = {
    # left, left row stride, right, right row stride, out, n, stream
    "lh_hash64": [_P, _LL, _P, _LL, _P, _LL, _P],
    # leaves, roots, number of chunks, chunk_log2, stream
    "lh_subtree": [_P, _P, _LL, _I, _P],
}


def kernel_library() -> ctypes.CDLL:
    """The built and loaded kernel library (compiles at first call)."""
    from .cuda_build import load
    return load(_LIB, _SIGNATURES)


def _check(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what} launch failed: CUDA error {rc}")


def _check_digests(x: torch.Tensor, name: str) -> None:
    if not isinstance(x, torch.Tensor):
        raise TypeError(f"{name} must be a torch.Tensor")
    if x.dtype != torch.int32:
        raise TypeError(f"{name} must be int32 (u32 bit patterns), "
                        f"got {x.dtype}")
    if x.ndim != 2 or x.shape[1] != 8:
        raise ValueError(f"{name} must be (n, 8), got {tuple(x.shape)}")
    if x.shape[0] and x.stride(1) != 1:
        raise ValueError(f"{name} rows must be contiguous words")


# ---------------------------------------------------------------------------
# hash64
# ---------------------------------------------------------------------------

def hash64_plain(left: torch.Tensor, right: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of :func:`hash64_kernel`."""
    return _hash64_torch(left, right)


def hash64_kernel(left: torch.Tensor, right: torch.Tensor) -> torch.Tensor:
    """``hash32_concat`` of ``left[i] || right[i]``: ``(n, 8)`` int32 pairs
    → ``(n, 8)`` int32 digests.  Rows may be strided (``cur[0::2]``,
    ``cur[1::2]`` of one level, or the first 8 words of wider rows)."""
    _check_digests(left, "left")
    _check_digests(right, "right")
    if left.shape != right.shape or left.device != right.device:
        raise ValueError("left and right must share shape and device")
    if left.device.type == "cpu":
        return hash64_plain(left, right)
    if left.device.type != "cuda":
        raise ValueError(f"unsupported device {left.device}")
    n = left.shape[0]
    out = torch.empty((n, 8), dtype=torch.int32, device=left.device)
    if n == 0:
        return out
    lib = kernel_library()
    stream = torch.cuda.current_stream(left.device).cuda_stream
    _check(lib.lh_hash64(left.data_ptr(), left.stride(0), right.data_ptr(),
                         right.stride(0), out.data_ptr(), n, stream),
           "hash64")
    LAUNCHES["hash64"] += 1
    return out


# ---------------------------------------------------------------------------
# chunk sub-tree roots
# ---------------------------------------------------------------------------

def chunk_roots_plain(leaves: torch.Tensor, chunk_log2: int) -> torch.Tensor:
    """Plain PyTorch version of :func:`chunk_roots_natural`: a contiguous
    chunk is exactly a sub-tree, so ``chunk_log2`` whole-array levels
    leave one root per chunk."""
    cur = leaves
    for _ in range(chunk_log2):
        cur = _hash64_torch(cur[0::2], cur[1::2])
    return cur


def chunk_roots_natural(leaves: torch.Tensor,
                        chunk_log2: int = CHUNK_LOG2) -> torch.Tensor:
    """Sub-tree roots of every ``2^chunk_log2``-leaf chunk: natural-order
    ``(n, 8)`` int32 leaves → ``(n / 2^chunk_log2, 8)`` int32 roots."""
    _check_digests(leaves, "leaves")
    n = leaves.shape[0]
    c = 1 << chunk_log2
    if not 1 <= chunk_log2 <= MAX_CHUNK_LOG2:
        raise ValueError(f"chunk_log2 {chunk_log2} outside "
                         f"[1, {MAX_CHUNK_LOG2}]")
    if n % c or n < c:
        raise ValueError(f"{n} leaves not a multiple of chunk {c}")
    if leaves.device.type == "cpu":
        return chunk_roots_plain(leaves, chunk_log2)
    if leaves.device.type != "cuda":
        raise ValueError(f"unsupported device {leaves.device}")
    leaves = leaves.contiguous()
    g = n // c
    out = torch.empty((g, 8), dtype=torch.int32, device=leaves.device)
    lib = kernel_library()
    stream = torch.cuda.current_stream(leaves.device).cuda_stream
    _check(lib.lh_subtree(leaves.data_ptr(), out.data_ptr(), g, chunk_log2,
                          stream), "subtree")
    LAUNCHES["subtree"] += 1
    return out


# ---------------------------------------------------------------------------
# Whole trees
# ---------------------------------------------------------------------------

def tree_levels(leaves: torch.Tensor) -> tuple:
    """All tree levels over ``(w, 8)`` int32 leaves (w a power of two), one
    ``hash64`` launch per level: ``levels[0]`` is ``leaves``,
    ``levels[-1]`` the ``(1, 8)`` sub-tree root (``_levels_body``)."""
    levels = [leaves]
    cur = leaves
    while cur.shape[0] > 1:
        cur = hash64_kernel(cur[0::2], cur[1::2])
        levels.append(cur)
    return tuple(levels)


# Host→device streaming granularity of big leaf pushes: 2^18 rows = 8 MiB
# a chunk at (rows, 8) u32 (``LIGHTHOUSE_TPU_PUSH_CHUNK_ROWS``; 0 disables
# chunking).
PUSH_CHUNK_ROWS = 1 << 18

# Accumulated stats of chunked builds since the last
# :func:`reset_push_stats`: builds, chunks, staging fallbacks, the copy
# time left on the critical path (wait_ms), the background copy time
# (transfer_ms), the copy time hidden behind device work (overlap_ms) and
# the wall time of the builds.
LAST_PUSH_STATS: dict = {}


def reset_push_stats() -> None:
    LAST_PUSH_STATS.clear()


def _push_chunk_rows() -> int:
    """The knob, rounded DOWN to a power of two so it divides the
    (power-of-two) leaf widths; ≤ 0 disables chunking."""
    from ..common.knobs import knob_int
    rows = knob_int("LIGHTHOUSE_TPU_PUSH_CHUNK_ROWS",
                    default=PUSH_CHUNK_ROWS)
    return 1 << (rows.bit_length() - 1) if rows > 0 else 0


def merkle_levels_device(leaves: np.ndarray, chunk_rows: int | None = None):
    """Every tree level of host ``(w, 8)`` u32 leaves, computed on the
    device: returns ``(root_words, device_levels)`` with the ``(8,)`` root
    pulled to the host and the levels left on the device.

    Wide builds stream the leaves in ``chunk_rows``-row chunks through a
    :class:`~..parallel.pipeline.ChunkStager`: chunk i+1 copies while
    chunk i's sub-tree levels are hashed on the device.  A contiguous
    chunk is exactly a sub-tree, so level l of the full tree is the
    in-order concatenation of the chunks' level l — the same levels the
    one-copy build gives — and the chunk roots reduce to the top as a
    small tree of their own."""
    leaves = np.ascontiguousarray(leaves).astype(np.uint32, copy=False)
    w = leaves.shape[0]
    chunk = _push_chunk_rows() if chunk_rows is None else chunk_rows
    if chunk <= 0 or w <= chunk or w % chunk:
        levels = tree_levels(to_device(leaves, "staging"))
        return to_host(levels[-1][0], "staging"), levels

    from ..parallel.pipeline import ChunkStager

    t0 = time.perf_counter()
    n_chunks = w // chunk
    stager = ChunkStager([leaves[i * chunk:(i + 1) * chunk]
                          for i in range(n_chunks)])
    parts = [tree_levels(dev) for dev in stager]
    levels = [torch.cat([p[lv] for p in parts], 0)
              for lv in range(len(parts[0]))]
    levels.extend(tree_levels(levels[-1])[1:])
    root = to_host(levels[-1][0], "staging")
    for key, add in (
            ("builds", 1), ("chunks", n_chunks),
            ("staging_fallbacks", stager.fallbacks),
            ("wait_ms", stager.wait_s * 1e3),
            ("transfer_ms", stager.transfer_s * 1e3),
            ("overlap_ms", max(stager.transfer_s - stager.wait_s, 0.0) * 1e3),
            ("wall_ms", (time.perf_counter() - t0) * 1e3)):
        LAST_PUSH_STATS[key] = LAST_PUSH_STATS.get(key, 0) + add
    return root, tuple(levels)


def merkle_root_chunked(leaves, depth: int,
                        chunk_log2: int = CHUNK_LOG2) -> np.ndarray:
    """Root of a depth-``depth`` padded tree over ``(n, 8)`` u32 leaves in
    natural order, ``n`` a power of two ≥ the chunk size.  Returns ``(8,)``
    u32 root words on the host.

    The ``n → n/2^chunk_log2`` reduction (all but a few hundred of the
    hashes) is one sub-tree kernel launch; the chunk roots come back to
    the host and the remaining levels run through
    :func:`..ops.merkle.merkleize_auto` (host hashlib for the usual few
    hundred roots — a chain of one-element launches would be
    launch-bound).
    """
    from .merkle import merkleize_auto

    n = leaves.shape[0]
    if n & (n - 1):
        raise ValueError("pad leaf count to a power of two first")
    c = 1 << chunk_log2
    if n < c:
        raise ValueError(f"use merkleize() below {c} leaves")
    if (n - 1).bit_length() > depth:
        raise ValueError(f"{n} leaves overflow a depth-{depth} tree")
    dev = (leaves if isinstance(leaves, torch.Tensor)
           else to_device(np.asarray(leaves, dtype=np.uint32), "staging"))
    roots = to_host(chunk_roots_natural(dev, chunk_log2), "staging")
    return merkleize_auto(roots, depth, base_level=chunk_log2)

