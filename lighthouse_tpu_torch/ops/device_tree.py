"""Device-resident incremental Merkle trees — zero-push warm roots.

Port of ``lighthouse_tpu/ops/device_tree.py``.  Every level of the tree
lives on the device as the source of truth, and a warm root is

    H2D:  k dirty leaf rows (+ their int32 indices)       — bytes ∝ dirty
    scatter → per-level re-hash of the touched paths      — k·log n hashes
    D2H:  32 bytes of root

with each level's path re-hash one ``hash64`` kernel launch.

**Copy-on-write.**  JAX arrays are immutable, so the JAX package's
``share()`` costs nothing and the next update simply lands in fresh
buffers.  Torch tensors are updated in place here, so a tree updates its
levels in place only while it owns them: :meth:`DeviceTree.share` marks
both trees shared, and the first write to a shared tree clones its levels
first (:meth:`DeviceTree._own`).  The sibling keeps the old buffers
untouched.

Dirty-index batches are padded to power-of-two buckets (:func:`pad_bucket`)
so the launch shapes of the warm path stay logarithmic in the update size;
padding duplicates a real (index, row) pair, which is idempotent under
both the scatter and the re-hash.

**Accounting.**  Every copy reports to the device ledger
(:data:`..common.device_ledger.LEDGER`) under the caller's ambient
attribution (``device_tree`` when no seam set one), each tree keeps a
:class:`~..common.device_ledger.ResidencyToken` of its levels' bytes, and
materializations, scatters and rebuilds are ledger events.
:func:`residency_snapshot` is the JAX package's legacy residency
surface, as a view of the ledger over its historical feeders.
"""

from __future__ import annotations

import numpy as np
import torch

from ..common.device_ledger import LEDGER
from ..device import to_device, to_host
from .merkle import _next_pow2
from .merkle_kernel import hash64_kernel, tree_levels

# The legacy residency view's feeder set (the JAX package's), and its keys
# → ledger counters.
LEGACY_RESIDENCY_SUBSYSTEMS = ("device_tree", "registry_mirror",
                               "packed_cache", "fork_choice")
_LEGACY_KEYS = {
    "bytes_pushed": "h2d_bytes",
    "bytes_pulled": "d2h_bytes",
    "scatters": "scatters",
    "rebuilds": "rebuilds",
    "materializes": "materializes",
}


# The ledger's mark over the feeders at the last reset_residency_stats()
# (the view re-bases; the ledger itself only grows).
_RESIDENCY_MARK = [None]


def reset_residency_stats() -> None:
    _RESIDENCY_MARK[0] = LEDGER.mark(LEGACY_RESIDENCY_SUBSYSTEMS)


def residency_snapshot() -> dict:
    """The legacy residency counters (bytes pushed and pulled, scatters,
    rebuilds, materializes) of the feeder subsystems since the last
    :func:`reset_residency_stats`, or since the last ``LEDGER.reset()``
    where that came later."""
    t = LEDGER.since(_RESIDENCY_MARK[0], LEGACY_RESIDENCY_SUBSYSTEMS)
    return {k: int(t[lk]) for k, lk in _LEGACY_KEYS.items()}


# Smallest dirty-batch bucket (the JAX package's ``tree_dirty`` floor).
BUCKET_FLOOR = 8


def _bucket(k: int) -> int:
    """Dirty-batch size bucket: power of two ≥ :data:`BUCKET_FLOOR`."""
    return max(BUCKET_FLOOR, 1 << max(int(k) - 1, 0).bit_length())


def pad_bucket(idx: np.ndarray, rows: np.ndarray) -> tuple:
    """Pad ``(k,)`` indices / ``(k, …)`` rows to the bucket size by
    repeating the first entry — idempotent under scatter + re-hash."""
    k = idx.shape[0]
    b = _bucket(k)
    if k == b:
        return idx.astype(np.int32, copy=False), rows
    pidx = np.empty(b, dtype=np.int32)
    pidx[:k] = idx
    pidx[k:] = idx[0]
    prows = np.empty((b,) + rows.shape[1:], dtype=rows.dtype)
    prows[:k] = rows
    prows[k:] = rows[0]
    return pidx, prows


def scatter_propagate_body(levels, idx: torch.Tensor,
                           rows: torch.Tensor) -> None:
    """The warm-root body, IN PLACE on ``levels`` (the caller owns them):
    scatter ``rows`` into ``levels[0]`` at ``idx`` and re-hash exactly the
    touched ancestor path of every index up every level.  Duplicate
    indices (bucket padding) recompute the same parent with the same
    inputs — wasted lanes, never wrong bits.

    Shared by the packed-column trees and the registry mirror (which feeds
    record-mini-tree roots as ``rows``)."""
    levels[0][idx] = rows
    cur = idx
    for lvl in range(1, len(levels)):
        cur = cur >> 1
        below = levels[lvl - 1]
        levels[lvl][cur] = hash64_kernel(below[2 * cur], below[2 * cur + 1])


class DeviceTree:
    """One padded Merkle tree whose every level lives on the device.

    ``levels[0]`` is the ``(w, 8)`` int32 leaf plane (w a power of two),
    ``levels[-1]`` the ``(1, 8)`` subtree root.  Zero-cap folding up to the
    SSZ limit and the length mixin stay host-side (≤ ~40 single hashes),
    exactly like the host cache.
    """

    __slots__ = ("levels", "shared", "_res", "__weakref__")

    def __init__(self, levels, shared: bool = False):
        self.levels = tuple(levels)
        self.shared = shared
        # Residency token, created at the first accounting seam: a
        # share() clone holds none (the parent owns the shared buffers)
        # until its first write lands in buffers of its own.
        self._res = None

    def note_residency(self) -> None:
        """Update this tree's resident byte contribution under the ambient
        ledger attribution (creates the token and its GC drop seam on the
        first call)."""
        total = sum(lv.numel() * lv.element_size() for lv in self.levels)
        if self._res is None:
            self._res = LEDGER.track(
                self, LEDGER.ambient() or "device_tree", total)
        else:
            self._res.set(total)

    # -- construction --------------------------------------------------------

    @classmethod
    def from_host_leaves(cls, leaves: np.ndarray) -> "DeviceTree":
        """One-time materialization: copy the full (w, 8) leaf plane to the
        device and reduce every level there.  The ONLY full-width push
        this tree ever makes."""
        leaves = np.ascontiguousarray(leaves, dtype=np.uint32)
        assert leaves.shape[0] == _next_pow2(leaves.shape[0])
        LEDGER.note_event("materializes")
        tree = cls(tree_levels(to_device(leaves)))
        tree.note_residency()
        return tree


    # -- queries -------------------------------------------------------------

    @property
    def width(self) -> int:
        return self.levels[0].shape[0]

    def root_words(self) -> np.ndarray:
        return to_host(self.levels[-1][0])

    def pull_levels(self) -> list:
        """Host copies of every level (de-materialization / oracle)."""
        return [to_host(lv) for lv in self.levels]

    # -- updates -------------------------------------------------------------

    def _own(self) -> None:
        """Copy-on-write: clone the levels before the first in-place write
        of a tree whose buffers a sibling may still hold."""
        if self.shared:
            self.levels = tuple(lv.clone() for lv in self.levels)
            self.shared = False

    def scatter(self, idx: np.ndarray, rows: np.ndarray) -> np.ndarray:
        """Warm update: ``rows`` (k, 8) u32 replace leaves at ``idx``
        (ascending, unique); returns the new subtree root words.  H2D is
        the bucket-padded (idx, rows) pair only."""
        if idx.size == 0:
            return self.root_words()
        pidx, prows = pad_bucket(np.asarray(idx),
                                 np.ascontiguousarray(rows, dtype=np.uint32))
        root = self.scatter_device(to_device(pidx.astype(np.int64)),
                                   to_device(prows))
        self.note_residency()
        return root

    def scatter_device(self, idx_dev: torch.Tensor,
                       rows_dev: torch.Tensor) -> np.ndarray:
        """Scatter with (idx, rows) already on the device (registry mirror
        path) — zero push here; the caller accounts its own copies and
        residency."""
        LEDGER.note_event("scatters")
        self._own()
        scatter_propagate_body(self.levels, idx_dev, rows_dev)
        return self.root_words()

    def rebuild_device(self, leaves: torch.Tensor) -> np.ndarray:
        """Replace every level from device-resident leaves (dirty fraction
        past the walk/rebuild crossover, or width growth) — zero push."""
        LEDGER.note_event("rebuilds")
        self.levels = tree_levels(leaves)
        self.shared = False
        self.note_residency()
        return self.root_words()

    # -- copy-on-write -------------------------------------------------------

    def share(self) -> "DeviceTree":
        """COW clone: both trees reference the same device buffers until
        either writes; that one clones first (:meth:`_own`)."""
        self.shared = True
        return DeviceTree(self.levels, shared=True)
