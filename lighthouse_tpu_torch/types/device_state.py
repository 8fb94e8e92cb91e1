"""Device-resident BeaconState columns — device memory as the source of truth.

Port of ``lighthouse_tpu/types/device_state.py``.  Once a state is
*materialized* (:func:`materialize_state` — explicit, or automatic at
registry scale on a GPU), the hot columns stop being re-staged for every
root:

- the big packed columns (``balances``, the two participation flag
  columns, ``inactivity_scores``, ``slashings``) are wrapped in
  :class:`DeviceColumn` — an ndarray-shaped handle whose Merkle leaves and
  interior tree levels live on the device
  (:class:`~lighthouse_tpu_torch.ops.device_tree.DeviceTree`) and whose
  host numpy buffer is a lazily-pulled *view* of device results;
- every mutation is tracked: ``col[idx] = v`` and :func:`store_column`
  record exact dirty indices, wholesale host assignments fall back to a
  vectorized diff, and a device-computed result (a torch tensor) is
  *adopted* — the tensor becomes the column, nothing is pulled, and the
  next root repacks + re-reduces entirely on the device;
- a warm ``hash_tree_root`` therefore pushes only the dirty chunk rows and
  pulls 32 bytes.

``BeaconState.copy()`` clones are copy-on-write on the device side: the
clone shares every device buffer and the first write of either lineage
clones what it changes (:meth:`~lighthouse_tpu_torch.ops.device_tree.
DeviceTree.share`).  An adopted tensor is never written in place.

The host incremental path remains the differential oracle:
``LIGHTHOUSE_TPU_DEVICE_STATE=0`` disables materialization entirely.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from ..common.device_ledger import LEDGER
from ..device import on_cuda, to_device, to_host
from ..ops.device_tree import DeviceTree
from ..ops.merkle import _next_pow2
from ..ops.merkle_kernel import tree_levels
from ..ops.tree_cache import fold_zero_cap

# Columns that get a device mirror on materialization (plus the validator
# registry, handled by the registry's own mirror in types/validators.py).
DEVICE_COLUMN_FIELDS = (
    "balances",
    "previous_epoch_participation",
    "current_epoch_participation",
    "inactivity_scores",
    "slashings",
)

# The most recent materialize_state: its wall time and the bytes it
# pushed to the legacy residency feeders (a ledger view).
LAST_MATERIALIZE_STATS: dict = {}


def device_state_enabled() -> bool:
    """Master knob: device-resident state unless
    ``LIGHTHOUSE_TPU_DEVICE_STATE=0`` (the host incremental path is the
    differential oracle)."""
    from ..common.knobs import knob_bool
    return knob_bool("LIGHTHOUSE_TPU_DEVICE_STATE")


def is_materialized(state) -> bool:
    return bool(state.__dict__.get("_device_resident"))


def _is_device_tensor(x) -> bool:
    return isinstance(x, torch.Tensor)


def _host_dtype(t: torch.Tensor) -> np.dtype:
    """The SSZ column dtype an adopted tensor holds (int64 carries u64
    bit patterns)."""
    if t.dtype in (torch.int64, torch.uint64):
        return np.dtype(np.uint64)
    if t.dtype == torch.uint8:
        return np.dtype(np.uint8)
    raise TypeError(f"cannot adopt a {t.dtype} column (u64 or u8 only)")


def pack_chunk_rows(vals: np.ndarray) -> np.ndarray:
    """``(k, per)`` source values → ``(k, 8)`` big-endian u32 chunk words
    (SSZ little-endian packing inside each 32-byte chunk)."""
    le = np.ascontiguousarray(
        vals.astype(vals.dtype.newbyteorder("<"), copy=False))
    return np.frombuffer(le.tobytes(), dtype=">u4").astype(
        np.uint32).reshape(vals.shape[0], 8)


class DeviceColumn:
    """Ndarray-shaped handle for one packed state column.

    Reads see the host view (pulled lazily after a device-side update);
    writes are tracked so the per-root device work is bounded by the dirty
    fraction.  Unknown attributes delegate to the read-only host view, so
    ``col.sum()`` / ``col.astype(...)`` keep working — while an attempted
    *in-place* write through such a view raises instead of silently
    desynchronizing the device tree.
    """

    __ssz_mutable__ = True
    __slots__ = ("_host", "_dev", "_stale", "_idx", "_all", "_adopted")

    def __init__(self, arr: np.ndarray):
        arr = np.asarray(arr)
        if not arr.flags.writeable:
            arr = arr.copy()
        object.__setattr__(self, "_host", arr)
        object.__setattr__(self, "_dev", None)
        object.__setattr__(self, "_stale", False)
        object.__setattr__(self, "_idx", [])
        object.__setattr__(self, "_all", True)  # fresh wrap: diff on 1st root
        object.__setattr__(self, "_adopted", False)

    # -- host/device plumbing ------------------------------------------------

    def _pull(self, subsystem: str = "packed_cache") -> None:
        host = to_host(self._dev, subsystem).view(_host_dtype(self._dev))
        object.__setattr__(self, "_host", host)
        object.__setattr__(self, "_stale", False)

    def _master(self, subsystem: str = "packed_cache") -> np.ndarray:
        """Writable host master (pulls first if the device is ahead, the
        bytes noted to the ledger under ``subsystem``)."""
        if self._stale:
            self._pull(subsystem)
        return self._host

    def _leave_adopted(self) -> None:
        """A host write is landing: the host master becomes authoritative
        again (the cache recovers its diff baseline from the last adopted
        buffer it recorded)."""
        if self._adopted:
            self._master()  # ensure the host view is current first
            object.__setattr__(self, "_adopted", False)
            object.__setattr__(self, "_dev", None)
            # If no root ran since the adoption, the cache's host baseline
            # predates it — index tracking can't name the adoption-era
            # delta, only a full diff recovers it.
            object.__setattr__(self, "_all", True)

    def host(self, subsystem: str = "packed_cache") -> np.ndarray:
        """Read-only view of the current column values; a pull from the
        device is noted to the ledger under ``subsystem``."""
        v = self._master(subsystem).view()
        v.flags.writeable = False
        return v

    # -- ndarray protocol ----------------------------------------------------

    def __array__(self, dtype=None, copy=None):
        v = self.host()
        if dtype is not None and dtype != v.dtype:
            return v.astype(dtype)
        if copy:
            return v.copy()
        return v

    @property
    def shape(self):
        return tuple(self._dev.shape) if self._stale else self._host.shape

    @property
    def dtype(self):
        return _host_dtype(self._dev) if self._stale else self._host.dtype

    @property
    def ndim(self) -> int:
        return 1

    @property
    def size(self) -> int:
        return int(self.shape[0])

    def __len__(self) -> int:
        return int(self.shape[0])

    def __iter__(self):
        return iter(self.host())

    def __getitem__(self, key):
        # Fancy/bool indexing already copied; basic slices stay read-only
        # views so bypass writes raise loudly.
        return self.host()[key]

    def __setitem__(self, key, value) -> None:
        self._leave_adopted()
        h = self._master()
        h[key] = value
        if self._all:
            return
        if isinstance(key, (int, np.integer)):
            self._idx.append(np.asarray([int(key) % h.shape[0]],
                                        dtype=np.int64))
        elif isinstance(key, np.ndarray) and key.dtype == bool:
            self._idx.append(np.flatnonzero(key))
        elif isinstance(key, np.ndarray) and key.dtype.kind in "iu":
            idx = key.astype(np.int64).ravel() % max(h.shape[0], 1)
            self._idx.append(idx)
        else:  # slices / anything exotic: fall back to the full diff
            object.__setattr__(self, "_all", True)

    def __eq__(self, other):
        if isinstance(other, DeviceColumn):
            other = other.host()
        if isinstance(other, np.ndarray):
            return bool(np.array_equal(self.host(), other))
        return NotImplemented

    __hash__ = None

    def __getattr__(self, name):
        if name.startswith("_"):
            raise AttributeError(name)
        return getattr(self.host(), name)

    def __repr__(self):
        where = "device" if self._adopted else "host"
        return (f"DeviceColumn(n={self.shape[0]}, dtype={self.dtype}, "
                f"authority={where})")

    # -- tracked mutation API ------------------------------------------------

    def assign(self, arr, touched: np.ndarray | None = None) -> None:
        """Wholesale replacement.  A torch tensor is *adopted* (the device
        stays authoritative, zero pull; the port never writes it in
        place); a numpy array replaces the host master with ``touched`` as
        the precise dirty set (full diff when None or on a length
        change)."""
        if _is_device_tensor(arr):
            _host_dtype(arr)  # refuse what the column cannot hold
            object.__setattr__(self, "_dev", arr)
            object.__setattr__(self, "_stale", True)
            object.__setattr__(self, "_adopted", True)
            self._idx.clear()
            object.__setattr__(self, "_all", False)
            return
        arr = np.asarray(arr)
        if not arr.flags.writeable:
            arr = arr.copy()
        length_changed = arr.shape != self.shape
        was_adopted = self._adopted  # un-rooted adoption ⇒ full diff
        object.__setattr__(self, "_adopted", False)
        object.__setattr__(self, "_dev", None)
        object.__setattr__(self, "_stale", False)
        object.__setattr__(self, "_host", arr)
        if touched is None or length_changed or self._all or was_adopted:
            object.__setattr__(self, "_all", True)
        else:
            self._idx.append(np.asarray(touched, dtype=np.int64).ravel())

    def consume(self):
        """Hand the accumulated dirty state to the hash cache and reset.
        Returns ``("device", tensor)`` (adopted — rebuild on the device),
        ``("all", None)`` (diff against the cache's baseline), or
        ``("idx", indices)`` (exact dirty value indices)."""
        if self._adopted:
            return "device", self._dev
        if self._all:
            object.__setattr__(self, "_all", False)
            self._idx.clear()
            return "all", None
        if not self._idx:
            return "idx", np.empty(0, dtype=np.int64)
        idx = np.unique(np.concatenate(self._idx))
        self._idx.clear()
        return "idx", idx

    def copy(self) -> "DeviceColumn":
        """COW clone: the adopted tensor is shared (never written in
        place), the host master is copied, dirty tracking travels."""
        out = DeviceColumn.__new__(DeviceColumn)
        object.__setattr__(out, "_host",
                           None if self._host is None else self._host.copy())
        object.__setattr__(out, "_dev", self._dev)
        object.__setattr__(out, "_stale", self._stale)
        object.__setattr__(out, "_idx", list(self._idx))
        object.__setattr__(out, "_all", self._all)
        object.__setattr__(out, "_adopted", self._adopted)
        return out


# ---------------------------------------------------------------------------
# Device-resident packed-column hash cache
# ---------------------------------------------------------------------------

_PER_CHUNK = {8: 4, 1: 32}  # u64 → 4 values/chunk, u8 → 32


def _repack_leaves_body(col: torch.Tensor, w: int) -> torch.Tensor:
    """A packed source column on the device → its zero-padded ``(w, 8)``
    big-endian chunk-word leaf plane, entirely on the device (the device
    twin of :func:`pack_chunk_rows`).  The chunk bytes are the column's
    little-endian bytes, so both widths reduce to one byte-level view:
    pad to ``32·w`` bytes, reverse each 4-byte group, read as words."""
    raw = col.contiguous().view(torch.uint8)
    flat = torch.zeros(32 * w, dtype=torch.uint8, device=col.device)
    flat[:raw.shape[0]] = raw
    return flat.reshape(8 * w, 4).flip(-1).contiguous().view(
        torch.int32).reshape(w, 8)


def _repack_rebuild(col_dev: torch.Tensor, w: int) -> tuple:
    """Repack + full-level reduction over a device-resident source column
    — the zero-push rebuild used when a column was adopted from a device
    computation."""
    return tree_levels(_repack_leaves_body(col_dev, w))


class DevicePackedCache:
    """Device-resident twin of ``state_cache._PackedSourceCache``: the
    interior tree lives on the device and a warm root pushes only the
    changed chunk rows (or nothing at all, when the column itself was
    computed on the device)."""

    def __init__(self, limit_chunks: int, mixin_length: bool):
        self.depth = max((int(limit_chunks) - 1).bit_length(), 0)
        self.mixin = mixin_length
        self.tree: DeviceTree | None = None
        self.src: np.ndarray | None = None   # host baseline at last root
        self.src_dev = None                  # adopted-era baseline tensor

    # -- internals -----------------------------------------------------------

    def _fold(self, root_words: np.ndarray, w: int, length: int) -> bytes:
        return fold_zero_cap(root_words, (w - 1).bit_length(), self.depth,
                             self.mixin, length)

    def _ensure_src(self) -> None:
        """Recover the host diff baseline after an adopted era (one pull,
        paid only when host-side mutation resumes — which implies the host
        needed the values anyway)."""
        if self.src is None and self.src_dev is not None:
            self.src = to_host(self.src_dev, "packed_cache").view(
                _host_dtype(self.src_dev))
            self.src_dev = None

    def _host_rebuild(self, host: np.ndarray, w: int) -> np.ndarray:
        per = _PER_CHUNK[host.dtype.itemsize]
        padded = np.zeros(w * per, dtype=host.dtype)
        padded[:host.shape[0]] = host
        leaves = pack_chunk_rows(padded.reshape(w, per))
        if self.tree is None:
            self.tree = DeviceTree.from_host_leaves(leaves)
        else:
            self.tree.rebuild_device(to_device(leaves))
        self.src = host.copy()
        self.src_dev = None
        return self.tree.root_words()

    # -- the per-root entry point -------------------------------------------

    def root(self, col) -> bytes:
        # Every copy and event under this root — the nested DeviceTree
        # pushes included — is charged to the packed-column cache.
        with LEDGER.attribute("packed_cache"):
            return self._root_inner(col)

    def _root_inner(self, col) -> bytes:
        if isinstance(col, DeviceColumn):
            state, payload = col.consume()
        else:  # untracked plain column (a path the interception missed)
            col = DeviceColumn(np.asarray(col))
            state, payload = "all", None
        n = int(col.shape[0])
        per = _PER_CHUNK[np.dtype(col.dtype).itemsize]
        n_chunks = max((n + per - 1) // per, 1)
        w = _next_pow2(n_chunks)

        if state == "device":
            if (payload is self.src_dev and self.tree is not None
                    and self.tree.width == w):
                return self._fold(self.tree.root_words(), w, n)
            levels = _repack_rebuild(payload, w)
            LEDGER.note_event("rebuilds")
            if self.tree is None:
                self.tree = DeviceTree(levels)
            else:
                self.tree.levels = levels
                self.tree.shared = False
            self.tree.note_residency()
            self.src = None
            self.src_dev = payload
            return self._fold(self.tree.root_words(), w, n)

        host = col._master()
        if self.tree is None or self.tree.width != w:
            return self._fold(self._host_rebuild(host, w), w, n)

        self._ensure_src()
        if self.src is None:  # first root ever went through device adopt
            return self._fold(self._host_rebuild(host, w), w, n)
        old_n = self.src.shape[0]
        if state == "idx":
            changed = payload[payload < min(old_n, n)] \
                if old_n != n else payload
        else:
            m = min(old_n, n)
            changed = np.nonzero(self.src[:m] != host[:m])[0]
        chunk_idx = np.unique(changed // per)
        if old_n != n:
            lo = min(old_n, n) // per
            hi = (max(old_n, n) + per - 1) // per
            tail = np.arange(lo, min(hi, w), dtype=np.int64)
            chunk_idx = np.union1d(chunk_idx, tail)
            self.src = host.copy()
        elif changed.size:
            self.src[changed] = host[changed]
        if chunk_idx.size == 0:
            return self._fold(self.tree.root_words(), w, n)
        flat = (chunk_idx[:, None] * per
                + np.arange(per)[None, :]).reshape(-1)
        vals = np.where(flat < n,
                        host[np.minimum(flat, max(n - 1, 0))]
                        if n else np.zeros(1, host.dtype),
                        np.zeros(1, host.dtype))
        rows = pack_chunk_rows(vals.reshape(chunk_idx.shape[0], per))
        root = self.tree.scatter(chunk_idx, rows)
        return self._fold(root, w, n)

    def copy(self) -> "DevicePackedCache":
        out = DevicePackedCache.__new__(DevicePackedCache)
        out.depth = self.depth
        out.mixin = self.mixin
        out.tree = None if self.tree is None else self.tree.share()
        out.src = None if self.src is None else self.src.copy()
        out.src_dev = self.src_dev
        return out


# ---------------------------------------------------------------------------
# Materialization + the transition-pass store seam
# ---------------------------------------------------------------------------

def _auto_materialize(state) -> bool:
    """Automatic residency: registry scale on a GPU — explicit
    :func:`materialize_state` covers any device (tests force it on the
    CPU)."""
    from .state_cache import DEVICE_COLD_MIN
    try:
        n = len(state.validators)
    except Exception:
        return False
    return n >= DEVICE_COLD_MIN and on_cuda()


def wants_device_state(state) -> bool:
    if not device_state_enabled():
        return False
    if is_materialized(state):
        return True
    if _auto_materialize(state):
        state.__dict__["_device_resident"] = True
        return True
    return False


def materialize_state(state, force: bool = True) -> bool:
    """Make device buffers the source of truth for this state's hot
    columns.  The one root computed here IS the materialization: the
    registry columns go to the device once, every big field's tree levels
    are built in place, and from then on warm roots are bounded by compute
    + dirty fraction — never by a full re-stage.

    Returns False (no-op) when ``LIGHTHOUSE_TPU_DEVICE_STATE=0`` or, with
    ``force=False``, below the auto threshold or off the GPU."""
    if not device_state_enabled():
        return False
    if is_materialized(state):
        return True
    if not force and not _auto_materialize(state):
        return False
    from ..ops.device_tree import residency_snapshot
    before = residency_snapshot()
    t0 = time.perf_counter()
    state.__dict__["_device_resident"] = True
    state.tree_hash_root()
    after = residency_snapshot()
    LAST_MATERIALIZE_STATS.clear()
    LAST_MATERIALIZE_STATS.update(
        materialize_ms=(time.perf_counter() - t0) * 1e3,
        bytes_pushed=after["bytes_pushed"] - before["bytes_pushed"])
    return True


def wrap_state_column(state, fname: str):
    """Ensure ``state.<fname>`` is a tracked :class:`DeviceColumn`
    (idempotent; used by the hash cache to recover from any assignment
    path the attribute interception did not see)."""
    v = state.__dict__.get(fname)
    if isinstance(v, DeviceColumn):
        return v
    col = DeviceColumn(np.asarray(v))
    object.__setattr__(state, fname, col)
    return col


def store_column(state, fname: str, arr, touched=None) -> None:
    """The transition passes' column store seam: lands ``arr`` in
    ``state.<fname>`` as a device scatter when the state is materialized
    (``touched`` = exact dirty indices; a device tensor is adopted without
    a pull), and as a plain attribute assignment otherwise."""
    cur = state.__dict__.get(fname)
    if isinstance(cur, DeviceColumn):
        cur.assign(arr, touched=touched)
        return
    if _is_device_tensor(arr):
        arr = to_host(arr, "packed_cache").view(_host_dtype(arr))
    setattr(state, fname, arr)
