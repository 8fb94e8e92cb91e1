"""BeaconState incremental tree-hash cache.

Port of ``lighthouse_tpu/types/state_cache.py``.  Counterpart of
``BeaconTreeHashCache``
(``consensus/types/src/beacon_state/tree_hash_cache.rs:332``)
and its per-field ``cached_tree_hash`` arenas: the state root becomes
O(changes·log n) instead of O(state).

Three tiers, by field shape:

- **Validator registry** (the 2^40-limit list of 8-field records,
  the reference's rayon-parallel arena — ``tree_hash_cache.rs:535-556``):
  dirty records come from the registry's column/row dirty marks (writes go
  through ``wcol``/``set``); only marked columns are diffed (one vectorized
  compare), only changed records re-hash their 8-leaf mini-trees (batched),
  and the big record-root tree updates incrementally.
- **Columnar packed fields** (balances, participation flags, inactivity
  scores, roots vectors, slashings): leaf-diff + dirty-path propagation via
  :class:`~lighthouse_tpu_torch.ops.tree_cache.IncrementalMerkleCache`.
- **Small fields** (headers, checkpoints, sync committees, vote lists):
  re-hashed only when their SSZ encoding changes (memoised; the encode-and
  -compare costs µs, and a SyncCommittee rehash alone is ~1k hashes).

The cache travels with ``BeaconState.copy()`` (levels are copied, like the
reference's ``BeaconState`` clone-with-cache) and rebuilds transparently if
absent, so correctness never depends on it.
"""

from __future__ import annotations

import numpy as np

from ..device import on_cuda, to_host
from ..ops.merkle import merkleize_host
from ..ops.tree_cache import (HASH_COUNT, IncrementalMerkleCache,
                              REBUILD_FRACTION)

# Cold builds at/above this many records run on the GPU (below it the
# host path costs ms anyway).  Kept at the JAX package's value for now.
DEVICE_COLD_MIN = 1 << 16


class RegistryCache:
    """Record-root cache for the SoA validator registry.

    Incremental roots are PURE HOST work — diff the columns written since
    the last root (marks are consumed, not sticky), re-hash only the dirty
    records, walk their ancestor paths (`tree_hash_cache.rs:535-556` role).
    Only the registry-scale cold build runs on the GPU, with the interior
    levels copied back into the host tree.  (The device-resident mode,
    :meth:`_root_device`, keeps them on the device instead.)
    """

    def __init__(self):
        self.stored: dict[str, np.ndarray] | None = None  # column copies
        self.count = 0                                    # records at last root
        self.tree: IncrementalMerkleCache | None = None

    # -- cold builds ---------------------------------------------------------

    def _cold_host(self, reg, n: int) -> bytes:
        self._snapshot(reg, n)
        record_roots = np.array(reg.record_roots_words())
        return self.tree.root_words(record_roots, length=n)

    def _cold_device(self, reg, n: int) -> bytes:
        """Device build: record roots and every registry level on the GPU,
        levels copied into the host tree."""
        from .validators import registry_cold_device

        self._snapshot(reg, n)
        root_words, levels = registry_cold_device(reg)
        self.tree.levels = [to_host(lv, "staging") for lv in levels]
        return self._fold(root_words, len(levels) - 1, n)

    def _fold(self, root_words: np.ndarray, lvl: int, n: int) -> bytes:
        from ..ops.tree_cache import fold_zero_cap
        return fold_zero_cap(root_words, lvl, self.tree.depth, True, n)

    def _snapshot(self, reg, n: int) -> None:
        self.stored = {c: np.array(getattr(reg, c)[:n])
                       for c in reg._COLUMNS}
        self.count = n
        reg._dirty_cols.clear()
        reg._dirty_rows.clear()

    # -- device-resident mode ------------------------------------------------

    def _diff_dirty(self, reg, n: int) -> np.ndarray:
        """Consume the registry's dirty marks into exact record indices
        (the shared walk of the host and device-resident warm paths):
        marked columns diff against the stored copies with one vectorized
        compare, grown rows are dirty by construction."""
        old_n = self.count
        dirty = np.zeros(n, dtype=bool)
        dirty[old_n:] = True
        for cname in reg._dirty_cols:
            col = getattr(reg, cname)[:old_n]
            st = self.stored[cname][:old_n]
            if col.ndim == 1:
                np.logical_or(dirty[:old_n], col != st, out=dirty[:old_n])
            else:
                np.logical_or(dirty[:old_n], (col != st).any(axis=1),
                              out=dirty[:old_n])
        for r in reg._dirty_rows:
            if r < n:
                dirty[r] = True
        reg._dirty_cols.clear()
        reg._dirty_rows.clear()
        return np.nonzero(dirty)[0]

    def _update_stored(self, reg, idx: np.ndarray, n: int) -> None:
        for cname in reg._COLUMNS:
            col = getattr(reg, cname)
            st = self.stored[cname]
            if st.shape[0] != n:  # grew (any padded width)
                grown = np.zeros((n,) + st.shape[1:], dtype=st.dtype)
                grown[:min(self.count, n)] = st[:min(self.count, n)]
                st = grown
                self.stored[cname] = st
            if idx.size:
                st[idx] = col[idx]

    def _root_device(self, reg, n: int) -> bytes:
        """Device-resident root: the mirror's device columns + record-root
        tree are the hashing source of truth.  Cold = the ONE-TIME
        materialization; warm = dirty records land as one scatter + path
        re-hash (k raw rows up, 32 bytes down); past the rebuild
        crossover the whole tree re-reduces on the device with zero
        push."""
        from ..ops.merkle import _next_pow2
        from .validators import DeviceRegistryMirror

        mirror = getattr(reg, "_dev_mirror", None)
        w = _next_pow2(max(n, 1))
        if self.stored is None or self.count > n or mirror is None:
            self._snapshot(reg, n)
            mirror = DeviceRegistryMirror.materialize(reg)
            reg._dev_mirror = mirror
            return self._fold(mirror.tree.root_words(),
                              len(mirror.tree.levels) - 1, n)
        idx = self._diff_dirty(reg, n)
        self._update_stored(reg, idx, n)
        self.count = n
        grew = mirror.ensure_width(w)
        if idx.size == 0 and not grew:
            root = mirror.tree.root_words()
        elif grew or idx.size > w // REBUILD_FRACTION:
            if idx.size:
                mirror.scatter_cols(reg, idx)
            root = mirror.rebuild(n)
        else:
            root = mirror.scatter_records(reg, idx)
        return self._fold(root, len(mirror.tree.levels) - 1, n)

    # -- the per-root entry point -------------------------------------------

    def root(self, reg, limit: int, device: bool = False) -> bytes:
        n = len(reg)
        if self.tree is None:
            self.tree = IncrementalMerkleCache(limit, mixin_length=True)
        if device:
            return self._root_device(reg, n)
        if getattr(reg, "_dev_mirror", None) is not None:
            # Knob flipped off mid-life: this host root consumes the dirty
            # marks the mirror would need, so residency ends HERE — a later
            # device root re-materializes instead of serving a stale tree.
            # Any host levels predate the device era (device roots update
            # only stored + device), so they must be rebuilt, not patched.
            reg._dev_mirror = None
            self.tree.levels = None
        from ..ops.merkle import _next_pow2
        cold = (self.stored is None or self.count > n
                or self.tree.levels is None
                or self.tree.levels[0].shape[0] != _next_pow2(max(n, 1)))
        if cold:
            if n >= DEVICE_COLD_MIN and on_cuda():
                return self._cold_device(reg, n)
            return self._cold_host(reg, n)

        # Marks are consumed: wcol views are only valid until the next
        # root (every in-tree caller writes immediately; the sticky
        # alternative re-diffed 130 MB of columns every slot at 2^20).
        idx = self._diff_dirty(reg, n)
        if idx.size:
            roots = reg.record_roots_words(idx)
            self._update_stored(reg, idx, n)
            self.count = n
            return self.tree.update_rows(idx, roots, n, length=n)
        self.count = n
        return self.tree.update_rows(
            np.empty(0, np.int64), np.empty((0, 8), np.uint32), n, length=n)

    def copy(self) -> "RegistryCache":
        out = RegistryCache.__new__(RegistryCache)
        out.stored = (None if self.stored is None
                      else {k: v.copy() for k, v in self.stored.items()})
        out.count = self.count
        out.tree = None if self.tree is None else self.tree.copy()
        return out


# Shared with the device-resident twin (device_state.DevicePackedCache):
# ONE packing implementation keeps the host-oracle and device roots
# bit-identical by construction.
from .device_state import _PER_CHUNK as _PACKED_PER_CHUNK  # noqa: E402
from .device_state import pack_chunk_rows  # noqa: E402


class _PackedSourceCache:
    """Source-level diff for packed uint columns (balances, participation,
    inactivity): compare the raw column against the stored copy (one
    vectorized pass over the source values — 4-32× less traffic than
    leaf-word diffing and no full reconversion), pack ONLY the changed
    chunks, and hand the sparse update to the interior-node cache."""

    def __init__(self, limit_chunks: int, mixin_length: bool):
        self.tree = IncrementalMerkleCache(limit_chunks,
                                           mixin_length=mixin_length)
        self.src: np.ndarray | None = None

    _pack_chunks = staticmethod(pack_chunk_rows)

    def root(self, arr: np.ndarray) -> bytes:
        per = _PACKED_PER_CHUNK[arr.dtype.itemsize]
        n = arr.shape[0]
        n_chunks = (n + per - 1) // per
        pad = n_chunks * per - n
        if self.src is None or self.src.shape[0] != n:
            self.src = arr.copy()
            padded = (np.concatenate([arr, np.zeros(pad, arr.dtype)])
                      if pad else arr)
            return self.tree.root_words(
                self._pack_chunks(padded.reshape(n_chunks, per)), length=n)
        changed = np.nonzero(self.src != arr)[0]
        if changed.size == 0:
            return self.tree.update_rows(
                np.empty(0, np.int64), np.empty((0, 8), np.uint32),
                n_chunks, length=n)
        chunk_idx = np.unique(changed // per)
        self.src[changed] = arr[changed]
        flat = (chunk_idx[:, None] * per
                + np.arange(per)[None, :]).reshape(-1)
        vals = np.where(flat < n, arr[np.minimum(flat, n - 1)],
                        np.zeros(1, arr.dtype))
        rows = self._pack_chunks(vals.reshape(chunk_idx.shape[0], per))
        return self.tree.update_rows(chunk_idx, rows, n_chunks, length=n)

    def copy(self) -> "_PackedSourceCache":
        out = _PackedSourceCache.__new__(_PackedSourceCache)
        out.tree = self.tree.copy()
        out.src = None if self.src is None else self.src.copy()
        return out


class StateHashCache:
    """Per-state-instance cache over all fields + the container fold."""

    def __init__(self):
        self.fields: dict[str, IncrementalMerkleCache] = {}
        self.packed: dict[str, _PackedSourceCache] = {}
        self.device_packed: dict = {}  # fname → DevicePackedCache
        self.registry = RegistryCache()
        self.small: dict[str, tuple[bytes, bytes]] = {}  # fname → (enc, root)
        # Per-field roots of the LAST root() fold — the proof plane
        # (light_client / proof_engine) reads this instead of re-hashing
        # every field per request.  Valid only for the root just
        # computed; root() refreshes it, copy() drops it.
        self.field_layer: list | None = None

    @staticmethod
    def _packed_limits(ftype) -> tuple[int, bool]:
        """(limit_chunks, mixin_length) of a packed uint field without
        needing a value (the DeviceColumn path never round-trips one)."""
        per = 32 // np.dtype(ftype.DTYPE).itemsize
        return (max((ftype.BOUND + per - 1) // per, 1),
                not ftype.is_fixed_size())

    def root(self, state) -> bytes:
        from .device_state import (DeviceColumn, DevicePackedCache,
                                   wants_device_state, wrap_state_column)
        use_dev = wants_device_state(state)
        leaves = []
        for fname, ftype in type(state).FIELDS.items():
            v = getattr(state, fname)
            is_packed = (getattr(ftype, "DTYPE", None) is not None
                         and np.dtype(ftype.DTYPE).itemsize
                         in _PACKED_PER_CHUNK
                         and (isinstance(v, DeviceColumn)
                              or (isinstance(v, np.ndarray)
                                  and v.ndim == 1)))
            if fname == "validators":
                leaves.append(self.registry.root(v, ftype.LIMIT,
                                                 device=use_dev))
            elif is_packed and use_dev:
                col = wrap_state_column(state, fname)
                cache = self.device_packed.get(fname)
                if cache is None:
                    limit_chunks, mixin = self._packed_limits(ftype)
                    cache = DevicePackedCache(limit_chunks, mixin)
                    self.device_packed[fname] = cache
                leaves.append(cache.root(col))
            elif is_packed:
                if isinstance(v, DeviceColumn):  # knob flipped off mid-life
                    v = v.host()
                cache = self.packed.get(fname)
                if cache is None:
                    _w, limit_chunks, length = ftype.leaf_words(v)
                    cache = _PackedSourceCache(limit_chunks,
                                               length is not None)
                    self.packed[fname] = cache
                leaves.append(cache.root(np.asarray(v)))
            elif hasattr(ftype, "leaf_words"):
                words, limit_chunks, length = ftype.leaf_words(v)
                cache = self.fields.get(fname)
                if cache is None:
                    cache = IncrementalMerkleCache(
                        limit_chunks, mixin_length=length is not None)
                    self.fields[fname] = cache
                leaves.append(cache.root_words(words, length))
            else:
                enc = ftype.serialize(v)
                memo = self.small.get(fname)
                if memo is not None and memo[0] == enc:
                    leaves.append(memo[1])
                else:
                    r = ftype.hash_tree_root(v)
                    self.small[fname] = (enc, r)
                    leaves.append(r)
        HASH_COUNT[0] += len(leaves)  # container fold, ~2 per leaf
        self.field_layer = leaves
        return merkleize_host(leaves)

    def copy(self) -> "StateHashCache":
        out = StateHashCache.__new__(StateHashCache)
        out.fields = {k: c.copy() for k, c in self.fields.items()}
        out.packed = {k: c.copy() for k, c in self.packed.items()}
        out.device_packed = {k: c.copy()
                             for k, c in self.device_packed.items()}
        out.registry = self.registry.copy()
        out.small = dict(self.small)
        out.field_layer = None
        return out
