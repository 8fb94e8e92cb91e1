"""Validator registry as a structure-of-arrays (SoA), hashed on the GPU.

Port of ``lighthouse_tpu/types/validators.py``.  The reference stores
validators as an array-of-structs and parallelises hashing with rayon over
4096-record arenas (``consensus/types/src/beacon_state/
tree_hash_cache.rs:25-33, 535-556``).  Here each field is one numpy column,
so

- epoch processing is vectorized arithmetic over whole columns;
- the registry Merkle root is batched device work: 8 chunk-leaves per
  validator, three ``hash64`` levels to per-validator roots (plus the
  48-byte pubkey pre-hash), then the big padded reduction to the
  2^40-leaf registry root (``consensus/types/src/validator.rs`` field
  order defines the leaves).

On the device the raw columns keep their wire widths — pubkeys as
``(n, 12)`` words, credentials ``(n, 8)``, ``slashed`` as u8, every u64
as an ``(n, 2)`` int32 (lo, hi) pair — and expand to chunk words there.

``Validator`` (the AoS container) remains the single-record interchange
type; the registry converts at the boundary.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from ..common.device_ledger import LEDGER
from ..device import to_device, to_host
from ..ssz.core import Bytes32, Bytes48, SszError
from ..ssz.composite import Container
from ..ssz import boolean, uint64
from .chain_spec import FAR_FUTURE_EPOCH

# Packed wire layout: 121 bytes per record, field order per the spec
# container (``consensus/types/src/validator.rs``).
_VALIDATOR_DTYPE = np.dtype([
    ("pubkey", "u1", (48,)),
    ("withdrawal_credentials", "u1", (32,)),
    ("effective_balance", "<u8"),
    ("slashed", "u1"),
    ("activation_eligibility_epoch", "<u8"),
    ("activation_epoch", "<u8"),
    ("exit_epoch", "<u8"),
    ("withdrawable_epoch", "<u8"),
])
assert _VALIDATOR_DTYPE.itemsize == 121

_EPOCH_FIELDS = ("activation_eligibility_epoch", "activation_epoch",
                 "exit_epoch", "withdrawable_epoch")


class Validator(Container):
    """Single-record AoS form (interchange/SSZ boundary)."""
    pubkey: Bytes48
    withdrawal_credentials: Bytes32
    effective_balance: uint64
    slashed: boolean
    activation_eligibility_epoch: uint64
    activation_epoch: uint64
    exit_epoch: uint64
    withdrawable_epoch: uint64


def u64_to_chunk_words(v: np.ndarray) -> np.ndarray:
    """``(n,) uint64`` → ``(n, 8) uint32`` big-endian words of the 32-byte
    SSZ chunk (value little-endian, zero-padded)."""
    v = np.asarray(v, dtype=np.uint64)
    lo = (v & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    hi = (v >> np.uint64(32)).astype(np.uint32)
    out = np.zeros(v.shape + (8,), dtype=np.uint32)
    out[..., 0] = lo.byteswap()
    out[..., 1] = hi.byteswap()
    return out


def bytes_col_to_words(col: np.ndarray) -> np.ndarray:
    """``(n, 4k) uint8`` → ``(n, k) uint32`` big-endian words."""
    col = np.ascontiguousarray(col)
    return col.view(">u4").astype(np.uint32)


class ValidatorRegistry:
    """SoA columns + list-like API.  Mutations go through the columns
    (vectorized) or :meth:`set`; ``append`` amortizes with capacity doubling
    like the reference's ``CacheArena`` grow path."""

    __ssz_mutable__ = True

    def __init__(self, n: int = 0, _cap: int | None = None):
        cap = max(_cap if _cap is not None else n, n, 8)
        self._n = n
        self._pubkey = np.zeros((cap, 48), dtype=np.uint8)
        self._withdrawal_credentials = np.zeros((cap, 32), dtype=np.uint8)
        self._effective_balance = np.zeros(cap, dtype=np.uint64)
        self._slashed = np.zeros(cap, dtype=bool)
        self._activation_eligibility_epoch = np.full(
            cap, FAR_FUTURE_EPOCH, dtype=np.uint64)
        self._activation_epoch = np.full(cap, FAR_FUTURE_EPOCH, dtype=np.uint64)
        self._exit_epoch = np.full(cap, FAR_FUTURE_EPOCH, dtype=np.uint64)
        self._withdrawable_epoch = np.full(cap, FAR_FUTURE_EPOCH,
                                           dtype=np.uint64)
        # Dirty tracking for the incremental tree-hash cache
        # (``cached_tree_hash``'s dirty leaves, at column/row granularity).
        # ``col()`` views are read-only so every write goes through ``wcol``/
        # ``set``/``append`` and is tracked — an unmarked write raises.
        # Marks are CONSUMED by the hash cache at root time: a ``wcol``
        # view is only valid for writing until the next ``hash_tree_root``
        # (every in-tree caller writes immediately; sticky marks meant
        # re-diffing 130 MB of columns on every root at 2^20 validators).
        self._dirty_cols: set = set(self._COLUMNS)
        self._dirty_rows: set = set()
        # Lazy pubkey → index map (the ``ValidatorPubkeyCache`` reverse
        # lookup).  Shared by reference across ``copy()``; extension forks
        # the dict first so a sharer never sees rows it does not have, and
        # ``set()`` (the only in-place pubkey overwrite) invalidates.
        self._pk_index: dict | None = None
        self._pk_index_n = 0
        # Device mirror (device-resident raw columns + record-root tree),
        # attached by the device-resident hash cache; COW-shared across
        # copy().  None until materialized.
        self._dev_mirror = None

    _COLUMNS = ("pubkey", "withdrawal_credentials", "effective_balance",
                "slashed", "activation_eligibility_epoch", "activation_epoch",
                "exit_epoch", "withdrawable_epoch")

    # -- list-like API -------------------------------------------------------

    def __len__(self) -> int:
        return self._n

    def col(self, name: str) -> np.ndarray:
        """Read-only view of a column, truncated to the real length.
        Writes must go through :meth:`wcol` (which marks the column dirty
        for the incremental hash cache) — writing this view raises, and the
        public column attributes are themselves read-only views so no write
        can bypass the tracking."""
        v = getattr(self, "_" + name)[:self._n]
        v.flags.writeable = False
        return v

    def wcol(self, name: str) -> np.ndarray:
        """Writable column view; marks the whole column dirty (the hash
        cache diffs it against its stored copy at root time, so the cost of
        a column-wide mark is one vectorized compare, not a rehash).

        The view must not be written after the next ``hash_tree_root`` —
        the cache consumes the mark there; re-call ``wcol`` for later
        writes."""
        self._dirty_cols.add(name)
        return getattr(self, "_" + name)[:self._n]

    def __getitem__(self, i: int) -> Validator:
        if not -self._n <= i < self._n:
            raise IndexError(i)
        i %= max(self._n, 1)
        return Validator(
            pubkey=self._pubkey[i].tobytes(),
            withdrawal_credentials=self._withdrawal_credentials[i].tobytes(),
            effective_balance=int(self._effective_balance[i]),
            slashed=bool(self._slashed[i]),
            activation_eligibility_epoch=int(
                self._activation_eligibility_epoch[i]),
            activation_epoch=int(self._activation_epoch[i]),
            exit_epoch=int(self._exit_epoch[i]),
            withdrawable_epoch=int(self._withdrawable_epoch[i]),
        )

    def __iter__(self):
        for i in range(self._n):
            yield self[i]

    def init_columns(self, **arrays) -> None:
        """Bulk-initialise columns on a FRESH registry (genesis fast path).
        All columns start dirty, so no extra marking is needed; using this
        instead of ``wcol`` avoids sticky-marking bulk-written columns."""
        for name, arr in arrays.items():
            if name not in self._COLUMNS:
                raise KeyError(name)
            getattr(self, "_" + name)[:self._n] = arr
        self._pk_index = None

    def pubkey_index(self, pubkey: bytes) -> int | None:
        """Index of ``pubkey`` in the registry (first occurrence), or None.
        One lazy dict build per registry lineage; copies share it and
        appended rows extend it incrementally."""
        d = self._pk_index
        if d is None:
            d = {}
            self._pk_index_n = 0
        if self._pk_index_n < self._n:
            if d:
                d = dict(d)  # fork: never extend a possibly-shared dict
            pks = self._pubkey
            for i in range(self._pk_index_n, self._n):
                d.setdefault(pks[i].tobytes(), i)
            self._pk_index, self._pk_index_n = d, self._n
        idx = d.get(pubkey)
        if idx is None:
            return None
        if idx < self._n and self._pubkey[idx].tobytes() == pubkey:
            return idx
        # Stale entry (row overwritten under a shared dict): rebuild once.
        d = {}
        pks = self._pubkey
        for i in range(self._n):
            d.setdefault(pks[i].tobytes(), i)
        self._pk_index, self._pk_index_n = d, self._n
        return d.get(pubkey)

    def set(self, i: int, v: Validator) -> None:
        if not 0 <= i < self._n:
            raise IndexError(i)
        self._pk_index = None  # a row overwrite may change a pubkey
        self._dirty_rows.add(i)
        self._pubkey[i] = np.frombuffer(v.pubkey, dtype=np.uint8)
        self._withdrawal_credentials[i] = np.frombuffer(
            v.withdrawal_credentials, dtype=np.uint8)
        self._effective_balance[i] = v.effective_balance
        self._slashed[i] = v.slashed
        self._activation_eligibility_epoch[i] = v.activation_eligibility_epoch
        self._activation_epoch[i] = v.activation_epoch
        self._exit_epoch[i] = v.exit_epoch
        self._withdrawable_epoch[i] = v.withdrawable_epoch

    def _grow(self, need: int) -> None:
        cap = self._effective_balance.shape[0]
        if need <= cap:
            return
        new_cap = max(need, cap * 2)
        for name in self._COLUMNS:
            old = getattr(self, "_" + name)
            new = np.empty((new_cap,) + old.shape[1:], dtype=old.dtype)
            new[:self._n] = old[:self._n]
            if old.dtype == np.uint64 and name in _EPOCH_FIELDS:
                new[self._n:] = FAR_FUTURE_EPOCH
            else:
                new[self._n:] = 0
            setattr(self, "_" + name, new)

    def append(self, v: Validator) -> None:
        self._grow(self._n + 1)
        self._n += 1
        self.set(self._n - 1, v)

    def copy(self) -> "ValidatorRegistry":
        out = ValidatorRegistry.__new__(type(self))
        out._n = self._n
        for name in self._COLUMNS:
            setattr(out, "_" + name, getattr(self, "_" + name)[:self._n].copy())
        out._dirty_cols = set(self._dirty_cols)
        out._dirty_rows = set(self._dirty_rows)
        out._pk_index = self._pk_index  # shared; forked on extension
        out._pk_index_n = self._pk_index_n
        # COW: the clone shares every device buffer; the first write of
        # either lineage clones what it changes (DeviceRegistryMirror.
        # _own_cols), so cloning duplicates no device memory up front.
        out._dev_mirror = (None if self._dev_mirror is None
                           else self._dev_mirror.share())
        return out

    def __eq__(self, other):
        if not isinstance(other, ValidatorRegistry):
            return NotImplemented
        if self._n != other._n:
            return False
        return all(
            np.array_equal(self.col(name), other.col(name))
            for name in self._COLUMNS)

    def __repr__(self):
        return f"ValidatorRegistry(n={self._n})"

    # -- bulk conversion -----------------------------------------------------

    @classmethod
    def from_validators(cls, validators) -> "ValidatorRegistry":
        out = cls(len(validators))
        out._n = len(validators)
        for i, v in enumerate(validators):
            out.set(i, v)
        return out

    def to_packed(self) -> bytes:
        arr = np.empty(self._n, dtype=_VALIDATOR_DTYPE)
        arr["pubkey"] = self._pubkey[:self._n]
        arr["withdrawal_credentials"] = self._withdrawal_credentials[:self._n]
        arr["effective_balance"] = self._effective_balance[:self._n]
        arr["slashed"] = self._slashed[:self._n].astype(np.uint8)
        for f in _EPOCH_FIELDS:
            arr[f] = getattr(self, "_" + f)[:self._n]
        return arr.tobytes()

    @classmethod
    def from_packed(cls, data: bytes) -> "ValidatorRegistry":
        if len(data) % _VALIDATOR_DTYPE.itemsize:
            raise SszError("validator registry bytes not a multiple of 121")
        arr = np.frombuffer(data, dtype=_VALIDATOR_DTYPE)
        n = arr.shape[0]
        out = cls(n)
        out._n = n
        out._pubkey[:n] = arr["pubkey"]
        out._withdrawal_credentials[:n] = arr["withdrawal_credentials"]
        out._effective_balance[:n] = arr["effective_balance"]
        if arr["slashed"].size and (arr["slashed"] > 1).any():
            raise SszError("invalid boolean byte in validator record")
        out._slashed[:n] = arr["slashed"].astype(bool)
        for f in _EPOCH_FIELDS:
            getattr(out, "_" + f)[:n] = arr[f]
        return out

    # -- Merkleization (the hot path) ---------------------------------------

    def record_roots_words(self, indices=None) -> np.ndarray:
        """Per-validator hash_tree_roots as ``(k, 8)`` u32 words.  Up to
        ``HOST_DISPATCH_THRESHOLD`` records hash on the host; more run as
        one batch on the device (raw rows up, record mini-trees by the
        ``hash64`` kernel, roots down).  ``indices`` restricts to a subset
        (the incremental cache recomputes only dirty records)."""
        from ..ops.merkle import HOST_DISPATCH_THRESHOLD, hash64_host_words
        from ..ops.tree_cache import HASH_COUNT
        n = self._n
        if indices is None:
            sel = slice(None, n)  # zero-copy column views for full builds
            k = n
        else:
            sel = np.asarray(indices)
            k = sel.shape[0]
        if k == 0:
            return np.zeros((0, 8), dtype=np.uint32)
        HASH_COUNT[0] += 8 * k
        if k > HOST_DISPATCH_THRESHOLD:
            rows = {name: to_device(arr, "staging")
                    for name, arr in _registry_raw_rows(self, sel).items()}
            return to_host(_record_roots_body(rows), "staging")
        h64 = hash64_host_words
        pk = self._pubkey[sel]
        pk_hi = np.zeros((k, 32), dtype=np.uint8)
        pk_hi[:, :16] = pk[:, 32:]
        pubkey_root = h64(bytes_col_to_words(pk[:, :32]),
                          bytes_col_to_words(pk_hi))
        leaves = np.stack([
            pubkey_root,
            bytes_col_to_words(self._withdrawal_credentials[sel]),
            u64_to_chunk_words(self._effective_balance[sel]),
            u64_to_chunk_words(self._slashed[sel].astype(np.uint64)),
            u64_to_chunk_words(self._activation_eligibility_epoch[sel]),
            u64_to_chunk_words(self._activation_epoch[sel]),
            u64_to_chunk_words(self._exit_epoch[sel]),
            u64_to_chunk_words(self._withdrawable_epoch[sel]),
        ], axis=1)  # (k, 8, 8)
        l1 = h64(leaves[:, 0::2], leaves[:, 1::2])   # (k, 4, 8)
        l2 = h64(l1[:, 0::2], l1[:, 1::2])           # (k, 2, 8)
        return h64(l2[:, 0], l2[:, 1])               # (k, 8)

    def hash_tree_root(self, limit: int) -> bytes:
        """Registry root: batched record roots → padded device reduction to
        the ``limit``-leaf tree → length mixin."""
        from .columns import device_merkle_root
        return device_merkle_root(self.record_roots_words(), limit,
                                  length_mixin=self._n)


def _column_property(name: str) -> property:
    def get(self):
        v = getattr(self, "_" + name).view()
        v.flags.writeable = False
        return v
    get.__doc__ = (f"Read-only view of the {name} column storage (full "
                   "capacity); mutate via wcol()/set()/append() so the "
                   "incremental hash cache sees the change.")
    return property(get)


for _cname in ValidatorRegistry._COLUMNS:
    setattr(ValidatorRegistry, _cname, _column_property(_cname))
del _cname


# ---------------------------------------------------------------------------
# Device bodies: raw columns → record mini-tree roots → registry levels
# ---------------------------------------------------------------------------

def _bswap32(x: torch.Tensor) -> torch.Tensor:
    """Byte-swap every 32-bit word of an int32 tensor (a little-endian
    u32 becomes the big-endian word of its chunk bytes)."""
    b = x.contiguous().view(torch.uint8).reshape(*x.shape, 4)
    return b.flip(-1).contiguous().view(torch.int32).reshape(x.shape)


def _u64_lohi_words(lohi: torch.Tensor) -> torch.Tensor:
    """(n, 2) int32 little-endian (lo, hi) → (n, 8) big-endian chunk
    words of the SSZ uint64."""
    z = torch.zeros((lohi.shape[0], 6), dtype=torch.int32,
                    device=lohi.device)
    return torch.cat([_bswap32(lohi), z], dim=1)


def _registry_raw_rows(reg: "ValidatorRegistry", idx) -> dict:
    """Host marshalling of the records at ``idx`` (an index array or a
    slice) in their raw device encodings: byte columns as u32 words, u64
    columns as (k, 2) u32 (lo, hi) views, ``slashed`` as u8."""
    rows = {
        "pubkey": bytes_col_to_words(reg._pubkey[idx]),
        "withdrawal_credentials": bytes_col_to_words(
            reg._withdrawal_credentials[idx]),
        "slashed": reg._slashed[idx].astype(np.uint8),
    }
    for f in ("effective_balance",) + _EPOCH_FIELDS:
        rows[f] = np.ascontiguousarray(
            getattr(reg, "_" + f)[idx]).view(np.uint32).reshape(-1, 2)
    return rows


def _registry_raw_columns(reg: "ValidatorRegistry", m: int) -> dict:
    """:func:`_registry_raw_rows` of every record, zero-padded to ``m``
    rows (pad rows are masked to zero chunks before they are hashed)."""
    n = reg._n
    out = {}
    for k, a in _registry_raw_rows(reg, slice(None, n)).items():
        if a.shape[0] != m:
            full = np.zeros((m,) + a.shape[1:], dtype=a.dtype)
            full[:n] = a
            a = full
        out[k] = a
    return out


def _pubkey_roots(pk: torch.Tensor) -> torch.Tensor:
    """hash_tree_root of each 48-byte pubkey: ``(n, 12)`` words → the
    ``hash64`` of its first 32 bytes with the last 16 zero-padded."""
    from ..ops.merkle_kernel import hash64_kernel
    pk_hi = torch.zeros((pk.shape[0], 8), dtype=torch.int32,
                        device=pk.device)
    pk_hi[:, :4] = pk[:, 8:]
    return hash64_kernel(pk[:, :8], pk_hi)


def _record_roots_body(cols: dict) -> torch.Tensor:
    """Raw device columns (m rows) → (m, 8) record mini-tree roots: the
    pubkey pre-hash, then three tree levels over the (8m, 8) leaf plane
    (record r's leaves are rows 8r..8r+7, so each level is one
    ``hash64`` launch over the even and odd rows)."""
    from ..ops.merkle_kernel import hash64_kernel

    pk = cols["pubkey"]                       # (m, 12) words
    m = pk.shape[0]
    slashed = torch.zeros((m, 2), dtype=torch.int32, device=pk.device)
    slashed[:, 0] = cols["slashed"].to(torch.int32)
    leaves = torch.stack([
        _pubkey_roots(pk),
        cols["withdrawal_credentials"],
        _u64_lohi_words(cols["effective_balance"]),
        _u64_lohi_words(slashed),
        _u64_lohi_words(cols["activation_eligibility_epoch"]),
        _u64_lohi_words(cols["activation_epoch"]),
        _u64_lohi_words(cols["exit_epoch"]),
        _u64_lohi_words(cols["withdrawable_epoch"]),
    ], dim=1).reshape(8 * m, 8)
    cur = leaves
    for _ in range(3):
        cur = hash64_kernel(cur[0::2], cur[1::2])
    return cur                                # (m, 8) record roots


def _levels_from_records(rec: torch.Tensor, n: int) -> tuple:
    """Registry levels over record roots: rows at or beyond ``n`` zeroed
    to zero CHUNKS (SSZ list padding; the pad rows' record roots are not
    zero chunks), then one ``hash64`` launch per level."""
    from ..ops.merkle_kernel import tree_levels
    rec[n:] = 0
    return tree_levels(rec)


def _mirror_levels(cols: dict, n: int) -> tuple:
    """Every record-tree level from the device columns."""
    return _levels_from_records(_record_roots_body(cols), n)


# Host→device streaming granularity of the registry's cold builds: 2^17
# records ≈ 15 MiB of raw columns a chunk.
REG_PUSH_CHUNK_ROWS = 1 << 17

# Stage timings of the most recent cold build or materialize (ms): the
# copy time left on the critical path (``push_ms``), the rest
# (``compute_ms``), the copy time hidden behind the earlier chunks'
# hashing (``push_overlap_ms``), the background copy time
# (``transfer_ms``), chunks and staging fallbacks.
LAST_COLD_TIMINGS: dict = {}


def _reg_chunk_rows() -> int:
    """The shared knob in records (a registry row is ~2× the bytes of a
    leaf row), rounded down to a power of two so it divides the registry
    widths; ≤ 0 disables chunking."""
    from ..common.knobs import knob_int
    rows = knob_int("LIGHTHOUSE_TPU_PUSH_CHUNK_ROWS",
                    default=REG_PUSH_CHUNK_ROWS)
    return 1 << (rows.bit_length() - 1) if rows > 0 else 0


def _staged_columns(host: dict, w: int, chunk: int, subsystem: str,
                    keep_cols: bool):
    """Copy the raw ``host`` columns (``w`` rows) to the device and hash
    their record mini-trees.  Wider than ``chunk`` rows, they stream in
    row chunks through a :class:`~..parallel.pipeline.ChunkStager`: chunk
    i+1 copies while chunk i's record roots are hashed.  Returns
    ``(device columns, (w, 8) record roots)``; the columns are ``None``
    unless ``keep_cols``, and then no chunk outlives its hashing."""
    t0 = time.perf_counter()
    if chunk <= 0 or w <= chunk or w % chunk:
        cols = {k: to_device(v, subsystem) for k, v in host.items()}
        t1 = time.perf_counter()
        rec = _record_roots_body(cols)
        LAST_COLD_TIMINGS.clear()
        LAST_COLD_TIMINGS.update(push_ms=(t1 - t0) * 1e3,
                                 compute_ms=(time.perf_counter() - t1) * 1e3,
                                 push_overlap_ms=0.0, transfer_ms=0.0,
                                 push_chunks=1, push_fallbacks=0)
        return (cols if keep_cols else None), rec

    from ..parallel.pipeline import ChunkStager

    chunks = [{k: v[b:b + chunk] for k, v in host.items()}
              for b in range(0, w, chunk)]
    stager = ChunkStager(chunks, subsystem=subsystem)
    parts, recs = [], []
    for dev in stager:
        if keep_cols:
            parts.append(dev)
        recs.append(_record_roots_body(dev))
    cols = ({k: torch.cat([p[k] for p in parts], 0) for k in host}
            if keep_cols else None)
    rec = torch.cat(recs, 0)
    wall = time.perf_counter() - t0
    LAST_COLD_TIMINGS.clear()
    LAST_COLD_TIMINGS.update(
        push_ms=stager.wait_s * 1e3,
        compute_ms=max(wall - stager.wait_s, 0.0) * 1e3,
        push_overlap_ms=max(stager.transfer_s - stager.wait_s, 0.0) * 1e3,
        transfer_ms=stager.transfer_s * 1e3, push_chunks=len(chunks),
        push_fallbacks=stager.fallbacks)
    return cols, rec


def registry_cold_device(reg: "ValidatorRegistry",
                         chunk_rows: int | None = None):
    """Cold build on the device: returns ``(root_words, levels)`` — the
    (8,) u32 root of the occupied power-of-two subtree (on the host) and
    the device-resident tree levels for the caller to copy into the host
    incremental cache.  Registries wider than one push chunk stream their
    raw columns through the chunk stager (:func:`_staged_columns`)."""
    from ..ops.merkle import _next_pow2
    n = reg._n
    w = _next_pow2(max(n, 1))
    chunk = _reg_chunk_rows() if chunk_rows is None else chunk_rows
    _, rec = _staged_columns(_registry_raw_columns(reg, w), w, chunk,
                             "staging", keep_cols=False)
    levels = _levels_from_records(rec, n)
    return to_host(levels[-1][0], "staging"), levels


# ---------------------------------------------------------------------------
# Registry root from device-resident chunk-word columns (one expansion tree)
# ---------------------------------------------------------------------------

def registry_device_columns(reg: "ValidatorRegistry") -> dict:
    """Copy the registry columns to the device once, as chunk words."""
    n = reg._n
    host = {
        "pubkey": bytes_col_to_words(reg._pubkey[:n]),
        "withdrawal_credentials":
            bytes_col_to_words(reg._withdrawal_credentials[:n]),
        "effective_balance": u64_to_chunk_words(reg._effective_balance[:n]),
        "slashed": u64_to_chunk_words(reg._slashed[:n].astype(np.uint64)),
        "activation_eligibility_epoch":
            u64_to_chunk_words(reg._activation_eligibility_epoch[:n]),
        "activation_epoch": u64_to_chunk_words(reg._activation_epoch[:n]),
        "exit_epoch": u64_to_chunk_words(reg._exit_epoch[:n]),
        "withdrawable_epoch":
            u64_to_chunk_words(reg._withdrawable_epoch[:n]),
    }
    return {k: to_device(v, "staging") for k, v in host.items()}


def registry_root_device(cols: dict, count: int, limit: int) -> bytes:
    """Registry ``hash_tree_root`` from :func:`registry_device_columns`,
    expansion-tree form (``_registry_root_fused``): the tree over record
    roots is exactly the tree over the ``8n`` leaves
    ``[pubkey_root, wc, eff, slashed, 4 epochs] × n``, so after the pubkey
    pre-hash ONE sub-tree kernel launch swallows the record mini-trees and
    the registry levels together.  ``count`` must equal the row count and
    be a power of two with ``8·count ≥ 2^CHUNK_LOG2`` (a zero-padded row
    is not a zero record: its pubkey root is not a zero chunk)."""
    from ..ops.merkle import merkleize_auto
    from ..ops.merkle_kernel import CHUNK_LOG2, chunk_roots_natural
    from ..ops.tree_cache import fold_zero_cap

    n = cols["pubkey"].shape[0]
    if n != count or n & (n - 1) or 8 * n < (1 << CHUNK_LOG2):
        raise ValueError(f"count {count} must equal the {n} rows and be a "
                         f"power of two ≥ {(1 << CHUNK_LOG2) // 8}")
    depth = max((int(limit) - 1).bit_length(), 0)
    leaves = torch.stack([
        _pubkey_roots(cols["pubkey"]),
        cols["withdrawal_credentials"],
        cols["effective_balance"],
        cols["slashed"],
        cols["activation_eligibility_epoch"],
        cols["activation_epoch"],
        cols["exit_epoch"],
        cols["withdrawable_epoch"],
    ], dim=1).reshape(8 * n, 8)               # 8n-leaf expansion tree
    roots = to_host(chunk_roots_natural(leaves, CHUNK_LOG2), "staging")
    log_n = n.bit_length() - 1
    # Reduce the chunk roots to the expansion-tree root, which sits at
    # record level log2(n); the zero caps above it pair with record-level
    # zero hashes (the list pads with zero CHUNKS at the record level).
    sub = merkleize_auto(roots, log_n + 3, base_level=CHUNK_LOG2)
    return fold_zero_cap(sub, log_n, depth, True, count)


# ---------------------------------------------------------------------------
# Device-resident registry mirror: device columns + record-root tree as the
# hashing source of truth
# ---------------------------------------------------------------------------
#
# The mirror makes the column copy a ONE-TIME materialization: the raw
# columns and every tree level stay on the device, ``wcol``/``set``/
# ``append`` dirty marks become per-root record scatters (k raw rows up,
# 32 bytes down), and the rebuild crossover (dirty > width/8) re-reduces
# from the device columns with zero push.  ``share()`` gives copy-on-write
# clones for the fork-choice state cache.

def _pad_rows_bucket(idx: np.ndarray, rows: dict) -> tuple:
    """Bucket-pad a record scatter — :func:`..ops.device_tree.pad_bucket`
    applied per raw column (duplicating the first (index, raw row) pair is
    idempotent: it scatters the same record and re-hashes the same path)."""
    from ..ops.device_tree import pad_bucket
    pidx = idx.astype(np.int32, copy=False)
    out = {}
    for name, arr in rows.items():
        pidx, out[name] = pad_bucket(idx, arr)
    return pidx, out


class DeviceRegistryMirror:
    """Device-resident raw columns + record-root tree for one registry
    lineage (copy-on-write across :meth:`ValidatorRegistry.copy`).

    Columns are updated in place only while this mirror owns them: after
    :meth:`share` both mirrors are marked shared, and the first write to
    either clones the columns it is about to change (the tree clones its
    own levels, :meth:`..ops.device_tree.DeviceTree._own`)."""

    __slots__ = ("cols", "tree", "shared", "_res", "__weakref__")

    def __init__(self, cols: dict, tree, shared: bool = False):
        self.cols = cols
        self.tree = tree
        self.shared = shared
        self._res = None

    @property
    def width(self) -> int:
        return self.cols["slashed"].shape[0]

    def note_residency(self) -> None:
        """Ledger watermark seam: this mirror's device columns + record
        tree (a share() clone counts nothing until it diverges — the
        parent owns the shared buffers)."""
        total = sum(v.numel() * v.element_size()
                    for v in self.cols.values()) \
            + sum(lv.numel() * lv.element_size() for lv in self.tree.levels)
        if self._res is None:
            self._res = LEDGER.track(self, "registry_mirror", total)
        else:
            self._res.set(total)

    @classmethod
    def materialize(cls, reg: "ValidatorRegistry") -> "DeviceRegistryMirror":
        """One-time column copy (chunk-staged for registries wider than
        one push chunk, like the cold build) + on-device level reduction.
        This is the LAST full-width push this lineage ever makes."""
        from ..ops.device_tree import DeviceTree
        from ..ops.merkle import _next_pow2
        from ..ops.tree_cache import HASH_COUNT

        n = reg._n
        w = _next_pow2(max(n, 1))
        with LEDGER.attribute("registry_mirror"):
            LEDGER.note_event("materializes")
            cols, rec = _staged_columns(_registry_raw_columns(reg, w), w,
                                        _reg_chunk_rows(), "registry_mirror",
                                        keep_cols=True)
            levels = _levels_from_records(rec, n)
            HASH_COUNT[0] += 8 * w + (w - 1)
            mirror = cls(cols, DeviceTree(levels), False)
            mirror.note_residency()
            return mirror

    def _own_cols(self) -> None:
        """Copy-on-write: clone the columns before the first in-place
        write of a mirror whose buffers a sibling may still hold."""
        if self.shared:
            self.cols = {k: v.clone() for k, v in self.cols.items()}
            self.shared = False

    def _push_rows(self, reg: "ValidatorRegistry", idx: np.ndarray):
        """Bucket-padded raw rows of ``idx`` on the device, written into
        the (owned) columns; returns ``(idx_dev, rows_dev)``."""
        pidx, rows = _pad_rows_bucket(np.asarray(idx),
                                      _registry_raw_rows(reg, idx))
        idx_dev = to_device(pidx.astype(np.int64))
        rows_dev = {k: to_device(v) for k, v in rows.items()}
        self._own_cols()
        for k, col in self.cols.items():
            col[idx_dev] = rows_dev[k]
        return idx_dev, rows_dev

    def scatter_records(self, reg: "ValidatorRegistry",
                        idx: np.ndarray) -> np.ndarray:
        """Land ``idx`` dirty records: scatter their raw rows into the
        columns, re-hash their mini-trees and propagate their paths
        through the record-root tree.  Returns the new subtree root
        words.  H2D = the bucket-padded raw rows."""
        from ..ops.tree_cache import HASH_COUNT
        with LEDGER.attribute("registry_mirror"):
            idx_dev, rows_dev = self._push_rows(reg, idx)
            HASH_COUNT[0] += idx_dev.shape[0] * (8 + len(self.tree.levels)
                                                 - 1)
            root = self.tree.scatter_device(idx_dev,
                                            _record_roots_body(rows_dev))
            self.note_residency()
            return root

    def scatter_cols(self, reg: "ValidatorRegistry",
                     idx: np.ndarray) -> None:
        """Update only the device columns at ``idx`` (no tree propagation)
        — the prelude to :meth:`rebuild` when the dirty fraction or a
        width change makes path-walking the wrong tool."""
        with LEDGER.attribute("registry_mirror"):
            self._push_rows(reg, idx)
            self.note_residency()

    def rebuild(self, n: int) -> np.ndarray:
        """Re-reduce every level from the device columns — zero push."""
        from ..ops.tree_cache import HASH_COUNT

        w = self.width
        HASH_COUNT[0] += 8 * w + (w - 1)
        with LEDGER.attribute("registry_mirror"):
            LEDGER.note_event("rebuilds")
            self.tree.levels = _mirror_levels(self.cols, n)
            self.tree.shared = False
            self.note_residency()
            return self.tree.root_words()

    def ensure_width(self, new_w: int) -> bool:
        """Grow the device columns to ``new_w`` rows (device-side zero pad
        — pad rows are masked at rebuild, their values never hashed).
        Returns True when the width changed (caller must rebuild)."""
        w = self.width
        if new_w <= w:
            return False
        self.cols = {k: torch.cat([v, v.new_zeros((new_w - w,)
                                                   + v.shape[1:])])
                     for k, v in self.cols.items()}
        self.shared = False  # the concat produced buffers only we hold
        return True

    def share(self) -> "DeviceRegistryMirror":
        self.shared = True
        return DeviceRegistryMirror(dict(self.cols), self.tree.share(),
                                    shared=True)


_registry_type_cache: dict[int, type] = {}


def ValidatorRegistryList(limit: int) -> type:
    """SSZ type for ``List[Validator, limit]`` backed by the SoA registry."""
    cls = _registry_type_cache.get(limit)
    if cls is not None:
        return cls

    from ..ssz.core import SszType

    class _RegistryList(SszType):
        ELEM = Validator
        LIMIT = limit

        @classmethod
        def is_fixed_size(cls) -> bool:
            return False

        @classmethod
        def serialize(cls, value) -> bytes:
            if isinstance(value, ValidatorRegistry):
                if len(value) > cls.LIMIT:
                    raise SszError("validator registry exceeds limit")
                return value.to_packed()
            return ValidatorRegistry.from_validators(value).to_packed()

        @classmethod
        def deserialize(cls, data: bytes) -> ValidatorRegistry:
            out = ValidatorRegistry.from_packed(data)
            if len(out) > cls.LIMIT:
                raise SszError("validator registry exceeds limit")
            return out

        @classmethod
        def hash_tree_root(cls, value) -> bytes:
            if not isinstance(value, ValidatorRegistry):
                value = ValidatorRegistry.from_validators(value)
            return value.hash_tree_root(cls.LIMIT)

        @classmethod
        def default(cls) -> ValidatorRegistry:
            return ValidatorRegistry()

    _RegistryList.__name__ = f"ValidatorRegistryList[{limit}]"
    _registry_type_cache[limit] = _RegistryList
    return _RegistryList
