"""Column-oriented key-value store seam.

``KeyValueStore``/``ItemStore`` traits of the reference
(``beacon_node/store/src/lib.rs:169-210`` DBColumn,
``leveldb_store.rs``, ``memory_store.rs``), with two backends:

- :class:`MemoryStore` — dict-backed, for tests and ephemeral harnesses
  (the reference's ``MemoryStore``);
- :class:`SqliteStore` — embedded on-disk engine (the reference links
  LevelDB/C++; SQLite is the embedded native store available here), with
  WAL journaling, batched atomic writes and a durability knob
  (``PRAGMA synchronous`` via ``LIGHTHOUSE_TPU_STORE_SYNC``).

The checksum frame (:func:`frame_value` / :func:`unframe_value`) lives
here so the hot/cold DB, the schema migrations and the recovery scan all
share one encoding: a torn or bit-rotted row must be *detected* at read
time, never silently decoded into a wrong state.
"""

from __future__ import annotations

import sqlite3
import struct
import threading
import zlib
from enum import Enum
from typing import Iterable, Optional, Sequence, Tuple


class DBColumn(str, Enum):
    """`DBColumn` (`store/src/lib.rs:169`) — the subset in use."""
    BeaconMeta = "bma"
    BeaconBlock = "blk"
    BeaconState = "ste"
    BeaconStateSummary = "bss"
    BeaconChain = "bch"
    OpPool = "opo"
    ForkChoice = "frk"
    PubkeyCache = "pkc"
    BeaconRestorePoint = "brp"
    ColdBlock = "cbk"
    ColdState = "cst"
    BlobSidecar = "blb"
    # Crash-consistency additions (schema v2): the per-import journal
    # whose entries bound the restart replay window, and the quarantine
    # column recovery moves checksum-failing rows into (kept for
    # post-mortem instead of deleted).
    StoreJournal = "jnl"
    Quarantine = "qtn"


# -- checksum frame (schema v2) ----------------------------------------------

CHECKSUM_MAGIC = 0xC5
_FRAME_HDR = 5  # magic byte + crc32


class ChecksumError(ValueError):
    """A framed value failed its integrity check (torn write / bit rot)."""


def frame_value(value: bytes) -> bytes:
    """``magic ‖ crc32(value) ‖ value`` — the schema-v2 on-disk frame."""
    value = bytes(value)
    return (bytes([CHECKSUM_MAGIC])
            + struct.pack("<I", zlib.crc32(value) & 0xFFFFFFFF) + value)


def unframe_value(data: bytes) -> bytes:
    """Verify and strip a frame; raises :class:`ChecksumError` on a bad
    magic byte, short row, or CRC mismatch."""
    if len(data) < _FRAME_HDR or data[0] != CHECKSUM_MAGIC:
        raise ChecksumError("missing checksum frame")
    (want,) = struct.unpack_from("<I", data, 1)
    value = bytes(data[_FRAME_HDR:])
    got = zlib.crc32(value) & 0xFFFFFFFF
    if got != want:
        raise ChecksumError(
            f"checksum mismatch: stored {want:#010x} != computed {got:#010x}")
    return value


class KeyValueStore:
    """Abstract column KV API (get/put/delete/iter + atomic batches)."""

    def get(self, column: DBColumn, key: bytes) -> Optional[bytes]:
        raise NotImplementedError

    def put(self, column: DBColumn, key: bytes, value: bytes) -> None:
        raise NotImplementedError

    def delete(self, column: DBColumn, key: bytes) -> None:
        raise NotImplementedError

    def do_atomically(self, ops: Sequence[Tuple[str, DBColumn, bytes,
                                                Optional[bytes]]]) -> None:
        """ops: ("put", col, key, value) | ("delete", col, key, None)."""
        raise NotImplementedError

    def iter_column(self, column: DBColumn) -> Iterable[Tuple[bytes, bytes]]:
        raise NotImplementedError

    def close(self) -> None:
        pass


class MemoryStore(KeyValueStore):
    def __init__(self):
        self._data: dict[tuple[str, bytes], bytes] = {}
        self._lock = threading.Lock()

    def get(self, column, key):
        return self._data.get((column.value, bytes(key)))

    def put(self, column, key, value):
        with self._lock:
            self._data[(column.value, bytes(key))] = bytes(value)

    def delete(self, column, key):
        with self._lock:
            self._data.pop((column.value, bytes(key)), None)

    def do_atomically(self, ops):
        with self._lock:
            for op, col, key, value in ops:
                if op == "put":
                    self._data[(col.value, bytes(key))] = bytes(value)
                elif op == "delete":
                    self._data.pop((col.value, bytes(key)), None)
                else:
                    raise ValueError(op)

    def iter_column(self, column):
        with self._lock:
            items = [(k[1], v) for k, v in self._data.items()
                     if k[0] == column.value]
        return iter(items)


# PRAGMA synchronous levels accepted by the durability knob.  WAL +
# NORMAL is the crash-safe default for *process* death (a committed
# transaction is always intact — exactly the SIGKILL drill's model);
# FULL/EXTRA additionally survive OS crash / power loss at an fsync-per-
# commit cost; OFF trades all durability for speed (ephemeral harnesses).
_SYNC_LEVELS = {"off": "OFF", "normal": "NORMAL", "full": "FULL",
                "extra": "EXTRA"}


class SqliteStore(KeyValueStore):
    """One table per database: (column, key) → value, WAL mode.

    ``sync`` (or env ``LIGHTHOUSE_TPU_STORE_SYNC``) selects the
    ``PRAGMA synchronous`` level — see :data:`_SYNC_LEVELS`.
    """

    def __init__(self, path: str, sync: Optional[str] = None):
        self._conn = sqlite3.connect(path, check_same_thread=False)
        self._lock = threading.Lock()
        from ..common.knobs import knob_choice
        sync = sync.lower() if sync \
            else knob_choice("LIGHTHOUSE_TPU_STORE_SYNC")
        if sync not in _SYNC_LEVELS:
            raise ValueError(
                f"LIGHTHOUSE_TPU_STORE_SYNC={sync!r}: expected one of "
                f"{sorted(_SYNC_LEVELS)}")
        self.sync = sync
        with self._lock:
            self._conn.execute("PRAGMA journal_mode=WAL")
            self._conn.execute(f"PRAGMA synchronous={_SYNC_LEVELS[sync]}")
            self._conn.execute(
                "CREATE TABLE IF NOT EXISTS kv ("
                "col TEXT NOT NULL, key BLOB NOT NULL, value BLOB NOT NULL, "
                "PRIMARY KEY (col, key)) WITHOUT ROWID")
            self._conn.commit()

    def get(self, column, key):
        with self._lock:
            row = self._conn.execute(
                "SELECT value FROM kv WHERE col=? AND key=?",
                (column.value, bytes(key))).fetchone()
        return None if row is None else row[0]

    def put(self, column, key, value):
        with self._lock:
            self._conn.execute(
                "INSERT OR REPLACE INTO kv (col, key, value) VALUES (?,?,?)",
                (column.value, bytes(key), bytes(value)))
            self._conn.commit()

    def delete(self, column, key):
        with self._lock:
            self._conn.execute("DELETE FROM kv WHERE col=? AND key=?",
                               (column.value, bytes(key)))
            self._conn.commit()

    def do_atomically(self, ops):
        with self._lock:
            try:
                for op, col, key, value in ops:
                    if op == "put":
                        self._conn.execute(
                            "INSERT OR REPLACE INTO kv (col, key, value) "
                            "VALUES (?,?,?)", (col.value, bytes(key),
                                               bytes(value)))
                    elif op == "delete":
                        self._conn.execute(
                            "DELETE FROM kv WHERE col=? AND key=?",
                            (col.value, bytes(key)))
                    else:
                        raise ValueError(op)
                self._conn.commit()
            except Exception:
                self._conn.rollback()
                raise

    def iter_column(self, column):
        with self._lock:
            rows = self._conn.execute(
                "SELECT key, value FROM kv WHERE col=?",
                (column.value,)).fetchall()
        return iter(rows)

    def close(self):
        with self._lock:
            self._conn.close()
