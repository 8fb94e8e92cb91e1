"""Persistent storage: KV abstraction + hot/cold beacon DB.

Counterpart of ``beacon_node/store``
(``beacon_node/store/src/``): a column-oriented
``KeyValueStore`` seam with in-memory and SQLite backends (the reference
uses LevelDB via FFI — SQLite is this build's embedded native engine), and
``HotColdDB`` with epoch-boundary full states + ``HotStateSummary`` replay
between them.  Crash consistency rides on three seams: checksum-framed
values (:mod:`.kv`), stepwise schema migrations (:mod:`.migrations`) and
the startup reconciliation pass (:mod:`.recovery`).
"""

from .kv import (
    ChecksumError,
    DBColumn,
    KeyValueStore,
    MemoryStore,
    SqliteStore,
    frame_value,
    unframe_value,
)
from .migrations import SCHEMA_VERSION, MigrationError, migrate_schema
from .hot_cold import (
    HotColdDB,
    HotStateSummary,
    JournalEntry,
    StoreCorruption,
    StoreError,
)
from .recovery import (
    RecoveryReport,
    reconcile,
    verify_and_quarantine,
)

__all__ = [
    "ChecksumError", "DBColumn", "KeyValueStore", "MemoryStore",
    "SqliteStore", "frame_value", "unframe_value",
    "SCHEMA_VERSION", "MigrationError", "migrate_schema",
    "HotColdDB", "HotStateSummary", "JournalEntry", "StoreCorruption",
    "StoreError",
    "RecoveryReport", "reconcile", "verify_and_quarantine",
]
