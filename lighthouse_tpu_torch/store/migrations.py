"""Ordered stepwise schema migrations — the role of the reference's
``beacon_node/store/src/metadata.rs`` + ``schema_change.rs``: the
on-disk schema version gates ``HotColdDB`` open, and an out-of-date
store walks ``v(n) → v(n+1)`` steps until it reaches the current
version.  Each step commits in bounded batches (idempotent per row)
with its version bump folded into the LAST batch, so a crash
mid-migration resumes exactly where it left off: the version is
unchanged until the step fully lands, and re-running skips the rows an
interrupted attempt already converted.

Shipped migrations:

- **v1 → v2** (crash-safe store PR): every value row outside
  ``BeaconMeta`` gains the CRC32 checksum frame
  (:func:`..kv.frame_value`), and the ``StoreJournal`` column comes into
  existence (vacuously — v1 stores have no pending import window, the
  old code persisted fork choice only at shutdown).  ``BeaconMeta``
  stays raw: the ``schema`` key must be readable before any framing
  decision, and the slasher parks counters there under its own keys.
"""

from __future__ import annotations

import struct
from typing import Callable, Dict, List

from .kv import DBColumn, KeyValueStore, frame_value

SCHEMA_VERSION = 2

# Columns whose values carry the checksum frame from v2 on.  BeaconMeta
# is deliberately absent (see module docstring); Quarantine holds rows
# exactly as they were found (possibly corrupt — that is the point).
FRAMED_COLUMNS = (
    DBColumn.BeaconBlock, DBColumn.ColdBlock,
    DBColumn.BeaconState, DBColumn.ColdState,
    DBColumn.BeaconStateSummary, DBColumn.BeaconRestorePoint,
    DBColumn.BlobSidecar, DBColumn.StoreJournal,
    DBColumn.OpPool, DBColumn.ForkChoice, DBColumn.BeaconChain,
    DBColumn.PubkeyCache,
)


class MigrationError(ValueError):
    pass


# Rows per commit during a migration step: bounds peak memory and
# transaction size to O(batch) instead of O(store) on a large datadir
# (the cold tier holds every full finalized state).  Steps must be
# IDEMPOTENT per row so a crash between batches resumes cleanly — the
# version bump rides only in the final batch.
MIGRATION_BATCH_ROWS = 512


def _already_framed(value: bytes) -> bool:
    from .kv import unframe_value, ChecksumError
    try:
        unframe_value(value)
        return True
    except ChecksumError:
        return False


def _v1_to_v2(kv: KeyValueStore):
    """Yield op batches wrapping every value row in the checksum frame.
    Idempotent: rows already carrying a valid frame (a crash-interrupted
    earlier attempt) are skipped, so re-running after a mid-migration
    death frames only the remainder."""
    batch: List[tuple] = []
    for col in FRAMED_COLUMNS:
        for key, value in list(kv.iter_column(col)):
            value = bytes(value)
            if _already_framed(value):
                continue
            batch.append(("put", col, bytes(key), frame_value(value)))
            if len(batch) >= MIGRATION_BATCH_ROWS:
                yield batch
                batch = []
    yield batch


_STEPS: Dict[int, Callable] = {
    1: _v1_to_v2,
}


def migrate_schema(kv: KeyValueStore, from_version: int,
                   to_version: int = SCHEMA_VERSION) -> List[int]:
    """Walk the store from ``from_version`` up to ``to_version``.
    Returns the list of step start-versions applied.  Raises
    :class:`MigrationError` when a step is missing (a store too old or
    too new for this build) — the caller surfaces that as a refusal to
    open, never a silent partial read.

    Each step commits in bounded batches with the version bump folded
    into the LAST batch: a crash mid-step leaves the version unchanged
    and the step re-runs idempotently; a crash after the final commit
    has the bump and never re-runs."""
    if from_version > to_version:
        raise MigrationError(
            f"store schema v{from_version} is newer than this build's "
            f"v{to_version} — refusing to downgrade")
    applied: List[int] = []
    for v in range(from_version, to_version):
        step = _STEPS.get(v)
        if step is None:
            raise MigrationError(
                f"no migration path from schema v{v} to v{v + 1}")
        pending: List[tuple] = []
        for batch in step(kv):
            if pending:
                kv.do_atomically(pending)
            pending = list(batch)
        pending.append(("put", DBColumn.BeaconMeta, b"schema",
                        struct.pack("<Q", v + 1)))
        kv.do_atomically(pending)
        applied.append(v)
    return applied
