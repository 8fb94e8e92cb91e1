"""Two-tier beacon database — ``HotColdDB``
(``beacon_node/store/src/hot_cold_store.rs:48``).

Hot tier: every block; full states at epoch boundaries; a
``HotStateSummary`` {slot, latest_block_root, epoch_boundary_state_root}
for every other state, reconstructed by replaying blocks from the boundary
state (``hot_cold_store.rs:587`` + ``state_processing``'s BlockReplayer).

Cold tier (freezer): on finalization, blocks and periodic restore-point
states (every ``slots_per_restore_point``) migrate to cold columns and the
hot tier is pruned up to the split slot (``migrate.rs`` role, here a
synchronous call).  States between restore points replay from the previous
restore point.

All state/block values are SSZ, tagged with a 1-byte fork id so the right
per-fork container class decodes them.  From schema v2 every value row
outside ``BeaconMeta`` additionally carries a CRC32 checksum frame
(:mod:`.kv`), so a torn or bit-rotted row surfaces as
:class:`StoreCorruption` instead of decoding into a wrong object.

Crash consistency: writers assemble **op lists** (``block_put_ops`` /
``state_put_ops`` / ``blob_put_ops`` / ``journal_put_op``) that the chain
commits as ONE ``do_atomically`` batch per imported block, together with
a ``StoreJournal`` entry (block_root → slot ‖ parent_root) that bounds
the restart replay window (:mod:`.recovery`).
"""

from __future__ import annotations

import struct
import time
from dataclasses import dataclass
from typing import Iterable, List, Optional, Tuple

from ..common import tracing
from ..types.chain_spec import ForkName
from ..state_transition.batch_replay import known_roots_fn
from ..state_transition.block_replayer import BlockReplayer
from .kv import (
    ChecksumError,
    DBColumn,
    KeyValueStore,
    MemoryStore,
    frame_value,
    unframe_value,
)
from .migrations import MigrationError, SCHEMA_VERSION

_FORK_IDS = {f: i for i, f in enumerate(ForkName)}
_FORK_BY_ID = {i: f for f, i in _FORK_IDS.items()}

# Stage dict for the `store` tracing source: the last atomic commit's
# timing/op-count, read by `tracing.record_stages("store")` inside the
# chain's `store_put` span and by any bench row that wants it.
LAST_STORE_TIMINGS: dict = {}

tracing.register_stage_source("store", lambda: LAST_STORE_TIMINGS)


class StoreError(ValueError):
    pass


class StoreCorruption(StoreError):
    """A row failed its integrity check, or a row the persisted chain
    depends on is missing.  ``column``/``key`` locate the damage; the
    message is actionable (what recovery tried, what the operator can
    do)."""

    def __init__(self, message: str, column: Optional[DBColumn] = None,
                 key: Optional[bytes] = None):
        where = ""
        if column is not None:
            where = f" [column={column.value}" + (
                f" key={bytes(key).hex()[:16]}…]" if key is not None else "]")
        super().__init__(message + where)
        self.column = column
        self.key = key


@dataclass
class HotStateSummary:
    """`HotStateSummary` (`hot_cold_store.rs` StoreItem)."""
    slot: int
    latest_block_root: bytes
    epoch_boundary_state_root: bytes

    def encode(self) -> bytes:
        return struct.pack("<Q", self.slot) + self.latest_block_root \
            + self.epoch_boundary_state_root

    @classmethod
    def decode(cls, data: bytes) -> "HotStateSummary":
        if len(data) != 8 + 32 + 32:
            raise StoreError("bad hot state summary encoding")
        return cls(struct.unpack("<Q", data[:8])[0], data[8:40], data[40:72])


@dataclass
class JournalEntry:
    """One import-batch journal record (`StoreJournal` column): enough
    to order a restart replay without decoding the block."""
    block_root: bytes
    slot: int
    parent_root: bytes

    def encode(self) -> bytes:
        return struct.pack("<Q", self.slot) + self.parent_root

    @classmethod
    def decode(cls, block_root: bytes, data: bytes) -> "JournalEntry":
        if len(data) != 8 + 32:
            raise StoreError("bad journal entry encoding")
        return cls(bytes(block_root), struct.unpack("<Q", data[:8])[0],
                   data[8:40])


class HotColdDB:
    """The chain's persistence root object."""

    def __init__(self, kv: KeyValueStore, preset, spec, T,
                 slots_per_restore_point: int | None = None):
        self.kv = kv
        self.preset = preset
        self.spec = spec
        self.T = T
        self.sprp = slots_per_restore_point or (
            2 * preset.SLOTS_PER_EPOCH)
        self.split_slot = 0
        self._load_meta()

    @classmethod
    def memory(cls, preset, spec, T) -> "HotColdDB":
        return cls(MemoryStore(), preset, spec, T)

    # -- framed value plumbing -----------------------------------------------

    def _get_value(self, column: DBColumn, key: bytes) -> Optional[bytes]:
        """Read + verify one framed row.  Raises :class:`StoreCorruption`
        on a failed check — callers that can *recover* from corruption
        (the startup reconciliation pass) catch it; hot-path callers must
        not decode garbage."""
        data = self.kv.get(column, key)
        if data is None:
            return None
        try:
            return unframe_value(data)
        except ChecksumError as e:
            raise StoreCorruption(
                f"corrupt row: {e}; run startup recovery "
                "(BeaconChain.from_store) to quarantine it, or restore the "
                "datadir from a checkpoint", column, key) from e

    def _put_op(self, column: DBColumn, key: bytes,
                value: bytes) -> tuple:
        return ("put", column, bytes(key), frame_value(value))

    def do_atomically(self, ops: List[tuple]) -> None:
        """Commit one batch through the KV layer, recording the commit
        timing/op count in :data:`LAST_STORE_TIMINGS` (the ``store``
        tracing stage source)."""
        t0 = time.perf_counter()
        self.kv.do_atomically(ops)
        LAST_STORE_TIMINGS.clear()
        LAST_STORE_TIMINGS.update({
            "commit_ms": (time.perf_counter() - t0) * 1e3,
            "ops": len(ops),
        })

    # -- metadata ------------------------------------------------------------

    def _load_meta(self) -> None:
        v = self.kv.get(DBColumn.BeaconMeta, b"schema")
        if v is None:
            self.kv.put(DBColumn.BeaconMeta, b"schema",
                        struct.pack("<Q", SCHEMA_VERSION))
            self.schema_migrated_from: Optional[int] = None
        else:
            ver = struct.unpack("<Q", v)[0]
            if ver != SCHEMA_VERSION:
                from .migrations import migrate_schema
                try:
                    applied = migrate_schema(self.kv, ver, SCHEMA_VERSION)
                except MigrationError as e:
                    raise StoreError(str(e)) from e
                self.schema_migrated_from = ver if applied else None
            else:
                self.schema_migrated_from = None
        sp = self.kv.get(DBColumn.BeaconMeta, b"split")
        if sp is not None:
            if len(sp) != 8:
                raise StoreCorruption(
                    "split meta is not a u64 — the store metadata is "
                    "damaged; restore the datadir from a checkpoint",
                    DBColumn.BeaconMeta, b"split")
            self.split_slot = struct.unpack("<Q", sp)[0]

    def _store_meta(self) -> None:
        self.kv.put(DBColumn.BeaconMeta, b"split",
                    struct.pack("<Q", self.split_slot))

    def _split_meta_op(self, split_slot: int) -> tuple:
        """The split write as a batch op — folded into the freezer
        migration's atomic batch so a crash can never strand the split
        behind (or ahead of) the moved rows."""
        return ("put", DBColumn.BeaconMeta, b"split",
                struct.pack("<Q", split_slot))

    # -- blocks --------------------------------------------------------------

    def block_put_ops(self, block_root: bytes, signed_block) -> List[tuple]:
        fork = self.T.fork_of_block(signed_block)
        return [self._put_op(
            DBColumn.BeaconBlock, block_root,
            bytes([_FORK_IDS[fork]]) + signed_block.encode())]

    def put_block(self, block_root: bytes, signed_block) -> None:
        self.do_atomically(self.block_put_ops(block_root, signed_block))

    def get_block(self, block_root: bytes):
        for col in (DBColumn.BeaconBlock, DBColumn.ColdBlock):
            data = self._get_value(col, block_root)
            if data is not None:
                fork = _FORK_BY_ID[data[0]]
                return self.T.signed_block_cls(fork).deserialize(data[1:])
        return None

    # -- blob sidecars (Deneb data availability) -----------------------------

    def blob_put_ops(self, block_root: bytes, index: int,
                     sidecar) -> List[tuple]:
        """Keyed block_root ‖ index (`hot_cold_store.rs` put_blobs; this
        stores sidecars individually so by-root requests for a subset
        avoid decoding the full 6-blob bundle)."""
        return [self._put_op(DBColumn.BlobSidecar,
                             bytes(block_root) + bytes([index]),
                             type(sidecar).serialize(sidecar))]

    def put_blob_sidecar(self, block_root: bytes, index: int,
                         sidecar) -> None:
        self.do_atomically(self.blob_put_ops(block_root, index, sidecar))

    def get_blob_sidecar(self, block_root: bytes, index: int):
        data = self._get_value(DBColumn.BlobSidecar,
                               bytes(block_root) + bytes([index]))
        if data is None:
            return None
        return self.T.BlobSidecar.deserialize(data)

    def get_blob_sidecars(self, block_root: bytes) -> List:
        """All stored sidecars for a block, ascending index."""
        out = []
        for index in range(self.preset.MAX_BLOBS_PER_BLOCK):
            sc = self.get_blob_sidecar(block_root, index)
            if sc is not None:
                out.append(sc)
        return out

    # -- import journal ------------------------------------------------------

    def journal_put_op(self, block_root: bytes, slot: int,
                       parent_root: bytes) -> tuple:
        """The import batch's journal record: after the last fork-choice
        snapshot, these entries are exactly the blocks a restart must
        replay (`fork_revert.rs` / reconstruct-head role)."""
        return self._put_op(
            DBColumn.StoreJournal, block_root,
            JournalEntry(bytes(block_root), int(slot),
                         bytes(parent_root)).encode())

    def journal_entries(self) -> List[JournalEntry]:
        """Decode every journal row, slot-ascending.  Corrupt entries
        surface as :class:`StoreCorruption` (recovery quarantines them
        first)."""
        out = []
        for key, data in list(self.kv.iter_column(DBColumn.StoreJournal)):
            try:
                value = unframe_value(data)
            except ChecksumError as e:
                raise StoreCorruption(f"corrupt journal entry: {e}",
                                      DBColumn.StoreJournal, key) from e
            out.append(JournalEntry.decode(key, value))
        out.sort(key=lambda j: (j.slot, j.block_root))
        return out

    def journal_clear_ops(self) -> List[tuple]:
        """Delete ops for every journal row — folded into the atomic
        fork-choice persist batch, so the journal always holds exactly
        the imports since the LAST durable snapshot."""
        return [("delete", DBColumn.StoreJournal, bytes(key), None)
                for key, _ in list(self.kv.iter_column(
                    DBColumn.StoreJournal))]

    # -- states --------------------------------------------------------------

    def state_put_ops(self, state_root: bytes, state,
                      latest_block_root: bytes) -> List[tuple]:
        """Full state at epoch boundaries, summary otherwise
        (`store_hot_state`, `hot_cold_store.rs:560-610`)."""
        slot = int(state.slot)
        if slot % self.preset.SLOTS_PER_EPOCH == 0:
            return self._full_state_ops(DBColumn.BeaconState, state_root,
                                        state)
        boundary_slot = (slot // self.preset.SLOTS_PER_EPOCH
                         * self.preset.SLOTS_PER_EPOCH)
        boundary_root = bytes(state.state_roots.get(
            boundary_slot % self.preset.SLOTS_PER_HISTORICAL_ROOT))
        if self.kv.get(DBColumn.BeaconState, boundary_root) is None:
            # The epoch boundary was a skipped slot (no block → no stored
            # post-state there): a summary would be unloadable, so store
            # this state fully instead (self-contained).
            return self._full_state_ops(DBColumn.BeaconState, state_root,
                                        state)
        summary = HotStateSummary(slot, latest_block_root, boundary_root)
        return [self._put_op(DBColumn.BeaconStateSummary, state_root,
                             summary.encode())]

    def put_state(self, state_root: bytes, state,
                  latest_block_root: bytes) -> None:
        self.do_atomically(self.state_put_ops(state_root, state,
                                              latest_block_root))

    def _full_state_ops(self, col: DBColumn, state_root: bytes,
                        state) -> List[tuple]:
        fork = self.T.fork_of_state(state)
        return [self._put_op(col, state_root,
                             bytes([_FORK_IDS[fork]]) + state.encode())]

    def _get_full_state(self, col: DBColumn, state_root: bytes):
        data = self._get_value(col, state_root)
        if data is None:
            return None
        fork = _FORK_BY_ID[data[0]]
        return self.T.state_cls(fork).deserialize(data[1:])

    def get_state(self, state_root: bytes):
        """Full state, summary-replay, or restore-point replay
        (`load_hot_state` / `load_cold_state`)."""
        state = self._get_full_state(DBColumn.BeaconState, state_root)
        if state is not None:
            return state
        state = self._get_full_state(DBColumn.ColdState, state_root)
        if state is not None:
            return state
        summary_data = self._get_value(DBColumn.BeaconStateSummary,
                                       state_root)
        if summary_data is not None:
            return self._replay_from_summary(
                HotStateSummary.decode(summary_data))
        return None

    def _block_chain_to(self, latest_block_root: bytes,
                        after_slot: int) -> List:
        """Blocks (ascending) strictly after ``after_slot`` ending at
        ``latest_block_root``, following parent pointers."""
        return [b for _, b in self._block_chain_roots_to(
            latest_block_root, after_slot)]

    def _block_chain_roots_to(self, latest_block_root: bytes,
                              after_slot: int) -> List[Tuple[bytes, object]]:
        """(root, block) pairs, ascending — the root is the KV key the
        walk fetched the block under, so callers never re-derive it via
        ``tree_hash_root()``."""
        chain = []
        root = latest_block_root
        while True:
            block = self.get_block(root)
            if block is None or int(block.message.slot) <= after_slot:
                break
            chain.append((bytes(root), block))
            root = bytes(block.message.parent_root)
        chain.reverse()
        return chain

    def _replay_from_summary(self, summary: HotStateSummary):
        base = self._get_full_state(DBColumn.BeaconState,
                                    summary.epoch_boundary_state_root)
        if base is None:
            # Boundary state may have migrated to the freezer.
            base = self._get_full_state(DBColumn.ColdState,
                                        summary.epoch_boundary_state_root)
        if base is None:
            raise StoreError("missing epoch boundary state for summary")
        blocks = self._block_chain_to(summary.latest_block_root,
                                      int(base.slot))
        # Known roots: the stored chain's blocks already carry their
        # (import-verified) post-state roots, so the replay skips every
        # per-slot tree hash except at empty slots past the last block
        # (`block_replayer.rs` state_root_iter).
        replayer = BlockReplayer(base, self.preset, self.spec, self.T,
                                 state_root_fn=known_roots_fn(blocks))
        return replayer.apply_blocks(blocks, target_slot=summary.slot)

    # -- finalization migration (hot → cold) ---------------------------------

    def migrate_to_cold(self, finalized_slot: int,
                        finalized_block_root: bytes) -> None:
        """Move finalized blocks to the freezer, keep restore-point states,
        prune hot summaries/states below the split
        (`migrate.rs` + `hot_cold_store.rs` migrate_database).

        ONE atomic batch, split meta included: a crash anywhere inside the
        migration leaves either the old store or the new one, never a
        half-moved freezer with a stale (or advanced) split."""
        if finalized_slot <= self.split_slot:
            return
        # Blocks along the finalized chain → cold, keyed by the root the
        # chain walk already fetched them under (no tree_hash_root()).
        ops = []
        for root, signed in self._block_chain_roots_to(
                finalized_block_root, -1):
            if int(signed.message.slot) >= finalized_slot:
                continue
            data = self.kv.get(DBColumn.BeaconBlock, root)
            if data is not None:
                ops.append(("put", DBColumn.ColdBlock, root, data))
                ops.append(("delete", DBColumn.BeaconBlock, root, None))
        # Hot full states below the split move to the freezer wholesale
        # (denser than the reference's sparse restore points + replay, but
        # every previously-stored state stays loadable — the summaries are
        # kept, and their boundary lookups fall through to the cold tier).
        for state_root, data in list(self.kv.iter_column(DBColumn.BeaconState)):
            state_slot = self._peek_state_slot(data)
            if state_slot < finalized_slot:
                ops.append(("put", DBColumn.ColdState, state_root, data))
                if state_slot % self.sprp == 0:
                    ops.append(self._put_op(DBColumn.BeaconRestorePoint,
                                            struct.pack("<Q", state_slot),
                                            state_root))
                ops.append(("delete", DBColumn.BeaconState, state_root, None))
        ops.append(self._split_meta_op(finalized_slot))
        self.do_atomically(ops)
        self.split_slot = finalized_slot

    def _peek_state_slot(self, data: bytes) -> int:
        # BeaconState SSZ layout: genesis_time (8) + genesis_validators_root
        # (32) + slot (8) — fixed offsets for every fork.  ``data`` is the
        # raw (framed) row from iter_column; verify + strip first.
        try:
            value = unframe_value(data)
        except ChecksumError as e:
            raise StoreCorruption(f"corrupt state row: {e}",
                                  DBColumn.BeaconState) from e
        return struct.unpack("<Q", value[1 + 40:1 + 48])[0]

    # -- persisted singletons (fork choice, op pool, chain) ------------------

    def item_put_op(self, column: DBColumn, key: bytes,
                    value: bytes) -> tuple:
        """Framed put op for a persisted singleton — callers fold it into
        their own atomic batches (the chain's ``persist()``)."""
        return self._put_op(column, key, value)

    def put_item(self, column: DBColumn, key: bytes, value: bytes) -> None:
        self.do_atomically([self._put_op(column, key, value)])

    def get_item(self, column: DBColumn, key: bytes) -> Optional[bytes]:
        return self._get_value(column, key)
