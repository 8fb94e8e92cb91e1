"""Startup reconciliation — the restart path's self-healing pass
(the roles of the reference's ``fork_revert.rs`` head reconstruction and
``hot_cold_store`` consistency checks, extended with checksum-driven
quarantine).

A node that died mid-import restarts from whatever subset of its atomic
batches committed.  Because every import is ONE batch (block + state/
summary + sidecars + journal entry) and fork choice persists at every
finalization, the damage surface is small and enumerable, and this pass
walks it in order:

1. **verify** — every framed row's CRC is checked; failing rows move to
   the ``Quarantine`` column (kept for post-mortem, invisible to normal
   reads) instead of being silently decoded.
2. **walk** — every block root in the persisted fork-choice snapshot
   must still load from the block columns; a miss means the snapshot
   depends on data that no longer exists → :class:`StoreCorruption`
   with an actionable message.
3. **replay** — journal entries (and any hot blocks the snapshot
   missed) newer than the snapshot re-import into fork choice in slot
   order, bringing the in-memory head back to exactly where the crashed
   process was.
4. **de-orphan** — partial imports (a journaled block whose state was
   quarantined, a block whose parent never made it) are quarantined so
   they cannot shadow a future re-import of the same root.

When the fork-choice blob itself is missing or corrupt the chain falls
back to a **full rebuild**: a fresh genesis-anchored fork choice replays
every stored block (cold then hot) in slot order.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Tuple

from .kv import ChecksumError, DBColumn, unframe_value
from .hot_cold import HotColdDB, StoreCorruption, StoreError

# Boot-time CRC scan scope: the hot tier, the persisted singletons and
# the journal — everything stages 2-4 will dereference.  The COLD tier
# (full finalized history, O(chain length)) is deliberately absent:
# cold rows are verified lazily at read time (`_get_value` raises
# StoreCorruption), and walking them here would make every restart
# O(total history) — exactly the downtime this PR exists to bound.
BOOT_SCAN_COLUMNS = (
    DBColumn.BeaconBlock, DBColumn.BeaconState,
    DBColumn.BeaconStateSummary, DBColumn.BeaconRestorePoint,
    DBColumn.BlobSidecar, DBColumn.StoreJournal,
    DBColumn.OpPool, DBColumn.ForkChoice, DBColumn.BeaconChain,
    DBColumn.PubkeyCache,
)


@dataclass
class QuarantinedRow:
    column: DBColumn
    key: bytes
    reason: str


@dataclass
class RecoveryReport:
    """What the reconciliation pass found and did."""
    quarantined: List[QuarantinedRow] = field(default_factory=list)
    orphans_removed: List[bytes] = field(default_factory=list)
    replayed: List[bytes] = field(default_factory=list)
    skipped_stale: int = 0
    rebuilt_fork_choice: bool = False
    notes: List[str] = field(default_factory=list)

    def summary(self) -> dict:
        return {
            "quarantined": len(self.quarantined),
            "orphans_removed": len(self.orphans_removed),
            "replayed_blocks": len(self.replayed),
            "skipped_stale": self.skipped_stale,
            "rebuilt_fork_choice": self.rebuilt_fork_choice,
            "notes": list(self.notes),
        }


def _quarantine_key(column: DBColumn, key: bytes) -> bytes:
    return column.value.encode() + b":" + bytes(key)


def verify_and_quarantine(store: HotColdDB) -> RecoveryReport:
    """Stage 1: CRC-walk the boot-relevant columns (hot tier +
    singletons + journal — see :data:`BOOT_SCAN_COLUMNS`); move failing
    rows into ``Quarantine`` (one atomic batch).  After this pass,
    normal reads see corrupt rows as *absent*, so later stages reason
    about missing data only.  Cold-tier rows keep their lazy read-time
    CRC check instead of a boot walk."""
    report = RecoveryReport()
    ops: List[tuple] = []
    for col in BOOT_SCAN_COLUMNS:
        for key, data in list(store.kv.iter_column(col)):
            try:
                unframe_value(data)
            except ChecksumError as e:
                ops.append(("put", DBColumn.Quarantine,
                            _quarantine_key(col, key), bytes(data)))
                ops.append(("delete", col, bytes(key), None))
                report.quarantined.append(
                    QuarantinedRow(col, bytes(key), str(e)))
    if ops:
        store.kv.do_atomically(ops)
    return report


def _orphan_ops(store: HotColdDB, block_root: bytes,
                state_root: Optional[bytes]) -> List[tuple]:
    """Quarantine a partial import: block, its journal entry, its
    summary/state rows and any sidecars move out of the live columns so
    a later re-import of the same root starts clean."""
    ops: List[tuple] = []
    for col in (DBColumn.BeaconBlock, DBColumn.StoreJournal):
        data = store.kv.get(col, block_root)
        if data is not None:
            ops.append(("put", DBColumn.Quarantine,
                        _quarantine_key(col, block_root), data))
        ops.append(("delete", col, bytes(block_root), None))
    if state_root:
        for col in (DBColumn.BeaconState, DBColumn.BeaconStateSummary):
            data = store.kv.get(col, state_root)
            if data is not None:
                ops.append(("put", DBColumn.Quarantine,
                            _quarantine_key(col, state_root), data))
                ops.append(("delete", col, bytes(state_root), None))
    for index in range(store.preset.MAX_BLOBS_PER_BLOCK):
        key = bytes(block_root) + bytes([index])
        data = store.kv.get(DBColumn.BlobSidecar, key)
        if data is not None:
            ops.append(("put", DBColumn.Quarantine,
                        _quarantine_key(DBColumn.BlobSidecar, key), data))
            ops.append(("delete", DBColumn.BlobSidecar, key, None))
    return ops


def _pending_blocks(store: HotColdDB, known: set,
                    include_cold: bool) -> List[Tuple[int, bytes]]:
    """(slot, root) of every stored block NOT in ``known``, slot-
    ascending: the journal entries plus — belt-and-braces, and the only
    source on a just-migrated v1 store or a rebuild — a scan of the
    block columns themselves."""
    pending: dict[bytes, int] = {}
    for entry in store.journal_entries():
        if entry.block_root not in known:
            pending[entry.block_root] = entry.slot
    cols = (DBColumn.ColdBlock, DBColumn.BeaconBlock) if include_cold \
        else (DBColumn.BeaconBlock,)
    for col in cols:
        for key, _data in list(store.kv.iter_column(col)):
            root = bytes(key)
            if root in known or root in pending:
                continue
            block = store.get_block(root)
            if block is None:
                continue  # quarantined between scan and read
            pending[root] = int(block.message.slot)
    return sorted(((slot, root) for root, slot in pending.items()),
                  key=lambda t: (t[0], t[1]))


def _segment_replay_cache(store: HotColdDB, chain,
                          pending: List[Tuple[int, bytes]]) -> dict:
    """Batched rebuild acceleration: group the pending blocks into
    parent-linked segments and prime ``{block_root: post_state}`` for
    each multi-block segment with ONE :func:`replay_states` window from
    the segment's base state, instead of one ``store.get_state`` —
    potentially an O(epoch) summary replay EACH — per block.

    Purely a cache: the reconcile loop's orphan decisions still key off
    the store's own rows (a computed state never resurrects a partial
    import whose state row is gone), and any segment whose base state
    won't load simply falls back to the per-block path."""
    from ..state_transition.batch_replay import (batch_replay_enabled,
                                                 replay_states)
    if not pending or not batch_replay_enabled(len(pending)):
        return {}
    blocks: dict[bytes, object] = {}
    for _slot, root in pending:
        b = store.get_block(root)
        if b is not None:
            blocks[root] = b
    # Greedy parent-linking in slot order; a fork's second child starts
    # its own segment (its base state comes from the cache when the
    # sibling's segment already computed it).
    segments: List[Tuple[bytes, List[Tuple[bytes, object]]]] = []
    tips: dict[bytes, tuple] = {}
    for _slot, root in pending:
        b = blocks.get(root)
        if b is None:
            continue
        parent = bytes(b.message.parent_root)
        seg = tips.pop(parent, None)
        if seg is None:
            seg = (parent, [])
            segments.append(seg)
        seg[1].append((root, b))
        tips[root] = seg
    cache: dict = {}
    for base_root, pairs in segments:
        if len(pairs) < 2:
            continue
        base_state = cache.get(base_root)
        if base_state is None:
            try:
                if bytes(base_root) == bytes(chain.genesis_block_root):
                    base_state = store.get_state(
                        bytes(chain.genesis_state_root))
                else:
                    base_block = store.get_block(base_root)
                    if base_block is None:
                        continue
                    base_state = store.get_state(
                        bytes(base_block.message.state_root))
            except (StoreCorruption, StoreError):
                base_state = None
        if base_state is None:
            continue
        try:
            cache.update(replay_states(base_state, pairs, store.preset,
                                       store.spec, store.T))
        except Exception:
            # Segment won't replay (e.g. a slot gap the stored chain
            # can't bridge) — the per-block loop handles its blocks.
            continue
    return cache


def _state_row_present(store: HotColdDB, state_root: bytes) -> bool:
    """Does the store hold ANY row for this state root (full, cold or
    summary)?  The exact set :meth:`HotColdDB.get_state` consults — the
    orphan rule stays keyed to store contents even when a replay cache
    can synthesize the state."""
    return any(store._get_value(col, state_root) is not None
               for col in (DBColumn.BeaconState, DBColumn.ColdState,
                           DBColumn.BeaconStateSummary))


def reconcile(store: HotColdDB, chain, report: RecoveryReport,
              *, genesis_root: bytes) -> RecoveryReport:
    """Stages 2-4 against a constructed chain (its ``fork_choice`` is
    the decoded snapshot, or a fresh genesis anchor on a rebuild)."""
    fc = chain.fork_choice

    # Stage 2: the snapshot's nodes must be backed by loadable blocks.
    # A CRC-verified raw read suffices (stage 1 already quarantined
    # corrupt rows) — no need to SSZ-decode every block per boot.
    for root in list(fc.proto.indices):
        if bytes(root) == bytes(genesis_root):
            continue
        if store._get_value(DBColumn.BeaconBlock, root) is None and \
                store._get_value(DBColumn.ColdBlock, root) is None:
            raise StoreCorruption(
                "fork-choice snapshot references a block the store no "
                "longer holds (quarantined or lost) — restore the datadir "
                "from a backup or resync from a checkpoint",
                DBColumn.BeaconBlock, root)

    # Historical floor: blocks at or below the fork-choice anchor's slot
    # can never be orphaned partial imports — they are checkpoint-sync
    # BACKFILL (stored below the anchor, parents deliberately outside
    # fork choice) or pre-finalization fork debris below the split.
    try:
        anchor_slot = fc.block_slot(genesis_root)
    except Exception:
        anchor_slot = 0
    floor = max(int(anchor_slot), int(store.split_slot))

    # Stage 3+4: replay the post-snapshot window, de-orphaning partial
    # imports as they surface.
    known = set(bytes(r) for r in fc.proto.indices)
    orphan_ops: List[tuple] = []
    pending = _pending_blocks(store, known, report.rebuilt_fork_choice)
    # Cold-then-hot rebuild at device rate: prime the per-block states
    # with one batched window per parent-linked segment (the per-block
    # ``get_state`` below degenerates to an O(epoch) summary replay per
    # non-boundary block).
    replay_cache = _segment_replay_cache(store, chain, pending)
    if replay_cache:
        report.notes.append(
            f"batched replay primed {len(replay_cache)} rebuild states")
    for slot, root in pending:
        block = store.get_block(root)
        if block is None:
            # Journal entry whose block row was quarantined.
            orphan_ops += _orphan_ops(store, root, None)
            report.orphans_removed.append(root)
            continue
        parent = bytes(block.message.parent_root)
        if parent not in fc.proto.indices:
            if slot <= floor:
                report.skipped_stale += 1
                continue
            orphan_ops += _orphan_ops(
                store, root, bytes(block.message.state_root))
            report.orphans_removed.append(root)
            continue
        state = None
        if root in replay_cache and \
                _state_row_present(store, bytes(block.message.state_root)):
            state = replay_cache[root]
        if state is None:
            try:
                state = store.get_state(bytes(block.message.state_root))
            except (StoreCorruption, StoreError):
                state = None
        if state is None:
            orphan_ops += _orphan_ops(
                store, root, bytes(block.message.state_root))
            report.orphans_removed.append(root)
            continue
        chain._replay_imported_block(block, root, state)
        known.add(root)
        report.replayed.append(root)
    if orphan_ops:
        store.kv.do_atomically(orphan_ops)
    return report
