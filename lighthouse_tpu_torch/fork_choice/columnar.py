"""Columnar proto-array data plane — flat node columns + batched votes.

The host :class:`~.proto_array.ProtoArrayForkChoice` walks a python list of
``ProtoNode`` objects twice per head recompute; at mainnet shapes (16k
unfinalized nodes, 2M validators) that walk is the last per-slot host loop
(PAPER.md layer 4).  This module holds the same state as **flat columns**
sized by the node count

    slot · parent · depth · justified/finalized epoch+root · execution
    status · weight · best_child · best_descendant · root bytes

plus a **level schedule**: ``depth`` is maintained on insert (parents
always precede children), so the backward weight pass and the best-child
sweep become one masked vector step per tree level instead of one python
iteration per node — the same columnar approach as the vectorized block
transition and the device-resident registry.

Votes are a whole-registry column triple (``current``/``next``/
``next_epoch``) fronted by a :class:`VoteBuffer`: per-attestation
``process_attestation`` calls append (validator, target-node, epoch)
triples, and one flush per slot merges them with the host's
latest-message rule (strictly-greater epoch wins; first arrival wins
ties) as a lexsort + segment-take instead of a per-validator loop.
Equivocations drop later votes at the buffer door, so a vote pushed
*before* the slashing still lands and one pushed *after* is blocked —
bit-identical to the host's call-order semantics.

The level sweep's cost is ``O(depth)`` vector steps, which wins on bushy
trees (healthy finality: a few epochs of forked heads) and loses badly on
chain-shaped ones (long non-finality: depth ≈ node count).
:func:`apply_scores` therefore dispatches adaptively: the masked level
sweep for shallow trees, :func:`apply_scores_walk` — an exact O(n)
python port of the host's two reverse walks over the columns — for deep
ones.  Both produce bit-identical results (fuzzed against each other and
the host oracle).

Everything here is pure numpy; :mod:`.device_proto_array` mirrors the hot
columns on the device and runs the delta/propagation passes there as one
round of torch ops.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np

from .proto_array import (
    EXEC_INVALID,
    EXEC_IRRELEVANT,
    ProtoArrayError,
    ProtoNode,
)

def _as_root_row(root: bytes) -> np.ndarray:
    return np.frombuffer(bytes(root), dtype=np.uint8)


class NodeColumns:
    """Append-only struct-of-arrays node table with a level schedule."""

    _ROOT_FIELDS = ("roots", "state_roots", "justified_roots",
                    "finalized_roots")

    def __init__(self, capacity: int = 64):
        cap = max(int(capacity), 8)
        self.n = 0
        self.slot = np.zeros(cap, np.int64)
        self.parent = np.full(cap, -1, np.int32)
        self.depth = np.zeros(cap, np.int32)
        self.justified_epoch = np.zeros(cap, np.int64)
        self.finalized_epoch = np.zeros(cap, np.int64)
        self.exec_status = np.full(cap, EXEC_IRRELEVANT, np.int8)
        self.weight = np.zeros(cap, np.int64)
        self.best_child = np.full(cap, -1, np.int32)
        self.best_desc = np.full(cap, -1, np.int32)
        self.roots = np.zeros((cap, 32), np.uint8)
        self.state_roots = np.zeros((cap, 32), np.uint8)
        self.justified_roots = np.zeros((cap, 32), np.uint8)
        self.finalized_roots = np.zeros((cap, 32), np.uint8)
        self.exec_hash: List[Optional[bytes]] = []
        self.indices: Dict[bytes, int] = {}
        # level schedule: node indices grouped by depth (python lists while
        # building, np arrays served cached)
        self._levels: List[List[int]] = []
        self._levels_np: Optional[List[np.ndarray]] = None
        self._ranks: Optional[np.ndarray] = None
        self._zero_root: Optional[np.ndarray] = None

    # -- growth --------------------------------------------------------------

    def _ensure(self, n: int) -> None:
        cap = self.slot.shape[0]
        if n <= cap:
            return
        new = max(cap * 2, n)
        for name in ("slot", "parent", "depth", "justified_epoch",
                     "finalized_epoch", "exec_status", "weight",
                     "best_child", "best_desc"):
            old = getattr(self, name)
            grown = np.empty(new, old.dtype)
            grown[:cap] = old
            grown[cap:] = -1 if name in ("parent", "best_child",
                                         "best_desc") else 0
            setattr(self, name, grown)
        for name in self._ROOT_FIELDS:
            old = getattr(self, name)
            grown = np.zeros((new, 32), np.uint8)
            grown[:cap] = old
            setattr(self, name, grown)

    def append(self, *, slot: int, root: bytes, parent: int,
               state_root: bytes, justified_epoch: int, justified_root: bytes,
               finalized_epoch: int, finalized_root: bytes,
               execution_status: int,
               execution_block_hash: Optional[bytes]) -> int:
        i = self.n
        self._ensure(i + 1)
        self.slot[i] = slot
        self.parent[i] = parent
        self.depth[i] = 0 if parent < 0 else int(self.depth[parent]) + 1
        self.justified_epoch[i] = justified_epoch
        self.finalized_epoch[i] = finalized_epoch
        self.exec_status[i] = execution_status
        self.weight[i] = 0
        self.best_child[i] = -1
        self.best_desc[i] = -1
        self.roots[i] = _as_root_row(root)
        self.state_roots[i] = _as_root_row(state_root)
        self.justified_roots[i] = _as_root_row(justified_root)
        self.finalized_roots[i] = _as_root_row(finalized_root)
        self.exec_hash.append(execution_block_hash)
        self.indices[bytes(root)] = i
        d = int(self.depth[i])
        while len(self._levels) <= d:
            self._levels.append([])
        self._levels[d].append(i)
        self.n = i + 1
        self._levels_np = None
        self._ranks = None
        self._zero_root = None
        return i

    # -- derived (cached) columns -------------------------------------------

    def levels(self) -> List[np.ndarray]:
        if self._levels_np is None:
            self._levels_np = [np.asarray(lv, np.int64)
                               for lv in self._levels]
        return self._levels_np

    def max_depth(self) -> int:
        return len(self._levels) - 1

    def ranks(self) -> np.ndarray:
        """Per-node rank of the block root under bytes-lexicographic order
        (the host tie-break ``child.root >= best.root``); rank order
        preserves every comparison the host makes."""
        if self._ranks is None:
            n = self.n
            flat = np.ascontiguousarray(self.roots[:n]).view("S32").ravel()
            order = np.argsort(flat, kind="stable")
            ranks = np.empty(n, np.int64)
            ranks[order] = np.arange(n, dtype=np.int64)
            self._ranks = ranks
        return self._ranks

    def zero_root_mask(self) -> np.ndarray:
        if self._zero_root is None:
            self._zero_root = ~self.roots[:self.n].any(axis=1)
        return self._zero_root

    def viable_mask(self, justified_checkpoint: Tuple[int, bytes],
                    finalized_checkpoint: Tuple[int, bytes]) -> np.ndarray:
        """`_viable_for_head` over all nodes at once (`proto_array.rs:897`):
        checkpoint-epoch AND root must match (epoch 0 passes all), and
        invalid-payload nodes are never viable."""
        n = self.n
        je, jr = justified_checkpoint
        fe, fr = finalized_checkpoint
        if je == 0:
            correct_j = np.ones(n, bool)
        else:
            correct_j = ((self.justified_epoch[:n] == je)
                         & (self.justified_roots[:n]
                            == _as_root_row(jr)).all(axis=1))
        if fe == 0:
            correct_f = np.ones(n, bool)
        else:
            correct_f = ((self.finalized_epoch[:n] == fe)
                         & (self.finalized_roots[:n]
                            == _as_root_row(fr)).all(axis=1))
        return (correct_j & correct_f
                & (self.exec_status[:n] != EXEC_INVALID))

    def root_bytes(self, i: int) -> bytes:
        return self.roots[i].tobytes()

    def export_nodes(self) -> List[ProtoNode]:
        """Materialize the host ``ProtoNode`` view (persistence/debug)."""
        out = []
        for i in range(self.n):
            out.append(ProtoNode(
                slot=int(self.slot[i]), root=self.root_bytes(i),
                parent=None if self.parent[i] < 0 else int(self.parent[i]),
                state_root=self.state_roots[i].tobytes(),
                justified_epoch=int(self.justified_epoch[i]),
                justified_root=self.justified_roots[i].tobytes(),
                finalized_epoch=int(self.finalized_epoch[i]),
                finalized_root=self.finalized_roots[i].tobytes(),
                execution_status=int(self.exec_status[i]),
                execution_block_hash=self.exec_hash[i],
                weight=int(self.weight[i]),
                best_child=None if self.best_child[i] < 0
                else int(self.best_child[i]),
                best_descendant=None if self.best_desc[i] < 0
                else int(self.best_desc[i])))
        return out

class VoteBuffer:
    """Whole-registry latest-message store + per-slot vote buffer.

    ``current``/``next``/``next_epoch`` mirror the host ``VoteTracker``
    columns exactly; buffered (validator, node, epoch) triples carry an
    arrival counter so a single :meth:`flush` reproduces the host's
    sequential ``process_attestation`` fold bit-for-bit (see module
    docstring for the equivalence argument)."""

    def __init__(self, n: int = 0):
        self.current = np.full(n, -1, np.int32)
        self.next = np.full(n, -1, np.int32)
        self.next_epoch = np.zeros(n, np.uint64)
        self.equivocating: set[int] = set()
        self._buf_val: List[np.ndarray] = []
        self._buf_node: List[np.ndarray] = []
        self._buf_epoch: List[np.ndarray] = []
        self._buf_arr: List[np.ndarray] = []
        self._arrival = 0

    def __len__(self) -> int:
        return self.current.shape[0]

    def grow(self, n: int) -> None:
        old = self.current.shape[0]
        if n <= old:
            return
        self.current = np.concatenate(
            [self.current, np.full(n - old, -1, np.int32)])
        self.next = np.concatenate(
            [self.next, np.full(n - old, -1, np.int32)])
        self.next_epoch = np.concatenate(
            [self.next_epoch, np.zeros(n - old, np.uint64)])

    def pending(self) -> int:
        return sum(v.shape[0] for v in self._buf_val)

    # -- ingest --------------------------------------------------------------

    def push_votes(self, validators: np.ndarray, node_idx: int,
                   target_epoch: int) -> None:
        """Buffer one attestation's votes (already filtered to a known
        target node).  Equivocating validators are dropped at the door —
        this IS the host's call-order semantics: a vote pushed before
        ``push_equivocation(v)`` is already in the buffer and lands at
        flush; one pushed after never enters.  (The host returns before
        growing for equivocators, and membership implies the columns are
        already grown.)"""
        v = np.asarray(validators, np.int64)
        if self.equivocating:
            eq = np.fromiter(self.equivocating, np.int64,
                             len(self.equivocating))
            v = v[~np.isin(v, eq)]
        k = v.shape[0]
        if k == 0:
            return
        self._buf_val.append(v)
        self._buf_node.append(np.full(k, node_idx, np.int32))
        self._buf_epoch.append(np.full(k, target_epoch, np.int64))
        self._buf_arr.append(np.arange(self._arrival, self._arrival + k,
                                       dtype=np.int64))
        self._arrival += k

    def push_equivocation(self, validator_index: int) -> None:
        v = int(validator_index)
        self.grow(v + 1)
        self.equivocating.add(v)

    # -- flush ---------------------------------------------------------------

    def flush(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Apply every buffered vote in arrival order (vectorized) and
        return the applied ``(validators, nodes, epochs)`` — the scatter
        the device mirror needs.  Empty arrays when nothing changed."""
        empty = (np.zeros(0, np.int64), np.zeros(0, np.int32),
                 np.zeros(0, np.int64))
        if not self._buf_val:
            return empty
        vals = np.concatenate(self._buf_val)
        nodes = np.concatenate(self._buf_node)
        epochs = np.concatenate(self._buf_epoch)
        arr = np.concatenate(self._buf_arr)
        self._buf_val, self._buf_node = [], []
        self._buf_epoch, self._buf_arr = [], []
        self.grow(int(vals.max()) + 1)
        # Per-validator winner of the sequential fold: the highest epoch,
        # earliest arrival among equals (lexsort: last row per validator).
        order = np.lexsort((-arr, epochs, vals))
        v_sorted = vals[order]
        is_last = np.ones(v_sorted.shape[0], bool)
        is_last[:-1] = v_sorted[1:] != v_sorted[:-1]
        sel = order[is_last]
        wv, wn, we = vals[sel], nodes[sel], epochs[sel]
        # Host update rule: strictly-greater epoch, or no latest message.
        apply = (we > self.next_epoch[wv].astype(np.int64)) \
            | (self.next[wv] == -1)
        wv, wn, we = wv[apply], wn[apply], we[apply]
        self.next[wv] = wn
        self.next_epoch[wv] = we.astype(np.uint64)
        return wv, wn, we

    def remap(self, remap: np.ndarray) -> None:
        """Post-prune node-index remap (host ``maybe_prune`` gather):
        ``remap[-1]`` must be -1 so empty votes stay empty."""
        self.current = remap[self.current]
        self.next = remap[self.next]


# ---------------------------------------------------------------------------
# Numpy passes — the host-vectorized engine (and the oracle the torch
# round in device_proto_array must match bit-for-bit).
# ---------------------------------------------------------------------------


def compute_deltas_host(votes: VoteBuffer, old_balances: np.ndarray,
                        new_balances: np.ndarray,
                        n_nodes: int) -> Tuple[np.ndarray, np.ndarray]:
    """Per-node weight deltas from vote movement — two scatter-adds over
    the whole validator set (`proto_array_fork_choice.rs:819`).  Moves
    ``current ← next`` and returns ``(deltas, persisted_new_balances)``
    exactly like the host (equivocation-zeroed balances persist)."""
    nv = len(votes)
    old_b = np.zeros(nv, np.uint64)
    m = min(old_balances.shape[0], nv)
    old_b[:m] = old_balances[:m]
    new_b = np.zeros(nv, np.uint64)
    m2 = min(new_balances.shape[0], nv)
    new_b[:m2] = new_balances[:m2]
    if votes.equivocating:
        eq = np.fromiter(votes.equivocating, dtype=np.int64,
                         count=len(votes.equivocating))
        new_b[eq[eq < nv]] = 0
    deltas = np.zeros(n_nodes, np.int64)
    cur_mask = votes.current >= 0
    np.subtract.at(deltas, votes.current[cur_mask],
                   old_b[cur_mask].astype(np.int64))
    nxt_mask = votes.next >= 0
    np.add.at(deltas, votes.next[nxt_mask], new_b[nxt_mask].astype(np.int64))
    votes.current = votes.next.copy()
    return deltas, new_b


def apply_scores_host(cols: NodeColumns, deltas: np.ndarray,
                      viable: np.ndarray,
                      prev_boost_idx: int, prev_boost_score: int,
                      boost_idx: int, boost_score: int) -> None:
    """Bottom-up weight propagation + best-child sweep, one masked vector
    step per tree level (the host's two reverse node walks,
    `proto_array.rs:167-320`).  Mutates ``cols.weight/best_child/
    best_desc`` in place.

    Equivalence to the host walk: parents always precede children, so the
    reverse index order the host uses IS a topological order; processing
    whole levels deepest-first visits every parent→child edge after the
    child's own subtree is final, which is the only ordering property the
    host result depends on (the running best-child max over a total order
    converges to the same argmax regardless of sibling order).
    """
    n = cols.n
    d = np.zeros(n, np.int64)
    d[:deltas.shape[0]] = deltas
    invalid = cols.exec_status[:n] == EXEC_INVALID
    zroot = cols.zero_root_mask()
    weight = cols.weight
    bc, bd = cols.best_child, cols.best_desc
    parent = cols.parent
    rank = cols.ranks()
    if prev_boost_idx >= 0 and not invalid[prev_boost_idx]:
        d[prev_boost_idx] -= prev_boost_score
    if boost_idx >= 0 and not invalid[boost_idx]:
        d[boost_idx] += boost_score
    neg = np.int64(-1)
    for lvl in range(cols.max_depth(), -1, -1):
        c = cols.levels()[lvl]
        if c.size == 0:
            continue
        inv_c = invalid[c]
        zr_c = zroot[c]
        # Finalize this level's weights: every deeper delta has arrived.
        # Zero-root nodes are skipped wholesale (delta discarded, nothing
        # propagates); invalid nodes remove their pre-update weight from
        # ancestors and pin to zero (`proto_array.rs:209-216`).
        d_eff = np.where(zr_c, 0, np.where(inv_c, -weight[c], d[c]))
        weight[c] = np.where(inv_c, 0,
                             np.where(zr_c, weight[c], weight[c] + d_eff))
        pc = parent[c]
        has_parent = pc >= 0
        if not has_parent.any():
            continue
        np.add.at(d, pc[has_parent], d_eff[has_parent])
        # Best-child recompute for every parent with a child at this
        # level (all of a parent's children share one depth): a 3-stage
        # segment argmax — max weight, then max root-rank among ties,
        # then the unique winner — over viable-leading children only.
        cc = c[has_parent]
        pp = pc[has_parent]
        # leads-to-viable (`proto_array.rs` node_leads_to_viable_head):
        # the best descendant is viable OR the node itself is.
        lead = viable[cc].copy()
        bdc = bd[cc]
        mbd = bdc >= 0
        lead[mbd] |= viable[bdc[mbd]]

        def seg_argmax(mask):
            """Per-parent argmax over masked children by the host's total
            order: weight, then root rank (roots unique ⇒ unique winner).
            Returns a node-indexed array, −1 where the mask is empty."""
            wmax = np.full(n, neg)
            np.maximum.at(wmax, pp[mask], weight[cc[mask]])
            m2 = mask & (weight[cc] == wmax[pp])
            rmax = np.full(n, neg)
            np.maximum.at(rmax, pp[m2], rank[cc[m2]])
            m3 = m2 & (rank[cc] == rmax[pp])
            win = np.full(n, neg)
            np.maximum.at(win, pp[m3], cc[m3])
            return win

        # The host's incremental sweep (descending child index, seeded
        # with LAST round's best child) reduces to a closed form:
        # - any viable-leading child  → argmax over those (pure);
        # - none, previous best None  → None;
        # - none, previous best j     → None if j is still the max over
        #   children with index ≥ j (the sweep reaches j while it is
        #   still best and resets), else the global argmax (j is beaten
        #   by a higher-index child first, and the reset never fires).
        win_lead = seg_argmax(lead)
        win_all = seg_argmax(np.ones(cc.shape[0], bool))
        prevb = bc[:n].astype(np.int64)
        win_ge = seg_argmax(cc >= prevb[pp])
        F = np.where(win_lead >= 0, win_lead,
                     np.where(prevb == -1, neg,
                              np.where(win_ge == prevb, neg, win_all)))
        touched = np.unique(pp)
        newF = F[touched]
        bc[touched] = newF.astype(np.int32)
        fc = np.maximum(newF, 0)
        wbd = bd[fc]
        bd[touched] = np.where(newF >= 0,
                               np.where(wbd >= 0, wbd,
                                        newF.astype(np.int32)),
                               np.int32(-1))
    if (weight[:n] < 0).any():
        raise ProtoArrayError("negative node weight")


def apply_scores_walk(cols: NodeColumns, deltas: np.ndarray,
                      viable: np.ndarray,
                      prev_boost_idx: int, prev_boost_score: int,
                      boost_idx: int, boost_score: int) -> None:
    """Exact O(n) python port of the host's two reverse walks over the
    columns (`proto_array.rs:167-320`) — the deep-tree arm of
    :func:`apply_scores`: on a chain-shaped proto-array the level sweep
    pays one full vector step per node of depth, while this walk costs
    the same as the host oracle."""
    n = cols.n
    d = [0] * n
    for i in range(min(deltas.shape[0], n)):
        d[i] = int(deltas[i])
    invalid = (cols.exec_status[:n] == EXEC_INVALID).tolist()
    zroot = cols.zero_root_mask().tolist()
    lead_ok = viable.tolist()
    weight = cols.weight[:n].tolist()
    parent = cols.parent[:n].tolist()
    bc = cols.best_child[:n].tolist()
    bd = cols.best_desc[:n].tolist()
    rank = cols.ranks().tolist()
    for i in range(n - 1, -1, -1):
        if zroot[i]:
            continue
        inv = invalid[i]
        di = -weight[i] if inv else d[i]
        if i == prev_boost_idx and not inv:
            di -= prev_boost_score
        if i == boost_idx and not inv:
            di += boost_score
        weight[i] = 0 if inv else weight[i] + di
        if weight[i] < 0:
            raise ProtoArrayError("negative node weight")
        p = parent[i]
        if p >= 0:
            d[p] += di

    def leads(c: int) -> bool:
        b = bd[c]
        return (b >= 0 and lead_ok[b]) or lead_ok[c]

    for c in range(n - 1, -1, -1):
        p = parent[c]
        if p < 0:
            continue
        child_lead = leads(c)
        tc = (c, bd[c] if bd[c] >= 0 else c)
        if bc[p] >= 0:
            if bc[p] == c and not child_lead:
                new = (-1, -1)
            elif bc[p] == c:
                new = tc
            else:
                b = bc[p]
                best_lead = leads(b)
                if child_lead and not best_lead:
                    new = tc
                elif not child_lead and best_lead:
                    new = (bc[p], bd[p])
                elif weight[c] == weight[b]:
                    new = tc if rank[c] >= rank[b] else (bc[p], bd[p])
                else:
                    new = tc if weight[c] >= weight[b] else (bc[p], bd[p])
        else:
            new = tc if child_lead else (bc[p], bd[p])
        bc[p], bd[p] = new
    cols.weight[:n] = weight
    cols.best_child[:n] = bc
    cols.best_desc[:n] = bd


# Past this depth (AND depth beyond n/32) the chain-shaped walk beats the
# per-level vector sweep; the measured crossover sits well above it in
# the bushy direction and well below in the chain direction.
_WALK_DEPTH = 96


def apply_scores(cols: NodeColumns, deltas: np.ndarray, viable: np.ndarray,
                 prev_boost_idx: int, prev_boost_score: int,
                 boost_idx: int, boost_score: int) -> None:
    """Adaptive dispatch between the vectorized level sweep (bushy trees)
    and the exact host-port walk (deep/chain-shaped trees)."""
    md = cols.max_depth()
    if md > _WALK_DEPTH and md > cols.n // 32:
        apply_scores_walk(cols, deltas, viable, prev_boost_idx,
                          prev_boost_score, boost_idx, boost_score)
    else:
        apply_scores_host(cols, deltas, viable, prev_boost_idx,
                          prev_boost_score, boost_idx, boost_score)
