"""Proto-array LMD-GHOST fork choice — columnar redesign.

Counterpart of the reference's ``consensus/proto_array``
(``consensus/proto_array/src/proto_array.rs``,
``proto_array_fork_choice.rs``).  The node graph is a small append-only
table (parents always precede children), while the validator-side state —
latest messages and deltas — is columnar numpy sized by the validator set:

- votes are (current_node, next_node, next_epoch) int32/uint64 columns;
- ``compute_deltas`` (``proto_array_fork_choice.rs:819``) is two
  ``np.bincount`` scatter-adds over the whole validator set instead of a
  per-validator loop — the 1M-validator work is one vector op;
- the backward weight propagation and best-child sweep walk the node table
  (hundreds of entries after pruning), exactly the reference's two reverse
  passes (``proto_array.rs:167-320``).

Execution-status tracking (optimistic sync) keeps the reference's
valid/optimistic/invalid trichotomy at node granularity: invalid nodes are
pinned to zero weight and never viable (``proto_array.rs:209-216,897``).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

ZERO_ROOT = b"\x00" * 32

# Execution status per node (`proto_array.rs` ExecutionStatus).
EXEC_VALID = 0
EXEC_OPTIMISTIC = 1
EXEC_INVALID = 2
EXEC_IRRELEVANT = 3  # pre-merge


class ProtoArrayError(ValueError):
    pass


@dataclass
class ProtoNode:
    """One block in the tree (`proto_array.rs` ProtoNode)."""
    slot: int
    root: bytes
    parent: Optional[int]
    state_root: bytes
    justified_epoch: int
    justified_root: bytes
    finalized_epoch: int
    finalized_root: bytes
    execution_status: int = EXEC_IRRELEVANT
    execution_block_hash: Optional[bytes] = None
    weight: int = 0
    best_child: Optional[int] = None
    best_descendant: Optional[int] = None


@dataclass
class VoteTracker:
    """Columnar latest-message store (`proto_array_fork_choice.rs`
    VoteTracker per validator, here as whole-registry columns)."""
    current: np.ndarray  # int32 node index, -1 = none
    next: np.ndarray     # int32 node index, -1 = none
    next_epoch: np.ndarray  # uint64

    @classmethod
    def new(cls, n: int = 0) -> "VoteTracker":
        return cls(np.full(n, -1, np.int32), np.full(n, -1, np.int32),
                   np.zeros(n, np.uint64))

    def grow(self, n: int) -> None:
        old = self.current.shape[0]
        if n <= old:
            return
        self.current = np.concatenate([self.current, np.full(n - old, -1, np.int32)])
        self.next = np.concatenate([self.next, np.full(n - old, -1, np.int32)])
        self.next_epoch = np.concatenate([self.next_epoch,
                                          np.zeros(n - old, np.uint64)])


class ProtoArrayForkChoice:
    """`ProtoArrayForkChoice` (`proto_array_fork_choice.rs:318`)."""

    def __init__(self, prune_threshold: int = 256):
        self.nodes: List[ProtoNode] = []
        self.indices: Dict[bytes, int] = {}
        self.votes = VoteTracker.new()
        self.old_balances = np.zeros(0, np.uint64)
        self.equivocating: set[int] = set()
        self.justified_checkpoint: Tuple[int, bytes] = (0, ZERO_ROOT)
        self.finalized_checkpoint: Tuple[int, bytes] = (0, ZERO_ROOT)
        self.prev_boost_root: bytes = ZERO_ROOT
        self.prev_boost_score: int = 0
        self.prune_threshold = prune_threshold

    # -- block tree ----------------------------------------------------------

    def on_block(self, *, slot: int, root: bytes, parent_root: bytes,
                 state_root: bytes, justified_epoch: int,
                 justified_root: bytes, finalized_epoch: int,
                 finalized_root: bytes,
                 execution_status: int = EXEC_IRRELEVANT,
                 execution_block_hash: Optional[bytes] = None) -> None:
        if root in self.indices:
            return
        parent = self.indices.get(parent_root)
        node = ProtoNode(
            slot=slot, root=root, parent=parent, state_root=state_root,
            justified_epoch=justified_epoch, justified_root=justified_root,
            finalized_epoch=finalized_epoch, finalized_root=finalized_root,
            execution_status=execution_status,
            execution_block_hash=execution_block_hash)
        idx = len(self.nodes)
        self.nodes.append(node)
        self.indices[root] = idx

    def slot_of(self, root: bytes) -> int:
        """Slot of a known block (shared API with the columnar twin)."""
        idx = self.indices.get(bytes(root))
        if idx is None:
            raise ProtoArrayError("unknown block")
        return self.nodes[idx].slot

    def process_attestation(self, validator_index: int, block_root: bytes,
                            target_epoch: int) -> None:
        """Latest-message update (`proto_array_fork_choice.rs:370`): keep
        the vote with the highest target epoch."""
        if validator_index in self.equivocating:
            return
        idx = self.indices.get(block_root)
        if idx is None:
            raise ProtoArrayError("attestation for unknown block")
        self.votes.grow(validator_index + 1)
        if target_epoch > int(self.votes.next_epoch[validator_index]) \
                or self.votes.next[validator_index] == -1:
            self.votes.next[validator_index] = idx
            self.votes.next_epoch[validator_index] = target_epoch

    def process_attestation_batch(self, batch) -> None:
        """Whole-slot vote ingest: ``[(indices, block_root, target_epoch),
        …]``.  The host oracle applies them as the sequential per-validator
        fold (the definition of correct ordering semantics); the columnar
        twin overrides this with one vectorized buffer push per
        attestation."""
        for indices, block_root, target_epoch in batch:
            for i in indices:
                self.process_attestation(int(i), block_root,
                                         int(target_epoch))

    def process_equivocation(self, validator_index: int) -> None:
        """Remove an equivocating validator's weight forever (spec's
        equivocating_indices)."""
        self.votes.grow(validator_index + 1)
        self.equivocating.add(validator_index)

    # -- score changes -------------------------------------------------------

    def compute_deltas(self, new_balances: np.ndarray) -> np.ndarray:
        """Per-node weight deltas from vote changes — two vectorized
        scatter-adds (`proto_array_fork_choice.rs:819`)."""
        n_nodes = len(self.nodes)
        v = self.votes
        nv = v.current.shape[0]
        old_b = np.zeros(nv, np.uint64)
        m = min(self.old_balances.shape[0], nv)
        old_b[:m] = self.old_balances[:m]
        new_b = np.zeros(nv, np.uint64)
        m2 = min(new_balances.shape[0], nv)
        new_b[:m2] = new_balances[:m2]
        if self.equivocating:
            eq = np.fromiter(self.equivocating, dtype=np.int64)
            new_b[eq[eq < nv]] = 0
        deltas = np.zeros(n_nodes, np.int64)
        cur_mask = v.current >= 0
        np.subtract.at(deltas, v.current[cur_mask],
                       old_b[cur_mask].astype(np.int64))
        nxt_mask = v.next >= 0
        np.add.at(deltas, v.next[nxt_mask], new_b[nxt_mask].astype(np.int64))
        # Votes move: current ← next.  Persist the EQUIVOCATION-ZEROED
        # balances: an equivocator's weight was removed this round and must
        # not be re-subtracted on the next call.
        v.current = v.next.copy()
        self.old_balances = new_b.copy()
        return deltas

    def apply_score_changes(self, deltas: np.ndarray,
                            justified_checkpoint: Tuple[int, bytes],
                            finalized_checkpoint: Tuple[int, bytes],
                            proposer_boost_root: bytes,
                            proposer_boost_score: int,
                            current_slot: int) -> None:
        """Backward weight pass + best-child sweep (`proto_array.rs:167`)."""
        if len(deltas) != len(self.nodes):
            raise ProtoArrayError("delta length mismatch")
        self.justified_checkpoint = justified_checkpoint
        self.finalized_checkpoint = finalized_checkpoint
        deltas = deltas.copy()
        new_boost_score = 0
        for i in range(len(self.nodes) - 1, -1, -1):
            node = self.nodes[i]
            if node.root == ZERO_ROOT:
                continue
            invalid = node.execution_status == EXEC_INVALID
            d = -node.weight if invalid else int(deltas[i])
            if self.prev_boost_root != ZERO_ROOT \
                    and self.prev_boost_root == node.root and not invalid:
                d -= self.prev_boost_score
            if proposer_boost_root != ZERO_ROOT \
                    and proposer_boost_root == node.root and not invalid:
                new_boost_score = proposer_boost_score
                d += proposer_boost_score
            node.weight = 0 if invalid else node.weight + d
            if node.weight < 0:
                raise ProtoArrayError("negative node weight")
            if node.parent is not None:
                deltas[node.parent] += d
        self.prev_boost_root = proposer_boost_root
        self.prev_boost_score = new_boost_score
        for i in range(len(self.nodes) - 1, -1, -1):
            parent = self.nodes[i].parent
            if parent is not None:
                self._maybe_update_best_child(parent, i, current_slot)

    # -- head ----------------------------------------------------------------

    def find_head(self, justified_root: bytes, current_slot: int) -> bytes:
        """`proto_array.rs:644`."""
        idx = self.indices.get(justified_root)
        if idx is None:
            raise ProtoArrayError("justified root unknown to fork choice")
        jnode = self.nodes[idx]
        if jnode.execution_status == EXEC_INVALID:
            raise ProtoArrayError("justified node has invalid payload")
        best = jnode.best_descendant
        best = idx if best is None else best
        node = self.nodes[best]
        if not self._viable_for_head(node):
            raise ProtoArrayError("best node not viable for head")
        return node.root

    def _viable_for_head(self, node: ProtoNode) -> bool:
        """`filter_block_tree` predicate (`proto_array.rs:897`)."""
        if node.execution_status == EXEC_INVALID:
            return False
        je, jr = self.justified_checkpoint
        fe, fr = self.finalized_checkpoint
        correct_j = (node.justified_epoch, node.justified_root) == (je, jr) \
            or je == 0
        # Compare the finalized ROOT too: a node descending from a
        # conflicting block finalized at the same epoch number must not
        # pass viability (`proto_array.rs:897` checks the checkpoint, not
        # just the epoch).  Nodes at/above the finalized slot carry their
        # own ancestor root; require it to match ours.
        correct_f = (node.finalized_epoch, node.finalized_root) == (fe, fr) \
            or fe == 0
        return correct_j and correct_f

    def _leads_to_viable_head(self, node: ProtoNode) -> bool:
        if node.best_descendant is not None \
                and self._viable_for_head(self.nodes[node.best_descendant]):
            return True
        return self._viable_for_head(node)

    def _maybe_update_best_child(self, parent_idx: int, child_idx: int,
                                 current_slot: int) -> None:
        """`proto_array.rs:778` — three-way best-child decision."""
        child = self.nodes[child_idx]
        parent = self.nodes[parent_idx]
        child_viable = self._leads_to_viable_head(child)
        to_child = (child_idx,
                    child.best_descendant if child.best_descendant is not None
                    else child_idx)
        if parent.best_child is not None:
            if parent.best_child == child_idx and not child_viable:
                new = (None, None)
            elif parent.best_child == child_idx:
                new = to_child
            else:
                best = self.nodes[parent.best_child]
                best_viable = self._leads_to_viable_head(best)
                if child_viable and not best_viable:
                    new = to_child
                elif not child_viable and best_viable:
                    new = (parent.best_child, parent.best_descendant)
                elif child.weight == best.weight:
                    new = to_child if child.root >= best.root \
                        else (parent.best_child, parent.best_descendant)
                else:
                    new = to_child if child.weight >= best.weight \
                        else (parent.best_child, parent.best_descendant)
        else:
            new = to_child if child_viable \
                else (parent.best_child, parent.best_descendant)
        parent.best_child, parent.best_descendant = new

    # -- pruning -------------------------------------------------------------

    def maybe_prune(self, finalized_root: bytes) -> None:
        """Drop everything before the finalized root once the prefix is big
        enough (`proto_array.rs` maybe_prune); vote indices remap via one
        np.take."""
        fin_idx = self.indices.get(finalized_root)
        if fin_idx is None or fin_idx < self.prune_threshold:
            return
        keep = list(range(fin_idx, len(self.nodes)))
        remap = np.full(len(self.nodes) + 1, -1, np.int32)
        for new_i, old_i in enumerate(keep):
            remap[old_i] = new_i
        new_nodes = []
        for old_i in keep:
            node = self.nodes[old_i]
            node.parent = (None if node.parent is None
                           or remap[node.parent] < 0
                           else int(remap[node.parent]))
            for attr in ("best_child", "best_descendant"):
                v = getattr(node, attr)
                setattr(node, attr,
                        None if v is None or remap[v] < 0 else int(remap[v]))
            new_nodes.append(node)
        self.nodes = new_nodes
        self.indices = {n.root: i for i, n in enumerate(new_nodes)}
        # Remap votes in one gather (dangling votes become -1).
        self.votes.current = remap[self.votes.current]
        self.votes.next = remap[self.votes.next]

    # -- execution status (optimistic sync) ----------------------------------

    def on_valid_execution_payload(self, root: bytes) -> None:
        """Mark a node and its ancestors valid (`proto_array.rs`
        propagate_execution_payload_validation)."""
        idx = self.indices.get(root)
        while idx is not None:
            node = self.nodes[idx]
            if node.execution_status == EXEC_INVALID:
                raise ProtoArrayError("valid payload above invalid ancestor")
            if node.execution_status in (EXEC_VALID, EXEC_IRRELEVANT):
                break
            node.execution_status = EXEC_VALID
            idx = node.parent

    def on_invalid_execution_payload(self, root: bytes) -> None:
        """Invalidate a node and all its descendants
        (`proto_array.rs` InvalidationOperation::InvalidateOne)."""
        start = self.indices.get(root)
        if start is None:
            return
        # Mark only; weights stay intact so the next apply_score_changes
        # can compute d = -weight and propagate the REMOVAL to ancestors —
        # pre-zeroing here would leave phantom subtree weight above the
        # invalidated block (`proto_array.rs:209-216` relies on the same).
        invalid = {start}
        self.nodes[start].execution_status = EXEC_INVALID
        for i in range(start + 1, len(self.nodes)):
            node = self.nodes[i]
            if node.parent in invalid:
                node.execution_status = EXEC_INVALID
                invalid.add(i)
