"""Device proto-array fork choice — batched score-delta application.

:class:`DeviceProtoArrayForkChoice` is API-compatible with the host
:class:`~.proto_array.ProtoArrayForkChoice` (the bit-for-bit oracle the
tests hold it to, and the form it is persisted in) but holds the tree as
:class:`~.columnar.NodeColumns` and votes in a
:class:`~.columnar.VoteBuffer`, so a whole slot's attestations apply as
ONE batched pass instead of a per-validator python loop.

Two engines share the columnar state:

- ``numpy`` — the vectorized host passes in :mod:`.columnar` (the engine
  when the port's device is the CPU);
- ``torch`` — ``compute_deltas`` + ``apply_score_changes`` as one round of
  torch ops on the port's device (:func:`_round`): a segment-sum of vote
  deltas over the registry (two ``index_add_`` into an ``n_pad + 1``
  sink) followed by a bottom-up weight/best-child propagation, one step
  per tree level, driven on the host over ``range(max_depth + 1)`` (the
  depth is host-known, so the loop never reads the device).
  Validator-sized state (current/next votes, persisted balances) stays
  device-resident between rounds in :class:`_DeviceMirror`: per round the
  host pushes only the CHANGED vote scatters, the new justified balances
  and n-node-sized masks, and pulls back three small node columns
  (weight/best-child/best-descendant) and the negative-weight flag, in
  one copy.  Balances are u64 carried as int64 bit patterns; every sum
  here stays far below 2^63, so int64 arithmetic equals numpy's.

Engine selection: ``engine=`` takes ``"torch"`` or ``"numpy"``; unset, the
engine is ``torch`` when the port's device is a GPU
(:func:`..device.on_cuda`) and ``numpy`` otherwise.  A ``torch`` round on a
GPU runs there or raises: no round falls back to numpy.  Past
``LIGHTHOUSE_TPU_FORKCHOICE_JIT_MAX_DEPTH`` levels a round runs on the
host by design (one launch sequence per level would dominate), with the
device mirrors kept moving; :attr:`DeviceProtoArrayForkChoice.host_rounds`
counts those rounds.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np

from ..ops.merkle import _next_pow2
from .columnar import (
    NodeColumns,
    VoteBuffer,
    apply_scores,
    compute_deltas_host,
)
from .proto_array import (
    EXEC_INVALID,
    EXEC_IRRELEVANT,
    EXEC_VALID,
    ProtoArrayError,
    ProtoArrayForkChoice,
    VoteTracker,
    ZERO_ROOT,
)

ENGINES = ("torch", "numpy")


def _resolve_engine(engine: Optional[str]) -> str:
    if engine is None:
        from .. import device
        return "torch" if device.on_cuda() else "numpy"
    if engine not in ENGINES:
        raise ValueError(f"unknown fork-choice engine {engine!r}; "
                         f"expected one of {ENGINES}")
    return engine


def _bucket(k: int, floor: int = 16) -> int:
    return max(_next_pow2(max(int(k), 1)), floor)


# ---------------------------------------------------------------------------
# One round on the device: vote-delta segment sum + level-by-level
# propagation.  Plain torch ops on int64 tensors.
# ---------------------------------------------------------------------------


def _local_delta(cur, nxt, old_b, new_b, n_pad: int):
    """Vote deltas: two segment scatter-adds over the registry into an
    ``n_pad + 1`` column whose last row is the sink for "no vote"."""
    import torch
    dummy = n_pad
    zero = torch.zeros((), dtype=torch.int64, device=cur.device)
    delta = torch.zeros(n_pad + 1, dtype=torch.int64, device=cur.device)
    delta.index_add_(0, torch.where(cur >= 0, cur, dummy),
                     torch.where(cur >= 0, -old_b, zero))
    delta.index_add_(0, torch.where(nxt >= 0, nxt, dummy),
                     torch.where(nxt >= 0, new_b, zero))
    return delta


def _propagate(delta, parent, depth, invalid, zroot, viable, rank, weight,
               bc, bd, pb_idx: int, pb_score: int, b_idx: int,
               b_score: int, max_depth: int, n_pad: int):
    """Proposer-boost moves, then one step per level from the deepest up:
    weights finalize, their deltas move to the parents, and each parent
    with a child at the level re-picks its best child.  ``pb_idx`` ..
    ``max_depth`` are host ints.  Returns ``(weight, bc, bd, neg)``."""
    import torch
    dev = delta.device
    i64 = torch.int64
    dummy = n_pad
    if pb_idx >= 0:
        delta[pb_idx] -= pb_score
    if b_idx >= 0:
        delta[b_idx] += b_score
    delta[dummy] = 0
    zero = torch.zeros((), dtype=i64, device=dev)
    minus1 = torch.full((), -1, dtype=i64, device=dev)
    has_parent = parent >= 0
    pidx = torch.where(has_parent, parent, dummy)
    pclamp = parent.clamp(min=0)
    iota = torch.arange(n_pad, dtype=i64, device=dev)
    sink = torch.full((n_pad + 1,), -1, dtype=i64, device=dev)

    def seg_max(vals):
        return sink.clone().scatter_reduce_(0, pidx, vals, "amax",
                                            include_self=True)

    def seg_argmax(mask):
        wmax = seg_max(torch.where(mask, weight, minus1))
        m2 = mask & (weight == wmax[pidx])
        rmax = seg_max(torch.where(m2, rank, minus1))
        m3 = m2 & (rank == rmax[pidx])
        return seg_max(torch.where(m3, iota, minus1))[:n_pad]

    for lvl in range(max_depth, -1, -1):
        at = depth == lvl  # pad rows carry depth -1: never selected
        d_eff = torch.where(
            at, torch.where(zroot, zero,
                            torch.where(invalid, -weight, delta[:n_pad])),
            zero)
        weight = torch.where(
            at, torch.where(invalid, zero,
                            torch.where(zroot, weight, weight + d_eff)),
            weight)
        delta.index_add_(0, pidx, d_eff)
        # leads-to-viable: best descendant viable OR the node itself
        lead = viable | ((bd >= 0) & viable[bd.clamp(min=0)])
        child = at & has_parent
        # The host's incremental descending-index sweep, seeded with LAST
        # round's best child, in closed form (the derivation is at
        # columnar.apply_scores_host).  Not a plain argmax.
        win_lead = seg_argmax(child & lead)
        win_all = seg_argmax(child)
        prev_at_parent = torch.where(has_parent, bc[pclamp], minus1)
        win_ge = seg_argmax(child & (iota >= prev_at_parent))
        has = seg_max(child.to(i64))[:n_pad] > 0
        F = torch.where(win_lead >= 0, win_lead,
                        torch.where((bc == -1) | (win_ge == bc), minus1,
                                    win_all))
        bdF = bd[F.clamp(min=0)]
        fbd = torch.where(F >= 0, torch.where(bdF >= 0, bdF, F), minus1)
        bc = torch.where(has, F, bc)
        bd = torch.where(has, fbd, bd)
    neg = (weight < 0).any()
    return weight, bc, bd, neg


def _round(cur, nxt, old_b, new_b, parent, depth, invalid, zroot, viable,
           rank, weight, bc, bd, pb_idx, pb_score, b_idx, b_score,
           max_depth, n_pad):
    """One fused round: :func:`_local_delta` then :func:`_propagate`."""
    return _propagate(_local_delta(cur, nxt, old_b, new_b, n_pad), parent,
                      depth, invalid, zroot, viable, rank, weight, bc, bd,
                      pb_idx, pb_score, b_idx, b_score, max_depth, n_pad)


class _DeviceMirror:
    """Device twins of the validator-sized vote/balance columns and the
    node-topology columns.  Every copy goes through :mod:`..device`, so
    the bytes land in the ledger under ``fork_choice``; the resident
    bytes are tracked there too.

    Copy-on-write: after a round ``cur`` IS ``nxt`` (the device-side vote
    move aliases them), so :meth:`scatter_votes` writes into a fresh
    column; no column handed out is written in place."""

    SUBSYSTEM = "fork_choice"

    def __init__(self, votes: VoteBuffer, old_balances: np.ndarray,
                 n_nodes: int):
        from ..common.device_ledger import LEDGER
        from .. import device

        self.nv_pad = _bucket(max(len(votes), 1))
        self.n_pad = _bucket(max(n_nodes, 1))
        cur = np.full(self.nv_pad, -1, np.int32)
        cur[:len(votes)] = votes.current
        nxt = np.full(self.nv_pad, -1, np.int32)
        nxt[:len(votes)] = votes.next
        ob = np.zeros(self.nv_pad, np.int64)
        m = min(old_balances.shape[0], len(votes))
        ob[:m] = old_balances[:m].astype(np.int64)
        self.cur = device.to_device(cur, self.SUBSYSTEM)
        self.nxt = device.to_device(nxt, self.SUBSYSTEM)
        self.old_b = device.to_device(ob, self.SUBSYSTEM)
        self.topo_version = -1  # force first topology push
        self.parent = None
        self.depth = None
        self.weight = None
        self._res = LEDGER.track(self, self.SUBSYSTEM, 0)
        self._note_residency()

    def _note_residency(self) -> None:
        # Dedupe by identity: after a round `cur` IS `nxt`.
        cols = {id(c): c for c in (self.cur, self.nxt, self.old_b,
                                   self.parent, self.depth, self.weight)
                if c is not None}
        self._res.set(sum(c.numel() * c.element_size()
                          for c in cols.values()))

    def fits(self, votes: VoteBuffer, n_nodes: int) -> bool:
        return len(votes) <= self.nv_pad and n_nodes <= self.n_pad

    def fits_pending(self, votes: VoteBuffer, n_nodes: int) -> bool:
        """Like :meth:`fits`, but sized for the POST-flush validator
        count: a buffered vote beyond the bucket would otherwise drop
        the mirror between the fit check and the round."""
        pend = max((int(v.max()) + 1 for v in votes._buf_val
                    if v.shape[0]), default=0)
        return max(len(votes), pend) <= self.nv_pad \
            and n_nodes <= self.n_pad

    def set_old_balances(self, new_b: np.ndarray) -> None:
        """The vote/balance move of a round whose deltas were computed
        elsewhere: ``old_b ← new_b`` and ``cur ← nxt``."""
        from .. import device
        nb = np.zeros(self.nv_pad, np.int64)
        nb[:new_b.shape[0]] = new_b.astype(np.int64)
        self.old_b = device.to_device(nb, self.SUBSYSTEM)
        self.cur = self.nxt
        self._note_residency()

    def scatter_votes(self, wv: np.ndarray, wn: np.ndarray) -> None:
        if wv.shape[0] == 0:
            return
        from .. import device
        k_pad = _bucket(wv.shape[0], floor=8)
        iv = np.empty((2, k_pad), np.int64)
        iv[0, :wv.shape[0]] = wv
        iv[0, wv.shape[0]:] = wv[0]  # duplicate-set padding: idempotent
        iv[1, :wn.shape[0]] = wn
        iv[1, wn.shape[0]:] = wn[0]
        iv = device.to_device(iv, self.SUBSYSTEM)
        if self.nxt is self.cur:
            self.nxt = self.nxt.clone()
        self.nxt.index_put_((iv[0],), iv[1].to(self.nxt.dtype))
        self._note_residency()  # cur/nxt diverge into two buffers here

    def push_topology(self, cols: NodeColumns, version: int) -> None:
        if self.topo_version == version and self.parent is not None:
            return
        from .. import device
        n = cols.n
        topo = np.full((3, self.n_pad), -1, np.int64)
        topo[0, :n] = cols.parent[:n]
        topo[1, :n] = cols.depth[:n]
        topo[2] = 0
        topo[2, :n] = cols.weight[:n]
        topo = device.to_device(topo, self.SUBSYSTEM)
        self.parent, self.depth, self.weight = topo[0], topo[1], topo[2]
        self.topo_version = version
        self._note_residency()


class DeviceProtoArrayForkChoice:
    """Columnar twin of :class:`~.proto_array.ProtoArrayForkChoice`."""

    def __init__(self, prune_threshold: int = 256,
                 engine: Optional[str] = None,
                 jit_max_depth: Optional[int] = None):
        self.cols = NodeColumns()
        self.votes_store = VoteBuffer()
        self.old_balances = np.zeros(0, np.uint64)
        self.justified_checkpoint: Tuple[int, bytes] = (0, ZERO_ROOT)
        self.finalized_checkpoint: Tuple[int, bytes] = (0, ZERO_ROOT)
        self.prev_boost_root: bytes = ZERO_ROOT
        self.prev_boost_score: int = 0
        self.prune_threshold = prune_threshold
        self.engine = _resolve_engine(engine)
        # The device round serializes one step per tree level; past this
        # depth (chain-shaped trees, long non-finality) the round runs on
        # the host instead — mirrors stay in sync.
        from ..common.knobs import knob_int
        self.jit_max_depth = jit_max_depth if jit_max_depth is not None \
            else knob_int("LIGHTHOUSE_TPU_FORKCHOICE_JIT_MAX_DEPTH")
        self._mirror: Optional[_DeviceMirror] = None
        self._topo_version = 0
        self._pending_new_b: Optional[np.ndarray] = None
        # Rounds of the torch engine run on the host (depth route).
        self.host_rounds = 0

    # -- host-API parity surface --------------------------------------------

    @property
    def indices(self) -> Dict[bytes, int]:
        return self.cols.indices

    @property
    def equivocating(self) -> set:
        return self.votes_store.equivocating

    @property
    def votes(self) -> VoteTracker:
        """Host-shaped view of the latest-message columns (pending buffered
        votes are merged first so the view is observation-equivalent)."""
        self._flush_votes()
        v = self.votes_store
        return VoteTracker(v.current, v.next, v.next_epoch)

    @property
    def nodes(self) -> List:
        return self.cols.export_nodes()

    def slot_of(self, root: bytes) -> int:
        idx = self.cols.indices.get(bytes(root))
        if idx is None:
            raise ProtoArrayError("unknown block")
        return int(self.cols.slot[idx])

    # -- block tree ----------------------------------------------------------

    def on_block(self, *, slot: int, root: bytes, parent_root: bytes,
                 state_root: bytes, justified_epoch: int,
                 justified_root: bytes, finalized_epoch: int,
                 finalized_root: bytes,
                 execution_status: int = EXEC_IRRELEVANT,
                 execution_block_hash: Optional[bytes] = None) -> None:
        if bytes(root) in self.cols.indices:
            return
        parent = self.cols.indices.get(bytes(parent_root), -1)
        self.cols.append(
            slot=slot, root=root, parent=parent, state_root=state_root,
            justified_epoch=justified_epoch, justified_root=justified_root,
            finalized_epoch=finalized_epoch, finalized_root=finalized_root,
            execution_status=execution_status,
            execution_block_hash=execution_block_hash)
        self._topo_version += 1

    # -- votes ---------------------------------------------------------------

    def process_attestation(self, validator_index: int, block_root: bytes,
                            target_epoch: int) -> None:
        if validator_index in self.votes_store.equivocating:
            return
        idx = self.cols.indices.get(bytes(block_root))
        if idx is None:
            raise ProtoArrayError("attestation for unknown block")
        self.votes_store.push_votes(
            np.asarray([validator_index], np.int64), idx, target_epoch)

    def process_attestation_batch(self, batch) -> None:
        """Whole-slot ingest: ``batch`` is ``[(indices, block_root,
        target_epoch), …]``; each attestation's votes land in the buffer as
        one vectorized push (order preserved — the merge at flush is
        bit-equivalent to the host's sequential fold)."""
        for indices, block_root, target_epoch in batch:
            idx = self.cols.indices.get(bytes(block_root))
            if idx is None:
                # Host raises on the FIRST non-equivocating index; an
                # attestation whose voters all equivocate passes silently.
                if any(int(i) not in self.votes_store.equivocating
                       for i in np.asarray(indices, np.int64)):
                    raise ProtoArrayError("attestation for unknown block")
                continue
            self.votes_store.push_votes(
                np.asarray(indices, np.int64), idx, int(target_epoch))

    def process_equivocation(self, validator_index: int) -> None:
        # Zeroing happens in the host-computed balance column each flush;
        # a growth past the validator bucket rematerializes via fits().
        self.votes_store.push_equivocation(validator_index)

    def _flush_votes(self) -> None:
        wv, wn, _we = self.votes_store.flush()
        if self._mirror is not None and wv.shape[0]:
            if self._mirror.fits(self.votes_store, self.cols.n):
                self._mirror.scatter_votes(wv, wn)
            else:
                self._mirror = None

    # -- score changes -------------------------------------------------------

    def compute_deltas(self, new_balances: np.ndarray):
        """Flush the vote buffer and compute per-node deltas.  The numpy
        engine returns them; the torch engine defers the segment-sum into
        the device round of :meth:`apply_score_changes` and returns an
        opaque marker."""
        if self.engine == "torch":
            if self._pending_new_b is not None and self._mirror is not None:
                # compute_deltas without an intervening apply: the host
                # still moves votes/balances — replicate the device move.
                self._mirror.set_old_balances(self._pending_new_b)
                self._pending_new_b = None
            if self.cols.max_depth() > self.jit_max_depth:
                # Chain-shaped tree: run this head round on host, but
                # keep the device vote/balance mirrors moving so a later
                # shallow round resumes without a rematerialize.
                self.host_rounds += 1
                return self._compute_deltas_host_round(new_balances)
            if self._mirror is None \
                    or not self._mirror.fits_pending(self.votes_store,
                                                     max(self.cols.n, 1)):
                # (Re)materialize BEFORE the flush so the device copy holds
                # the pre-move current votes the delta pass subtracts —
                # sized for the POST-flush validator count (a buffered
                # vote can cross the pow-2 bucket).
                self._materialize()
            self._flush_votes()
            if self._mirror is None:
                self._materialize()  # flush outgrew the bucket anyway
            nv = len(self.votes_store)
            new_b = np.zeros(nv, np.uint64)
            m = min(np.asarray(new_balances).shape[0], nv)
            new_b[:m] = np.asarray(new_balances, np.uint64)[:m]
            if self.votes_store.equivocating:
                eq = np.fromiter(self.votes_store.equivocating, np.int64,
                                 len(self.votes_store.equivocating))
                new_b[eq[eq < nv]] = 0
            self._pending_new_b = new_b
            # host-mirror move (the device move happens in the round)
            self.votes_store.current = self.votes_store.next.copy()
            self.old_balances = new_b.copy()
            return _DEVICE_DELTAS
        self._flush_votes()
        deltas, new_b = compute_deltas_host(
            self.votes_store, self.old_balances,
            np.asarray(new_balances, np.uint64), self.cols.n)
        self.old_balances = new_b.copy()
        return deltas

    def _materialize(self) -> None:
        # Grow-before-flush: the buffer may reference validators beyond the
        # current columns; flush grows them, so bucket on the post-flush
        # size without applying yet.
        pend = (max((int(v.max()) + 1 for v in self.votes_store._buf_val
                     if v.shape[0]), default=0))
        self.votes_store.grow(pend)
        self._mirror = _DeviceMirror(self.votes_store, self.old_balances,
                                     max(self.cols.n, 1))

    def _compute_deltas_host_round(self, new_balances) -> np.ndarray:
        """Deep-tree (or mirror-less) torch round run on host: numpy
        deltas out, device vote/balance mirrors kept in lock-step so the
        next shallow round needs no rematerialize."""
        self._flush_votes()
        deltas, new_b = compute_deltas_host(
            self.votes_store, self.old_balances,
            np.asarray(new_balances, np.uint64), self.cols.n)
        if self._mirror is not None \
                and self._mirror.fits(self.votes_store, 1):
            self._mirror.set_old_balances(new_b)
            # host apply will move weights: force a weight re-push on
            # the next device round even if the topology is unchanged
            self._mirror.topo_version = -1
        else:
            self._mirror = None
        self.old_balances = new_b.copy()
        return deltas

    def apply_score_changes(self, deltas, justified_checkpoint,
                            finalized_checkpoint, proposer_boost_root,
                            proposer_boost_score, current_slot) -> None:
        cols = self.cols
        n = cols.n
        self.justified_checkpoint = justified_checkpoint
        self.finalized_checkpoint = finalized_checkpoint
        viable = cols.viable_mask(justified_checkpoint, finalized_checkpoint)
        invalid = cols.exec_status[:n] == EXEC_INVALID
        pb_idx = (cols.indices.get(self.prev_boost_root, -1)
                  if self.prev_boost_root != ZERO_ROOT else -1)
        if pb_idx >= 0 and invalid[pb_idx]:
            pb_idx = -1
        b_idx = (cols.indices.get(bytes(proposer_boost_root), -1)
                 if bytes(proposer_boost_root) != ZERO_ROOT else -1)
        new_boost = 0
        if b_idx >= 0 and invalid[b_idx]:
            b_idx = -1
        elif b_idx >= 0:
            new_boost = proposer_boost_score
        if deltas is _DEVICE_DELTAS and self.engine == "torch":
            self._apply_device(viable, invalid, pb_idx, self.prev_boost_score,
                            b_idx, proposer_boost_score)
        else:
            if deltas is _DEVICE_DELTAS:
                raise ProtoArrayError("device deltas on a numpy engine")
            if len(deltas) != n:
                raise ProtoArrayError("delta length mismatch")
            apply_scores(cols, np.asarray(deltas, np.int64), viable,
                         pb_idx, self.prev_boost_score,
                         b_idx, proposer_boost_score)
        self.prev_boost_root = bytes(proposer_boost_root)
        self.prev_boost_score = new_boost

    def _apply_device(self, viable, invalid, pb_idx, pb_score, b_idx,
                      b_score) -> None:
        import time as _time
        from ..common.device_ledger import LEDGER
        from .. import device

        cols = self.cols
        n = cols.n
        mir = self._mirror
        assert mir is not None and self._pending_new_b is not None
        mir.push_topology(cols, self._topo_version)
        n_pad = mir.n_pad
        # One upload of the node-sized inputs: invalid, zero-root,
        # viable, rank, best child, best descendant.
        node = np.full((6, n_pad), -1, np.int64)
        node[:3] = 0
        node[0, :n] = invalid
        node[1, :n] = cols.zero_root_mask()
        node[2, :n] = viable
        node[3, :n] = cols.ranks()
        node[4, :n] = cols.best_child[:n]
        node[5, :n] = cols.best_desc[:n]
        new_b = np.zeros(mir.nv_pad, np.int64)
        new_b[:self._pending_new_b.shape[0]] = \
            self._pending_new_b.astype(np.int64)
        # Clock from the staging/round block only: the marshalling above
        # is host prep, not device time.
        t_dispatch = _time.perf_counter()
        sub = _DeviceMirror.SUBSYSTEM
        node_dev = device.to_device(node, sub)
        new_b_dev = device.to_device(new_b, sub)
        flags = node_dev[:3] != 0
        weight, bc, bd, negflag = _round(
            mir.cur, mir.nxt, mir.old_b, new_b_dev, mir.parent, mir.depth,
            flags[0], flags[1], flags[2], node_dev[3], mir.weight,
            node_dev[4], node_dev[5], int(pb_idx), int(pb_score),
            int(b_idx), int(b_score), int(cols.max_depth()), n_pad)
        # device-side vote move + balance persistence (no pull)
        mir.cur = mir.nxt
        mir.old_b = new_b_dev
        mir.weight = weight
        import torch
        out = device.to_host(torch.cat(
            [weight[:n], bc[:n], bd[:n], negflag.to(torch.int64).view(1)]),
            sub).view(np.int64)
        LEDGER.note_dispatch(sub, (_time.perf_counter() - t_dispatch) * 1e3)
        mir._note_residency()
        cols.weight[:n] = out[:n]
        cols.best_child[:n] = out[n:2 * n]
        cols.best_desc[:n] = out[2 * n:3 * n]
        self._pending_new_b = None
        if out[3 * n]:
            raise ProtoArrayError("negative node weight")

    # -- head ----------------------------------------------------------------

    def find_head(self, justified_root: bytes, current_slot: int) -> bytes:
        idx = self.cols.indices.get(bytes(justified_root))
        if idx is None:
            raise ProtoArrayError("justified root unknown to fork choice")
        if self.cols.exec_status[idx] == EXEC_INVALID:
            raise ProtoArrayError("justified node has invalid payload")
        best = int(self.cols.best_desc[idx])
        best = idx if best < 0 else best
        viable = self.cols.viable_mask(self.justified_checkpoint,
                                       self.finalized_checkpoint)
        if not viable[best]:
            raise ProtoArrayError("best node not viable for head")
        return self.cols.root_bytes(best)

    # -- pruning -------------------------------------------------------------

    def maybe_prune(self, finalized_root: bytes) -> None:
        fin_idx = self.cols.indices.get(bytes(finalized_root))
        if fin_idx is None or fin_idx < self.prune_threshold:
            return
        # Buffered votes reference node indices: merge them into the
        # latest-message columns first (merge order is flush-point
        # invariant), then remap like the host.
        self._flush_votes()
        old = self.cols
        n = old.n
        remap = np.full(n + 1, -1, np.int32)
        remap[fin_idx:n] = np.arange(n - fin_idx, dtype=np.int32)
        new = NodeColumns(capacity=max(n - fin_idx, 8))
        for i in range(fin_idx, n):
            p = int(old.parent[i])
            p = -1 if p < 0 or remap[p] < 0 else int(remap[p])
            j = new.append(
                slot=int(old.slot[i]), root=old.root_bytes(i), parent=p,
                state_root=old.state_roots[i].tobytes(),
                justified_epoch=int(old.justified_epoch[i]),
                justified_root=old.justified_roots[i].tobytes(),
                finalized_epoch=int(old.finalized_epoch[i]),
                finalized_root=old.finalized_roots[i].tobytes(),
                execution_status=int(old.exec_status[i]),
                execution_block_hash=old.exec_hash[i])
            new.weight[j] = old.weight[i]
            for col in ("best_child", "best_desc"):
                v = int(getattr(old, col)[i])
                getattr(new, col)[j] = -1 if v < 0 or remap[v] < 0 \
                    else int(remap[v])
        self.cols = new
        self.votes_store.remap(remap)
        self._topo_version += 1
        self._mirror = None  # full rematerialize on the next device round

    # -- execution status (optimistic sync) ----------------------------------

    def on_valid_execution_payload(self, root: bytes) -> None:
        idx = self.cols.indices.get(bytes(root))
        while idx is not None and idx >= 0:
            st = int(self.cols.exec_status[idx])
            if st == EXEC_INVALID:
                raise ProtoArrayError("valid payload above invalid ancestor")
            if st in (EXEC_VALID, EXEC_IRRELEVANT):
                break
            self.cols.exec_status[idx] = EXEC_VALID
            p = int(self.cols.parent[idx])
            idx = None if p < 0 else p

    def on_invalid_execution_payload(self, root: bytes) -> None:
        """Invalidate a node and every descendant — one masked OR per tree
        level below it (weights stay; the next score pass computes
        ``d = -weight`` and propagates the removal to ancestors)."""
        start = self.cols.indices.get(bytes(root))
        if start is None:
            return
        n = self.cols.n
        inv = np.zeros(n, bool)
        inv[start] = True
        parent = self.cols.parent
        for lvl in range(int(self.cols.depth[start]) + 1,
                         self.cols.max_depth() + 1):
            c = self.cols.levels()[lvl]
            pc = parent[c]
            m = (pc >= 0) & inv[pc]
            inv[c[m]] = True
        self.cols.exec_status[:n][inv] = EXEC_INVALID

    # -- host interop ---------------------------------------------------------

    def to_host(self) -> ProtoArrayForkChoice:
        """Bit-exact host snapshot (persistence + differential oracle)."""
        self._flush_votes()
        pa = ProtoArrayForkChoice(prune_threshold=self.prune_threshold)
        pa.nodes = self.cols.export_nodes()
        pa.indices = dict(self.cols.indices)
        v = self.votes_store
        pa.votes = VoteTracker(v.current.copy(), v.next.copy(),
                               v.next_epoch.copy())
        pa.old_balances = self.old_balances.copy()
        pa.equivocating = set(v.equivocating)
        pa.justified_checkpoint = self.justified_checkpoint
        pa.finalized_checkpoint = self.finalized_checkpoint
        pa.prev_boost_root = self.prev_boost_root
        pa.prev_boost_score = self.prev_boost_score
        return pa

    @classmethod
    def from_host(cls, pa: ProtoArrayForkChoice,
                  engine: Optional[str] = None
                  ) -> "DeviceProtoArrayForkChoice":
        self = cls(prune_threshold=pa.prune_threshold, engine=engine)
        for node in pa.nodes:
            i = self.cols.append(
                slot=node.slot, root=node.root,
                parent=-1 if node.parent is None else node.parent,
                state_root=node.state_root,
                justified_epoch=node.justified_epoch,
                justified_root=node.justified_root,
                finalized_epoch=node.finalized_epoch,
                finalized_root=node.finalized_root,
                execution_status=node.execution_status,
                execution_block_hash=node.execution_block_hash)
            self.cols.weight[i] = node.weight
            self.cols.best_child[i] = \
                -1 if node.best_child is None else node.best_child
            self.cols.best_desc[i] = \
                -1 if node.best_descendant is None else node.best_descendant
        v = self.votes_store
        v.current = pa.votes.current.copy()
        v.next = pa.votes.next.copy()
        v.next_epoch = pa.votes.next_epoch.copy()
        v.equivocating = set(pa.equivocating)
        self.old_balances = pa.old_balances.copy()
        self.justified_checkpoint = pa.justified_checkpoint
        self.finalized_checkpoint = pa.finalized_checkpoint
        self.prev_boost_root = pa.prev_boost_root
        self.prev_boost_score = pa.prev_boost_score
        self._topo_version += 1
        return self


class _DeviceDeltasMarker:
    """Sentinel: deltas live on device, fused into apply_score_changes."""

    def __len__(self):  # defensive: host apply on a device marker
        raise ProtoArrayError("device deltas on a numpy engine")


_DEVICE_DELTAS = _DeviceDeltasMarker()
