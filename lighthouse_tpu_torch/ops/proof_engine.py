"""Device Merkle-proof engine — batched branch extraction, zero re-hashing.

Port of ``lighthouse_tpu/ops/proof_engine.py``.  :mod:`.device_tree`
keeps every level of a tree on the device for the per-slot roots; a
Merkle *branch* is not a computation over that tree but a **read** of
nodes it already holds.  So the engine never hashes.  Given one or many
SSZ generalized indices it

1. maps every needed sibling gindex to its ``(level, index)`` coordinate
   in the :class:`~.device_tree.DeviceTree` layout (level ``j`` node
   ``i`` has gindex ``2^(depth-j) + i``),
2. deduplicates the union of sibling sets across the whole batch (shared
   upper siblings are read once — the spec's multiproof
   ``get_helper_indices`` idea),
3. copies the per-level index vectors to the device in one transfer
   (each padded to a power-of-two bucket, like the scatter path), reads
   each level's rows with one ``index_select``, drops the padding and
   concatenates the rows, and
4. pulls them in ONE device→host copy of 32 bytes per distinct node,
   accounted to the ``proof_engine`` ledger subsystem.

On top sits :class:`ProofServer`: it builds (and LRU-caches) the state's
**field-root tree** from the incremental tree-hash cache's field layer,
deduplicates concurrent builds of one state's tree, micro-batches
concurrent requests (window ``LIGHTHOUSE_TPU_PROOF_WINDOW_MS``, early
dispatch at ``LIGHTHOUSE_TPU_PROOF_MAX_BATCH`` distinct gindices) and
coalesces identical ``(state_root, gindex)`` requests.

Unlike the JAX package, a failed device gather raises: it never turns
quietly into the host walk.  The host hash walk runs only under
``LIGHTHOUSE_TPU_PROOF_DEVICE=0``, as the differential oracle.
"""

from __future__ import annotations

import hashlib
import threading
import time
from collections import OrderedDict
from typing import Dict, List, Optional, Sequence, Set, Tuple

import numpy as np
import torch

from ..common.device_ledger import LEDGER
from ..common.metrics import Histogram
from ..device import to_device, to_host
from .device_tree import DeviceTree, _bucket
from .merkle import ZERO_HASHES_BYTES, _next_pow2

# ---------------------------------------------------------------------------
# Generalized-index arithmetic (ssz/merkle-proofs spec helpers)
# ---------------------------------------------------------------------------


def branch_gindices(gindex: int) -> List[int]:
    """Sibling gindices proving ``gindex`` against the root, bottom-up
    (the spec's ``get_branch_indices`` without the trailing root)."""
    out = []
    g = int(gindex)
    while g > 1:
        out.append(g ^ 1)
        g >>= 1
    return out


def path_gindices(gindex: int) -> List[int]:
    """``gindex`` and every ancestor below the root."""
    out = []
    g = int(gindex)
    while g > 1:
        out.append(g)
        g >>= 1
    return out


def helper_gindices(gindices: Sequence[int]) -> List[int]:
    """The deduplicated multiproof helper set (spec
    ``get_helper_indices``): every sibling any branch needs that is not
    itself on (or derivable from) a proven path, sorted descending."""
    helpers: Set[int] = set()
    paths: Set[int] = set()
    for g in gindices:
        helpers.update(branch_gindices(g))
        paths.update(path_gindices(g))
    return sorted(helpers - paths, reverse=True)


def verify_merkle_multiproof(leaves: Sequence[bytes], proof: Sequence[bytes],
                             gindices: Sequence[int], root: bytes) -> bool:
    """Spec ``calculate_multi_merkle_root`` check: fold ``leaves`` at
    ``gindices`` with the helper ``proof`` nodes up to gindex 1."""
    helpers = helper_gindices(gindices)
    if len(leaves) != len(gindices) or len(proof) != len(helpers):
        return False
    objects: Dict[int, bytes] = dict(zip((int(g) for g in gindices), leaves))
    objects.update(zip(helpers, proof))
    keys = sorted(objects, reverse=True)
    pos = 0
    while pos < len(keys):
        k = keys[pos]
        if k in objects and k ^ 1 in objects and k >> 1 not in objects:
            objects[k >> 1] = hashlib.sha256(
                objects[k & ~1] + objects[k | 1]).digest()
            keys.append(k >> 1)
        pos += 1
    return objects.get(1) == root


def _validate_gindices(gindices: Sequence[int], depth: int) -> List[int]:
    """Malformed requests raise ``ValueError`` (the HTTP 400 contract):
    every gindex must address a node of a depth-``depth`` tree."""
    out = []
    for g in gindices:
        g = int(g)
        if g < 1 or g >= (1 << (depth + 1)):
            raise ValueError(
                f"gindex {g} outside a depth-{depth} tree (want 1 <= g "
                f"< {1 << (depth + 1)})")
        out.append(g)
    return out


# ---------------------------------------------------------------------------
# The device extraction core
# ---------------------------------------------------------------------------


def _pad_indices(idx: np.ndarray) -> np.ndarray:
    """Bucket-pad a gather index vector by repeating the first entry (the
    scatter path's ``pad_bucket`` idiom, index-only)."""
    k = idx.shape[0]
    b = _bucket(k)
    out = np.empty(b, dtype=np.int64)
    out[:k] = idx
    out[k:] = idx[0]
    return out


class DeviceProofEngine:
    """Branch extraction over one :class:`DeviceTree`'s resident levels.

    Pure gather — the engine contains no hash call.  Every node of the
    padded tree is resident (zero-padding subtrees are computed and stored
    at materialization), so any sibling a branch needs is a row read,
    byte-equal to the host ``ZERO_HASHES`` padding by construction.
    """

    def __init__(self, tree: DeviceTree):
        self.tree = tree
        self.depth = len(tree.levels) - 1

    def _coord(self, gindex: int) -> Tuple[int, int]:
        """gindex → (DeviceTree level, index within the level)."""
        d = gindex.bit_length() - 1
        return self.depth - d, gindex - (1 << d)

    def extract_nodes(self, gindices: Sequence[int]) -> Dict[int, bytes]:
        """The 32-byte nodes at ``gindices``: one index copy, one
        ``index_select`` per level, one device→host copy for the whole
        (deduplicated) set."""
        need = sorted({int(g) for g in gindices})
        if not need:
            return {}
        _validate_gindices(need, self.depth)
        per_level: Dict[int, List[int]] = {}
        for g in need:
            lv, ix = self._coord(g)
            per_level.setdefault(lv, []).append(ix)
        levels_used = sorted(per_level)
        padded = [_pad_indices(np.asarray(per_level[lv], dtype=np.int64))
                  for lv in levels_used]
        with LEDGER.attribute("proof_engine"):
            t0 = time.perf_counter()
            idx_dev = to_device(np.concatenate(padded))
            rows, at = [], 0
            for lv, pad in zip(levels_used, padded):
                sel = idx_dev[at:at + pad.shape[0]]
                at += pad.shape[0]
                rows.append(self.tree.levels[lv].index_select(0, sel)[
                    :len(per_level[lv])])
            host = to_host(torch.cat(rows, 0))      # 32 B a distinct node
            LEDGER.note_dispatch("proof_engine",
                                 (time.perf_counter() - t0) * 1e3)
        raw = host.astype(">u4").tobytes()
        out: Dict[int, bytes] = {}
        j = 0
        for lv in levels_used:
            for ix in per_level[lv]:
                out[(1 << (self.depth - lv)) + ix] = raw[32 * j:32 * j + 32]
                j += 1
        return out

    def branches(self, gindices: Sequence[int]) -> Dict[int, List[bytes]]:
        """Single proofs for each requested gindex; the union of sibling
        sets is read in one gather (shared uppers deduplicated)."""
        gs = _validate_gindices(gindices, self.depth)
        need: Set[int] = set()
        for g in gs:
            need.update(branch_gindices(g))
        nodes = self.extract_nodes(need)
        return {g: [nodes[s] for s in branch_gindices(g)] for g in gs}

    def multiproof(self, gindices: Sequence[int]
                   ) -> Tuple[List[bytes], List[bytes], List[int]]:
        """Deduplicated multiproof: ``(leaves, helpers, helper_gindices)``
        in the spec's descending helper order, verifiable with
        :func:`verify_merkle_multiproof`."""
        gs = _validate_gindices(gindices, self.depth)
        helpers = helper_gindices(gs)
        nodes = self.extract_nodes(list(gs) + helpers)
        return ([nodes[g] for g in gs], [nodes[h] for h in helpers],
                helpers)


# ---------------------------------------------------------------------------
# The serving layer
# ---------------------------------------------------------------------------


def _field_roots(state) -> List[bytes]:
    """Per-field roots in FIELDS order, from the incremental tree-hash
    cache's container-fold layer when the state carries one (a
    ``tree_hash_root()`` call refreshes the layer diff-only, so repeated
    proof requests against one state do not re-hash every field); else
    each field's root (the JAX package's ``light_client._field_roots``)."""
    thc = state.__dict__.get("_thc") if hasattr(state, "__dict__") else None
    if thc is not None or hasattr(state, "tree_hash_root"):
        try:
            state.tree_hash_root()  # incremental; refreshes field_layer
            layer = state.__dict__["_thc"].field_layer
            if layer is not None:
                return list(layer)
        except (AttributeError, KeyError, TypeError):
            pass
    return [ftype.hash_tree_root(getattr(state, fname))
            for fname, ftype in type(state).FIELDS.items()]


def _field_plane(field_roots: Sequence[bytes]) -> np.ndarray:
    """``(w, 8)`` u32 leaf plane over the state's field roots, zero-chunk
    padded to the container's power-of-two width (identical to the SSZ
    container fold's padding, so the tree root IS the state root)."""
    w = _next_pow2(max(len(field_roots), 1))
    rows = list(field_roots) + [ZERO_HASHES_BYTES[0]] * (w - len(field_roots))
    return (np.frombuffer(b"".join(rows), dtype=">u4")
            .astype(np.uint32).reshape(w, 8))


class _Batch:
    """One micro-batch window's pending gindex set for one state."""

    __slots__ = ("gindices", "done", "full", "nodes", "error")

    def __init__(self):
        self.gindices: Set[int] = set()
        self.done = threading.Event()
        self.full = threading.Event()
        self.nodes: Optional[Dict[int, bytes]] = None
        self.error: Optional[BaseException] = None


class ProofServer:
    """Micro-batching proof service over per-state field-root trees.

    Concurrent requests against the same state root that arrive within
    the batching window ride ONE device dispatch: the first requester
    becomes the window's leader (it waits out the window, then extracts
    the union gindex set); followers enqueue and block on the batch's
    completion event.  Identical gindices are coalesced by the set
    union — ``coalesced`` counts request-gindices that were already
    pending.  Field-root trees are cached per state root (small LRU;
    one ~1 KB host→device materialization per new head state).
    ``chain`` is optional (a ``BeaconChain`` serves its own proofs
    through ``chain.proof_server``).
    """

    def __init__(self, chain=None, window_ms: Optional[float] = None,
                 max_batch: Optional[int] = None, cache_states: int = 4):
        from ..common.knobs import knob_float, knob_int
        self.chain = chain
        self.window_s = (knob_float("LIGHTHOUSE_TPU_PROOF_WINDOW_MS")
                         if window_ms is None else float(window_ms)) / 1e3
        self.max_batch = (knob_int("LIGHTHOUSE_TPU_PROOF_MAX_BATCH")
                          if max_batch is None else int(max_batch))
        self._lock = threading.Lock()
        self._engines: "OrderedDict[bytes, DeviceProofEngine]" = \
            OrderedDict()
        self._building: Dict[bytes, threading.Event] = {}
        self._cache_states = cache_states
        self._batches: Dict[bytes, _Batch] = {}
        self.requests = 0
        self.coalesced = 0
        self.dispatches = 0
        self.gindices_dispatched = 0
        self.device_served = 0
        self.host_served = 0
        # Local (unregistered) latency histogram — the proof_serve_ms
        # SLO feed; bounds bracket the 50 ms budget.
        self._hist = Histogram(
            "proof_serve_seconds_local", "",
            buckets=(0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1,
                     0.25, 0.5, 1.0))

    # -- feeds / panels ------------------------------------------------------

    def latency_snapshot(self):
        return self._hist.snapshot()

    def stats(self) -> dict:
        with self._lock:
            d = {
                "requests": self.requests,
                "coalesced": self.coalesced,
                "dispatches": self.dispatches,
                "gindices_dispatched": self.gindices_dispatched,
                "device_served": self.device_served,
                "host_served": self.host_served,
                "cached_state_trees": len(self._engines),
            }
        d["gindices_per_dispatch"] = (
            round(d["gindices_dispatched"] / d["dispatches"], 2)
            if d["dispatches"] else None)
        return d

    # -- state plumbing ------------------------------------------------------

    @staticmethod
    def _state_depth(state) -> int:
        return _next_pow2(max(len(type(state).FIELDS), 1)).bit_length() - 1

    @staticmethod
    def _field_roots(state) -> List[bytes]:
        return _field_roots(state)

    def _engine_for(self, state) -> Tuple[DeviceProofEngine, bytes]:
        root = bytes(state.tree_hash_root())
        while True:
            with self._lock:
                eng = self._engines.get(root)
                if eng is not None:
                    self._engines.move_to_end(root)
                    return eng, root
                # Per-root build dedup: concurrent first requests for
                # the same state root must pay ONE materialization,
                # not one each (the losers' trees would be discarded by
                # the LRU insert but still billed to the ledger budget).
                ev = self._building.get(root)
                if ev is None:
                    ev = self._building[root] = threading.Event()
                    builder = True
                else:
                    builder = False
            if not builder:
                ev.wait()
                continue  # re-check the cache (or take over on failure)
            try:
                plane = _field_plane(self._field_roots(state))
                with LEDGER.attribute("proof_engine"):
                    tree = DeviceTree.from_host_leaves(plane)
                eng = DeviceProofEngine(tree)
                with self._lock:
                    self._engines[root] = eng
                    while len(self._engines) > self._cache_states:
                        self._engines.popitem(last=False)
                return eng, root
            finally:
                with self._lock:
                    del self._building[root]
                ev.set()

    # -- micro-batching ------------------------------------------------------

    def _batched_nodes(self, root: bytes, engine: DeviceProofEngine,
                       need: Set[int]) -> Dict[int, bytes]:
        with self._lock:
            batch = self._batches.get(root)
            leader = batch is None or batch.done.is_set()
            if leader:
                batch = _Batch()
                self._batches[root] = batch
            self.coalesced += len(need & batch.gindices)
            batch.gindices |= need
            if len(batch.gindices) >= self.max_batch:
                batch.full.set()
        if leader:
            if self.window_s > 0:
                batch.full.wait(self.window_s)
            with self._lock:
                if self._batches.get(root) is batch:
                    del self._batches[root]
                gs = sorted(batch.gindices)
            try:
                batch.nodes = engine.extract_nodes(gs)
                with self._lock:
                    self.dispatches += 1
                    self.gindices_dispatched += len(gs)
            except BaseException as e:  # noqa: BLE001 — relayed to waiters
                batch.error = e
            finally:
                batch.done.set()
        else:
            batch.done.wait(timeout=self.window_s * 10 + 15.0)
        if batch.error is not None:
            raise batch.error
        if batch.nodes is None:
            raise TimeoutError("proof batch dispatch timed out")
        return batch.nodes

    # -- node sourcing (device | host oracle) --------------------------------

    def _host_levels(self, state) -> List[List[bytes]]:
        """The differential-oracle walk: hashlib-fold the cached
        field-root layer (the ONLY hashing on the serving plane, and only
        under ``LIGHTHOUSE_TPU_PROOF_DEVICE=0``)."""
        roots = self._field_roots(state)
        w = _next_pow2(max(len(roots), 1))
        levels = [list(roots) + [ZERO_HASHES_BYTES[0]] * (w - len(roots))]
        while len(levels[-1]) > 1:
            lv = levels[-1]
            levels.append([hashlib.sha256(lv[i] + lv[i + 1]).digest()
                           for i in range(0, len(lv), 2)])
        return levels

    def _host_nodes(self, state, need: Set[int]) -> Dict[int, bytes]:
        levels = self._host_levels(state)
        depth = len(levels) - 1
        out = {}
        for g in need:
            d = g.bit_length() - 1
            out[g] = levels[depth - d][g - (1 << d)]
        return out

    def _serve(self, state, need: Set[int]) -> Dict[int, bytes]:
        from ..common.knobs import knob_bool
        if knob_bool("LIGHTHOUSE_TPU_PROOF_DEVICE"):
            engine, root = self._engine_for(state)
            nodes = self._batched_nodes(root, engine, need)
            with self._lock:
                self.device_served += 1
            return nodes
        nodes = self._host_nodes(state, need)
        with self._lock:
            self.host_served += 1
        return nodes

    # -- the public serving surface ------------------------------------------

    def state_proof(self, state, gindices: Sequence[int]
                    ) -> Dict[int, List[bytes]]:
        """Branches proving each gindex of the state's field-root tree
        against the state root.  Raises ``ValueError`` on a malformed
        gindex (the route's 400)."""
        t0 = time.perf_counter()
        try:
            gs = _validate_gindices(gindices, self._state_depth(state))
            with self._lock:
                self.requests += 1
            need: Set[int] = set()
            for g in gs:
                need.update(branch_gindices(g))
            nodes = self._serve(state, need)
            return {g: [nodes[s] for s in branch_gindices(g)] for g in gs}
        finally:
            self._hist.observe(time.perf_counter() - t0)

    def state_multiproof(self, state, gindices: Sequence[int]
                         ) -> Tuple[List[bytes], List[bytes], List[int]]:
        """Deduplicated multiproof over the state's field-root tree:
        ``(leaves, helpers, helper_gindices)``."""
        t0 = time.perf_counter()
        try:
            gs = _validate_gindices(gindices, self._state_depth(state))
            with self._lock:
                self.requests += 1
            helpers = helper_gindices(gs)
            nodes = self._serve(state, set(gs) | set(helpers))
            return ([nodes[g] for g in gs], [nodes[h] for h in helpers],
                    helpers)
        finally:
            self._hist.observe(time.perf_counter() - t0)

    def field_branch(self, state, field_name: str
                     ) -> Tuple[List[bytes], int]:
        """``(branch, field index)`` proving one state field's root against
        the state root (the JAX package's ``light_client.
        state_field_proof``, read from the device tree)."""
        names = list(type(state).FIELDS)
        idx = names.index(field_name)
        g = _next_pow2(max(len(names), 1)) + idx
        return self.state_proof(state, [g])[g], idx
