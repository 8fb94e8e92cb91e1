"""Greedy weighted maximum-coverage — the block-packing core
(``beacon_node/operation_pool/src/max_cover.rs:11-53``).

The classic (1 − 1/e) greedy: repeatedly take the candidate with the
highest remaining weight, then strike its covered elements out of every
other candidate.  The core runs over flat CSR arrays with a packed-uint64
coverage bitset (one bit per element) — per-key Python dicts made the
backlogged-pool shapes (BASELINE row 5) pack in dict time, not numpy
time.  The public :func:`maximum_cover` still honours the reference's
``MaxCover`` dict protocol (``covering_set`` / ``update_covering_set``)
for arbitrary hashable keys; items may instead expose ``cover_elements()``
→ ``(int64 elements, int64 weights)`` to skip the dict round-trip.
"""

from __future__ import annotations

from typing import Dict, Hashable, List, Protocol, Tuple

import numpy as np


class MaxCoverItem(Protocol):
    """`MaxCover` trait: an object with a covering-set weight map."""

    def covering_set(self) -> Dict[Hashable, int]:
        ...

    def update_covering_set(self, covered: Dict[Hashable, int]) -> None:
        ...


def _covered_bits(covered: np.ndarray, elems: np.ndarray) -> np.ndarray:
    """Gather the coverage bit of each element from the packed bitset."""
    return ((covered[elems >> 6] >> (elems & 63).astype(np.uint64))
            & np.uint64(1)).astype(bool)


def greedy_pack(flat_e: np.ndarray, flat_w: np.ndarray, offsets: np.ndarray,
                n_elements: int, limit: int
                ) -> Tuple[List[int], List[np.ndarray], np.ndarray]:
    """Greedy max-cover over CSR candidate→element lists.

    ``flat_e``: int64 element ids in ``[0, n_elements)``, grouped by
    candidate; ``flat_w``: the element weights; ``offsets``: ``(N+1,)``
    segment bounds.  Returns ``(chosen candidate ids in selection order,
    per-choice array of elements still uncovered at selection, the final
    packed coverage bitset)``.  Ties break toward the earliest candidate,
    matching the reference's first-maximal scan.
    """
    import heapq

    N = offsets.shape[0] - 1
    cs = np.zeros(flat_w.shape[0] + 1, dtype=np.int64)
    np.cumsum(flat_w, out=cs[1:])
    weights = cs[offsets[1:]] - cs[offsets[:-1]]
    covered = np.zeros((n_elements + 63) // 64, dtype=np.uint64)
    # Lazy exact greedy (CELF): cached weights are upper bounds (coverage
    # only removes weight), so popping the heap top, re-evaluating it
    # against the CURRENT bitset, and accepting iff its weight did not
    # drop selects exactly the eager greedy's (max weight, earliest index)
    # winner each round — without maintaining an element→candidate
    # reverse index or re-scoring every touched candidate per round.
    heap = [(-int(w), i) for i, w in enumerate(weights) if w > 0]
    heapq.heapify(heap)
    chosen: List[int] = []
    live_at_sel: List[np.ndarray] = []
    while heap and len(chosen) < limit:
        neg_w, b = heapq.heappop(heap)
        elems = flat_e[offsets[b]:offsets[b + 1]]
        fresh = ~_covered_bits(covered, elems)
        w_now = int(flat_w[offsets[b]:offsets[b + 1]][fresh].sum())
        if w_now <= 0:
            continue
        if heap and w_now < -heap[0][0]:
            heapq.heappush(heap, (-w_now, b))
            continue
        if heap and w_now == -heap[0][0] and heap[0][1] < b:
            # An equal-weight upper bound with a smaller index must get
            # the first claim at this weight level.
            heapq.heappush(heap, (-w_now, b))
            continue
        new = elems[fresh]
        chosen.append(b)
        live_at_sel.append(new)
        np.bitwise_or.at(covered, new >> 6,
                         np.uint64(1) << (new & 63).astype(np.uint64))
    return chosen, live_at_sel, covered


def maximum_cover(items: List, limit: int) -> List:
    """Pick ≤ ``limit`` items maximising total covered weight
    (`max_cover.rs` ``maximum_cover()``).

    Items exposing ``cover_elements()`` feed the packed core directly;
    dict-protocol items are converted once (keys compacted to element
    ids) and receive ``update_covering_set`` calls afterwards so their
    external covering-set state matches the round-by-round contract:
    a chosen item loses the elements covered before its selection, a
    non-chosen item loses every covered element.
    """
    if not items:
        return []
    elem_arrays: List[np.ndarray] = []
    weight_arrays: List[np.ndarray] = []
    key_id: Dict[Hashable, int] = {}
    id_key: List[Hashable] = []
    any_dicts = False
    for it in items:
        fast = getattr(it, "cover_elements", None)
        if fast is not None:
            e, w = fast()
            elem_arrays.append(np.asarray(e, dtype=np.int64))
            weight_arrays.append(np.asarray(w, dtype=np.int64))
            continue
        any_dicts = True
        cs = it.covering_set()
        ids = np.empty(len(cs), dtype=np.int64)
        ws = np.empty(len(cs), dtype=np.int64)
        for j, (k, w) in enumerate(cs.items()):
            i = key_id.get(k)
            if i is None:
                i = key_id[k] = len(id_key)
                id_key.append(k)
            ids[j] = i
            ws[j] = w
        elem_arrays.append(ids)
        weight_arrays.append(ws)
    if any_dicts and any(getattr(it, "cover_elements", None) is not None
                         for it in items):
        raise TypeError("maximum_cover: cannot mix dict-protocol and "
                        "array-interface items (element id spaces differ)")
    flat_e = (np.concatenate(elem_arrays) if elem_arrays
              else np.zeros(0, np.int64))
    flat_w = (np.concatenate(weight_arrays) if weight_arrays
              else np.zeros(0, np.int64))
    counts = np.fromiter((a.shape[0] for a in elem_arrays), np.int64,
                         len(elem_arrays))
    offsets = np.zeros(len(items) + 1, dtype=np.int64)
    np.cumsum(counts, out=offsets[1:])
    n_elements = int(flat_e.max()) + 1 if flat_e.size else 0
    chosen, live_at_sel, covered = greedy_pack(flat_e, flat_w, offsets,
                                               n_elements, limit)
    if any_dicts and chosen:
        covered_ids = np.flatnonzero(
            _covered_bits(covered, np.arange(n_elements, dtype=np.int64)))
        covered_all = {id_key[i]: 0 for i in covered_ids}
        chosen_set = dict(zip(chosen, live_at_sel))
        for i, it in enumerate(items):
            live = chosen_set.get(i)
            if live is not None:
                # Chosen: strike only what was covered BEFORE selection.
                seg = elem_arrays[i]
                dead = seg[~np.isin(seg, live)]
                removed = {id_key[e]: 0 for e in dead}
            else:
                removed = covered_all
            if removed:
                it.update_covering_set(removed)
    return [items[b] for b in chosen]
