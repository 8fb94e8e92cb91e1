"""Greedy max-cover for block production — the pack rounds.

Port of ``lighthouse_tpu/op_pool/device_pack.py``.  The host
:func:`~.max_cover.greedy_pack` is a lazy-exact CELF loop: pop the
heaviest cached candidate, re-evaluate it against the current coverage
bitset, accept iff its weight held up.  That loop is exactly the EAGER
greedy — each round selects the ``(max marginal weight, earliest index)``
candidate — so it reformulates as rounds with no heap:

- the candidate pool is a CSR over flat entry columns (element id,
  weight) and candidate offsets, against a packed 64-bit coverage bitset
  (``word = e >> 6``, ``bit = 1 << (e & 63)``);
- per round: one gather of the covered word per entry, a masked segment
  sum of still-fresh weights per candidate (the marginal), one ``argmax``
  (first occurrence == earliest-index tie-break, matching the CELF heap's
  ``(−w, i)`` ordering bit for bit), and a scatter-OR of the winner's
  fresh bits into the bitset.

The rounds run as torch ops on the device of the tensors they are given,
which is the port's device (:func:`_pack_rounds_torch`): the card in
production, the CPU in the tests, so the CPU and the card run one code
path.  The CSR columns are pushed once (``flat_e`` int32, ``flat_w``
int64, ``offsets``: 12 B an entry); the word, the bit pattern and the
segment id are derived on the device.  The bitset is int64 words holding
u64 bit patterns: bit 63 is the pattern ``-2**63``, and ``&`` / ``==``
read it unchanged.  The loop runs the fixed ``limit`` rounds and never
reads the device: a round whose best marginal is ≤ 0 selects the ``−1``
sentinel and leaves the bitset a fixed point, so the trailing rounds
select nothing more.  The selection comes back in one copy.  A pack on a
GPU runs there or raises: nothing repacks on the host.

Precondition (holds for every real candidate — committee members are
unique within a committee): element ids do not repeat WITHIN one
candidate's segment.  The scatter-OR is an ``index_add_`` of the
winner's fresh bits, which is only OR-exact when those bits are distinct
(and then no partial sum overflows int64: a fresh bit is never already
set in its word).

The pushed CSR columns and the pulled selection are noted to the device
ledger under the ``op_pool`` subsystem.
"""

from __future__ import annotations

import time
from typing import List, Optional

import numpy as np

__all__ = ["greedy_pack_device", "modeled_pack_ms", "reset_stats"]

# The card's device-memory rate (H100 SXM, 3.35 TB/s).  The rounds are
# bound by memory: each round has to stream every entry's element id
# (4 B; its word and bit pattern follow from it), weight (8 B) and
# segment id (4 B), and write and read back each candidate's marginal
# (8 B + 8 B) for the argmax.  The coverage bitset (n_elements / 8
# bytes: 128 KiB at 2^20 validators) stays in L2, so its gathers and the
# winner's scatter (at most one committee a round) move no HBM bytes.
HBM_BYTES_PER_S = 3.35e12
_BYTES_PER_ENTRY_ROUND = 16   # 4 B element id + 8 B weight + 4 B seg
_BYTES_PER_CAND_ROUND = 16    # marginal written + read by the argmax

# Stage timings of the LAST pack — read via
# ``tracing.stage_split("op_pool")`` only.
LAST_PACK_STATS: dict = {}


def modeled_pack_ms(entries: int, candidates: int, rounds: int,
                    bytes_per_s: float = HBM_BYTES_PER_S) -> float:
    """The least device time of the rounds at their true shape: the bytes
    streamed per round over the card's memory rate."""
    per_round = (int(entries) * _BYTES_PER_ENTRY_ROUND
                 + int(candidates) * _BYTES_PER_CAND_ROUND)
    return int(rounds) * per_round / bytes_per_s * 1e3


def reset_stats() -> None:
    """Clear the stage dict (isolating one measurement from an earlier
    pack)."""
    LAST_PACK_STATS.clear()


def _pack_rounds_torch(flat_e: np.ndarray, flat_w: np.ndarray,
                       offsets: np.ndarray, n_elements: int,
                       limit: int) -> List[int]:
    import torch

    from .. import device
    n = offsets.shape[0] - 1
    if n <= 0 or limit <= 0:
        LAST_PACK_STATS["stage_ms"] = 0.0
        return []
    entries = int(offsets[-1])
    t0 = time.perf_counter()
    e = device.to_device(np.asarray(flat_e, np.int32), "op_pool")
    w = device.to_device(np.asarray(flat_w, np.int64), "op_pool")
    off = device.to_device(np.asarray(offsets, np.int64), "op_pool")
    LAST_PACK_STATS["stage_ms"] = round((time.perf_counter() - t0) * 1e3, 3)
    dev = e.device
    LAST_PACK_STATS["device"] = str(dev)
    e64 = e.long()
    word = e64 >> 6
    bit = torch.ones_like(e64) << (e64 & 63)
    # output_size: the entry count is host-known, so no sync for it
    seg = torch.repeat_interleave(torch.arange(n, device=dev), off.diff(),
                                  output_size=entries)
    covered = torch.zeros((int(n_elements) + 63) // 64, dtype=torch.int64,
                          device=dev)
    marg = torch.empty(n, dtype=torch.int64, device=dev)
    sel = torch.full((limit,), -1, dtype=torch.int64, device=dev)
    zero = torch.zeros((), dtype=torch.int64, device=dev)
    for r in range(limit):
        fresh = (covered[word] & bit) == 0
        marg.zero_().index_add_(0, seg, torch.where(fresh, w, zero))
        win = torch.argmax(marg)        # first occurrence: earliest idx
        took = marg[win] > 0
        covered.index_add_(0, word, torch.where(took & fresh & (seg == win),
                                                bit, zero))
        sel[r] = torch.where(took, win, -1)
    picked = device.to_host(sel, "op_pool").view(np.int64)
    return [int(s) for s in picked if 0 <= s < n]


def greedy_pack_device(flat_e: np.ndarray, flat_w: np.ndarray,
                       offsets: np.ndarray, n_elements: int, limit: int,
                       csr_build_ms: Optional[float] = None,
                       coverage_ms: Optional[float] = None) -> List[int]:
    """Greedy max-cover over the CSR candidate columns.

    Same contract as the host :func:`~.max_cover.greedy_pack` (CSR in,
    chosen candidate ids in selection order out) minus the per-choice
    live-element lists the columnar caller never used.  ``csr_build_ms``
    / ``coverage_ms`` let the caller hand its upstream phase timings in
    for the ``op_pool`` stage split without writing this module's stage
    dict from outside.
    """
    t0 = time.perf_counter()
    chosen = _pack_rounds_torch(flat_e, flat_w, offsets, n_elements, limit)
    LAST_PACK_STATS["select_rounds_ms"] = round(
        (time.perf_counter() - t0) * 1e3, 3)
    if csr_build_ms is not None:
        LAST_PACK_STATS["csr_build_ms"] = round(float(csr_build_ms), 3)
    if coverage_ms is not None:
        LAST_PACK_STATS["coverage_ms"] = round(float(coverage_ms), 3)
    LAST_PACK_STATS["candidates"] = int(offsets.shape[0] - 1)
    LAST_PACK_STATS["entries"] = int(offsets[-1]) if offsets.size else 0
    LAST_PACK_STATS["rounds"] = int(limit)
    LAST_PACK_STATS["selected"] = len(chosen)
    return chosen
