"""Swap-or-not shuffle, vectorized over the whole index list.

The reference ships both a per-index ``compute_shuffled_index`` and a
~250x-faster whole-list ``shuffle_list``
(``consensus/swap_or_not_shuffle/src/``).  Here the
whole-list form IS the per-index form applied to the vector of all indices
at once with numpy: per round, one pivot hash plus ``ceil(n/256)`` source
hashes cover every index, and the swap becomes a vectorized select.  This
keeps the semantics line-for-line equal to ``compute_shuffled_index``
(trivially auditable) while shuffling ~1M indices in tens of milliseconds.
"""

from __future__ import annotations

import hashlib

import numpy as np


def _sha(data: bytes) -> bytes:
    return hashlib.sha256(data).digest()


def compute_shuffled_index(index: int, count: int, seed: bytes,
                           rounds: int) -> int:
    """Spec ``compute_shuffled_index`` (scalar ground truth)."""
    assert 0 <= index < count
    for r in range(rounds):
        pivot = int.from_bytes(_sha(seed + bytes([r]))[:8], "little") % count
        flip = (pivot + count - index) % count
        position = max(index, flip)
        source = _sha(seed + bytes([r]) + (position // 256).to_bytes(4, "little"))
        byte = source[(position % 256) // 8]
        if (byte >> (position % 8)) & 1:
            index = flip
    return index


def shuffled_positions(count: int, seed: bytes, rounds: int) -> np.ndarray:
    """``perm`` with ``perm[i] = compute_shuffled_index(i, count, seed)`` for
    all ``i``, vectorized."""
    if count == 0:
        return np.zeros(0, dtype=np.uint64)
    # uint32 lanes when indices fit (any realistic registry): the round
    # loop is memory-bandwidth bound, and half-width lanes halve it.  The
    # pivot sum pivot + n - idx lies in [pivot + 1, pivot + n] < 2^32 for
    # count ≤ 2^31, so the arithmetic stays exact.
    dt = np.uint32 if count <= (1 << 31) else np.uint64
    idx = np.arange(count, dtype=dt)
    n = dt(count)
    n_blocks = (count + 255) // 256
    for r in range(rounds):
        rb = bytes([r])
        pivot = int.from_bytes(_sha(seed + rb)[:8], "little") % count
        # (pivot + n - idx) % n without the modulo: pivot + n < 2^32 is a
        # scalar, and one masked subtract replaces the division that
        # dominated the 2^20 shuffle.
        flip = dt(pivot + count) - idx
        np.subtract(flip, n, out=flip, where=flip >= n)
        position = np.maximum(idx, flip)
        # One 32-byte source block covers 256 positions.
        sources = b"".join(
            _sha(seed + rb + b.to_bytes(4, "little")) for b in range(n_blocks))
        source_bytes = np.frombuffer(sources, dtype=np.uint8)
        byte = source_bytes[position >> dt(3)]
        bit = (byte >> (position & dt(7)).astype(np.uint8)) & 1
        idx = np.where(bit.astype(bool), flip, idx)
    return idx.astype(np.uint64)


def shuffle_list(values: np.ndarray, seed: bytes, rounds: int) -> np.ndarray:
    """Shuffled copy: ``out[compute_shuffled_index(i)] = values[i]``.

    This matches the spec orientation used by ``compute_committee``:
    ``committee[i] = indices[compute_shuffled_index(i, ...)]`` reads from the
    *unshuffled* list at shuffled positions, i.e. ``values[perm]``.
    """
    perm = shuffled_positions(len(values), seed, rounds)
    return np.asarray(values)[perm.astype(np.int64)]


def shuffled_index_batch(indices: np.ndarray, count: int, seed: bytes,
                         rounds: int) -> np.ndarray:
    """``compute_shuffled_index`` for an arbitrary SUBSET of indices at once.

    Per round: one shared pivot hash plus one source hash per DISTINCT
    256-position block the subset's positions land in — for a k-candidate
    sample that is ``rounds * (1 + distinct_blocks)`` hashes instead of the
    scalar loop's ``rounds * 2 * k`` (and the numpy select replaces the
    per-index Python).  Bit-identical to the scalar form by construction.
    """
    idx = np.asarray(indices, dtype=np.uint64).copy()
    if idx.size == 0:
        return idx
    n = np.uint64(count)
    for r in range(rounds):
        rb = bytes([r])
        pivot = np.uint64(int.from_bytes(_sha(seed + rb)[:8], "little") % count)
        flip = pivot + n - idx
        flip -= n * (flip >= n)
        position = np.maximum(idx, flip)
        blocks = (position >> np.uint64(8)).astype(np.int64)
        uniq, inv = np.unique(blocks, return_inverse=True)
        src = b"".join(_sha(seed + rb + int(b).to_bytes(4, "little"))
                       for b in uniq)
        source_bytes = np.frombuffer(src, dtype=np.uint8)
        byte = source_bytes[inv * 32
                            + ((position >> np.uint64(3))
                               & np.uint64(31)).astype(np.int64)]
        bit = (byte >> (position & np.uint64(7)).astype(np.uint8)) & 1
        idx = np.where(bit.astype(bool), flip, idx)
    return idx


def candidate_random_bytes(seed: bytes, candidate_ids: np.ndarray) -> np.ndarray:
    """Spec candidate-sampling randomness, vectorized: byte ``i % 32`` of
    ``sha(seed + uint64(i // 32))`` for each candidate counter ``i`` — one
    hash per distinct 32-candidate window."""
    ids = np.asarray(candidate_ids, dtype=np.int64)
    windows = ids // 32
    uniq, inv = np.unique(windows, return_inverse=True)
    digests = b"".join(_sha(seed + int(w).to_bytes(8, "little"))
                       for w in uniq)
    pool = np.frombuffer(digests, dtype=np.uint8)
    return pool[inv * 32 + (ids % 32)]


def sample_committee_candidates(effective_balances: np.ndarray,
                                indices: np.ndarray, seed: bytes, rounds: int,
                                max_effective_balance: int, needed: int,
                                chunk: int | None = None) -> list[int]:
    """Shuffled-order candidate sampling with effective-balance acceptance,
    vectorized in chunks — the shared core of ``compute_proposer_index`` and
    sync-committee selection (both walk the same candidate sequence; only
    ``needed`` differs).  Returns the first ``needed`` accepted validator
    indices, in acceptance order."""
    assert len(indices) > 0
    total = len(indices)
    indices = np.asarray(indices, dtype=np.int64)
    if chunk is None:
        chunk = max(8, min(512, 2 * needed))
    out: list[int] = []
    i = 0
    while len(out) < needed:
        ids = np.arange(i, i + chunk, dtype=np.int64)
        shuffled = shuffled_index_batch(
            (ids % total).astype(np.uint64), total, seed, rounds)
        cands = indices[shuffled.astype(np.int64)]
        rand = candidate_random_bytes(seed, ids).astype(np.int64)
        eff = effective_balances[cands]
        if int(eff.max(initial=0)) < (1 << 55):
            ok = eff.astype(np.int64) * 255 >= max_effective_balance * rand
        else:  # un-spec-ably large balances: exact Python-int compare
            ok = np.array([int(e) * 255 >= max_effective_balance * int(rb)
                           for e, rb in zip(eff, rand)], dtype=bool)
        accepted = cands[ok]
        out.extend(int(c) for c in accepted[:needed - len(out)])
        i += chunk
    return out


def compute_proposer_index(effective_balances: np.ndarray,
                           indices: np.ndarray, seed: bytes, rounds: int,
                           max_effective_balance: int) -> int:
    """Spec ``compute_proposer_index``: shuffled-order candidate sampling with
    effective-balance acceptance (``state_processing`` helper semantics)."""
    return sample_committee_candidates(
        effective_balances, indices, seed, rounds, max_effective_balance,
        needed=1, chunk=8)[0]
