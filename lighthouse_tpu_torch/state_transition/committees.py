"""Committee cache: one whole-epoch shuffle serving every lookup.

Counterpart of the reference's ``CommitteeCache``
(``consensus/types/src/beacon_state/committee_cache.rs``):
the active-index list is shuffled ONCE per (state, epoch) with the
vectorized swap-or-not shuffle, and every ``get_beacon_committee`` call is a
slice of the cached permutation — the same ~250x trick the reference credits
its ``shuffle_list`` with (``swap_or_not_shuffle/src/compute_shuffled_index.rs:11``).
Caches attach to the state object lazily and are dropped by ``copy()``
(fresh states recompute, mirroring ``BeaconState``'s non-SSZ cache fields).
"""

from __future__ import annotations

import numpy as np

from ..common.metrics import REGISTRY
from ..types.chain_spec import Domain
from .helpers import (
    compute_epoch_at_slot,
    compute_start_slot_at_epoch,
    current_epoch,
    get_active_validator_indices,
    get_seed,
    sha,
)
from .shuffle import compute_proposer_index, shuffled_positions


class CommitteeCache:
    """Shuffling for one epoch: ``shuffled[i] = active[perm[i]]``."""

    def __init__(self, state, epoch: int, preset):
        self.epoch = epoch
        self.active = get_active_validator_indices(state.validators, epoch)
        self.seed = get_seed(state, epoch, Domain.BEACON_ATTESTER, preset)
        perm = shuffled_positions(len(self.active), self.seed,
                                  preset.SHUFFLE_ROUND_COUNT)
        self.shuffled = self.active[perm.astype(np.int64)]
        self.committees_per_slot = committees_per_slot_count(
            len(self.active), preset)
        self.slots_per_epoch = preset.SLOTS_PER_EPOCH

    def committee(self, slot: int, index: int) -> np.ndarray:
        """``get_beacon_committee`` slice (spec ``compute_committee``)."""
        count = self.committees_per_slot * self.slots_per_epoch
        i = (slot % self.slots_per_epoch) * self.committees_per_slot + index
        n = len(self.shuffled)
        start = n * i // count
        end = n * (i + 1) // count
        return self.shuffled[start:end]

    def committees_at_slot(self, slot: int) -> list[np.ndarray]:
        return [self.committee(slot, i)
                for i in range(self.committees_per_slot)]


def committees_per_slot_count(active_count: int, preset) -> int:
    return max(1, min(
        preset.MAX_COMMITTEES_PER_SLOT,
        active_count // preset.SLOTS_PER_EPOCH // preset.TARGET_COMMITTEE_SIZE))


# Shuffle-cache observability: every whole-epoch shuffle costs a full
# active-set permutation, and until now the cache was blind — a
# hit-rate collapse (state copies dropping caches, committee churn)
# was invisible.  Bounded cardinality: one family, two outcomes.
_SHUFFLE_CACHE_REQS = REGISTRY.counter(
    "shuffle_cache_requests_total",
    "whole-epoch committee shuffle cache lookups",
    labelnames=("outcome",))


def get_committee_cache(state, epoch: int, preset) -> CommitteeCache:
    """Relative-epoch cache (previous/current/next), attached to the state
    like the reference's ``committee_caches`` field
    (``types/src/beacon_state.rs:338`` area)."""
    caches = getattr(state, "_committee_caches", None)
    if caches is None:
        caches = {}
        state._committee_caches = caches
    cache = caches.get(epoch)
    if cache is None:
        cur = current_epoch(state, preset)
        if not cur - 1 <= epoch <= cur + 1:
            raise ValueError(
                f"committee cache only covers epochs {cur - 1}..{cur + 1}, "
                f"requested {epoch}")
        _SHUFFLE_CACHE_REQS.labels("miss").inc()
        cache = CommitteeCache(state, epoch, preset)
        caches[epoch] = cache
    else:
        _SHUFFLE_CACHE_REQS.labels("hit").inc()
    return cache


def get_beacon_committee(state, slot: int, index: int, preset) -> np.ndarray:
    epoch = compute_epoch_at_slot(slot, preset.SLOTS_PER_EPOCH)
    return get_committee_cache(state, epoch, preset).committee(slot, index)


def get_committee_count_per_slot(state, epoch: int, preset) -> int:
    return get_committee_cache(state, epoch, preset).committees_per_slot


def get_beacon_proposer_index(state, preset, slot: int | None = None) -> int:
    """Spec ``get_beacon_proposer_index`` (per-slot seed + balance-weighted
    sampling).  Memoized per (slot) like ``ConsensusContext``
    (``state_processing/src/consensus_context.rs:12-49``)."""
    if slot is None:
        slot = state.slot
    memo = getattr(state, "_proposer_memo", None)
    if memo is None:
        memo = {}
        state._proposer_memo = memo
    if slot in memo:
        return memo[slot]
    epoch = compute_epoch_at_slot(slot, preset.SLOTS_PER_EPOCH)
    seed = sha(get_seed(state, epoch, Domain.BEACON_PROPOSER, preset)
               + int(slot).to_bytes(8, "little"))
    indices = get_active_validator_indices(state.validators, epoch)
    proposer = compute_proposer_index(
        state.validators.col("effective_balance"), indices, seed,
        preset.SHUFFLE_ROUND_COUNT, preset.MAX_EFFECTIVE_BALANCE)
    memo[slot] = proposer
    return proposer


def get_attesting_indices(state, data, aggregation_bits, preset) -> np.ndarray:
    """Committee members whose aggregation bit is set
    (``state_processing/src/common/get_attesting_indices.rs``)."""
    committee = get_beacon_committee(state, data.slot, data.index, preset)
    bits = np.asarray(aggregation_bits, dtype=bool)
    if bits.shape[0] != len(committee):
        raise ValueError("aggregation bitlist length != committee size")
    return committee[bits]


def compute_subnet_for_attestation(state, att_data, preset) -> int:
    """Gossip subnet of an unaggregated attestation
    (spec `compute_subnet_for_attestation`; the reference's
    `lighthouse_network` subnet_id) — committee offset within the epoch
    modulo the 64 attestation subnets."""
    slot = int(att_data.slot)
    committees_per_slot = get_committee_count_per_slot(
        state, slot // preset.SLOTS_PER_EPOCH, preset)
    slots_since_epoch_start = slot % preset.SLOTS_PER_EPOCH
    committees_since_epoch_start = committees_per_slot * slots_since_epoch_start
    return int((committees_since_epoch_start + int(att_data.index))
               % preset.ATTESTATION_SUBNET_COUNT)
