"""Epoch processing (altair through capella), vectorized over SoA columns.

Counterpart of ``consensus/state_processing/src/
per_epoch_processing/{altair,capella}/`` and the shared steps in
``per_epoch_processing/*``.  Where the reference precomputes a
``ParticipationCache`` then loops validators (with rayon), every step here
is whole-column numpy arithmetic — the registry IS the batch.  The returned
:class:`EpochSummary` plays the role of ``epoch_processing_summary.rs``
(metrics/validator-monitor input).
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np

from ..types.chain_spec import (
    FAR_FUTURE_EPOCH,
    GENESIS_EPOCH,
    PARTICIPATION_FLAG_WEIGHTS,
    TIMELY_HEAD_FLAG_INDEX,
    TIMELY_TARGET_FLAG_INDEX,
    WEIGHT_DENOMINATOR,
    Domain,
    ForkName,
)
from .helpers import (
    compute_activation_exit_epoch,
    current_epoch,
    get_block_root,
    get_randao_mix,
    get_total_active_balance,
    is_active_at,
    previous_epoch,
)
from .mutations import initiate_validator_exit, proportional_slashing_multiplier


@dataclass
class EpochSummary:
    """Per-epoch numbers for metrics/monitoring
    (``epoch_processing_summary.rs`` analogue)."""
    total_active_balance: int = 0
    previous_target_balance: int = 0
    current_target_balance: int = 0
    activated: int = 0
    ejected: int = 0
    rewards: np.ndarray | None = None
    penalties: np.ndarray | None = None


def base_reward_per_increment(total_active_balance: int, preset) -> int:
    return (preset.EFFECTIVE_BALANCE_INCREMENT * preset.BASE_REWARD_FACTOR
            // math.isqrt(total_active_balance))


def base_rewards_column(state, total_active_balance: int, preset) -> np.ndarray:
    """Vectorized spec ``get_base_reward`` for all validators."""
    per_inc = base_reward_per_increment(total_active_balance, preset)
    increments = state.validators.col("effective_balance") // np.uint64(
        preset.EFFECTIVE_BALANCE_INCREMENT)
    return increments * np.uint64(per_inc)


def is_in_inactivity_leak(state, preset) -> bool:
    finality_delay = (previous_epoch(state, preset)
                      - state.finalized_checkpoint.epoch)
    return finality_delay > preset.MIN_EPOCHS_TO_INACTIVITY_PENALTY


# ---------------------------------------------------------------------------
# Steps
# ---------------------------------------------------------------------------

def weigh_justification_and_finalization(state, total, prev_target, cur_target,
                                         preset, T) -> None:
    cur = current_epoch(state, preset)
    prev = previous_epoch(state, preset)
    old_prev_justified = state.previous_justified_checkpoint
    old_cur_justified = state.current_justified_checkpoint

    state.previous_justified_checkpoint = state.current_justified_checkpoint
    bits = state.justification_bits
    bits[1:] = bits[:-1].copy()
    bits[0] = False
    if prev_target * 3 >= total * 2:
        state.current_justified_checkpoint = T.Checkpoint(
            epoch=prev, root=get_block_root(state, prev, preset))
        bits[1] = True
    if cur_target * 3 >= total * 2:
        state.current_justified_checkpoint = T.Checkpoint(
            epoch=cur, root=get_block_root(state, cur, preset))
        bits[0] = True

    # Finalization (the four 2nd/234th-bit rules).
    if bits[1:4].all() and old_prev_justified.epoch + 3 == cur:
        state.finalized_checkpoint = old_prev_justified
    if bits[1:3].all() and old_prev_justified.epoch + 2 == cur:
        state.finalized_checkpoint = old_prev_justified
    if bits[0:3].all() and old_cur_justified.epoch + 2 == cur:
        state.finalized_checkpoint = old_cur_justified
    if bits[0:2].all() and old_cur_justified.epoch + 1 == cur:
        state.finalized_checkpoint = old_cur_justified


def _full_column(arr, n: int, dtype) -> np.ndarray:
    out = np.zeros(n, dtype=dtype)
    out[:arr.shape[0]] = arr
    return out


def inactivity_penalty_quotient(fork: ForkName, preset) -> int:
    if fork >= ForkName.BELLATRIX:
        return preset.INACTIVITY_PENALTY_QUOTIENT_BELLATRIX
    if fork >= ForkName.ALTAIR:
        return preset.INACTIVITY_PENALTY_QUOTIENT_ALTAIR
    return preset.INACTIVITY_PENALTY_QUOTIENT


def process_registry_updates(state, preset, spec,
                             summary: EpochSummary) -> None:
    reg = state.validators
    cur = current_epoch(state, preset)

    # Eligibility for the activation queue.
    eligible = ((reg.col("activation_eligibility_epoch")
                 == np.uint64(FAR_FUTURE_EPOCH))
                & (reg.col("effective_balance")
                   == np.uint64(preset.MAX_EFFECTIVE_BALANCE)))
    reg.wcol("activation_eligibility_epoch")[eligible] = cur + 1

    # Ejections — sequential: each consumes exit churn.
    eject = (is_active_at(reg, cur)
             & (reg.col("effective_balance")
                <= np.uint64(spec.ejection_balance)))
    for idx in np.flatnonzero(eject):
        initiate_validator_exit(state, int(idx), preset, spec)
        summary.ejected += 1

    # Activation queue: ordered by (eligibility epoch, index), churn-limited.
    queue_mask = ((reg.col("activation_eligibility_epoch")
                   <= np.uint64(state.finalized_checkpoint.epoch))
                  & (reg.col("activation_epoch")
                     == np.uint64(FAR_FUTURE_EPOCH)))
    queue = np.flatnonzero(queue_mask)
    order = np.argsort(
        reg.col("activation_eligibility_epoch")[queue], kind="stable")
    queue = queue[order]
    from .helpers import get_validator_churn_limit
    churn = get_validator_churn_limit(state, preset, spec)
    dequeued = queue[:churn]
    reg.wcol("activation_epoch")[dequeued] = compute_activation_exit_epoch(
        cur, preset.MAX_SEED_LOOKAHEAD)
    summary.activated += len(dequeued)


def process_slashings(state, fork: ForkName, preset) -> None:
    cur = current_epoch(state, preset)
    total = get_total_active_balance(state, preset)
    adjusted = min(
        int(state.slashings.sum()) * proportional_slashing_multiplier(fork, preset),
        total)
    reg = state.validators
    inc = preset.EFFECTIVE_BALANCE_INCREMENT
    mask = (reg.col("slashed")
            & (cur + preset.EPOCHS_PER_SLASHINGS_VECTOR // 2
               == reg.col("withdrawable_epoch")))
    if not mask.any():
        return
    # Per-spec integer order: (eff // inc * adjusted) // total * inc.
    # increments ≤ 32 and adjusted ≤ total_balance, so the product fits u64.
    increments = reg.col("effective_balance") // np.uint64(inc)
    penalties = (increments * np.uint64(adjusted)
                 // np.uint64(total) * np.uint64(inc))
    n = len(reg)
    bal = _full_column(state.balances, n, np.uint64)
    pen = np.where(mask, penalties, np.uint64(0))
    from ..types.device_state import store_column
    store_column(state, "balances",
                 np.where(bal >= pen, bal - pen, np.uint64(0)),
                 touched=np.flatnonzero(mask))


def process_eth1_data_reset(state, preset) -> None:
    next_epoch = current_epoch(state, preset) + 1
    if next_epoch % preset.EPOCHS_PER_ETH1_VOTING_PERIOD == 0:
        state.eth1_data_votes = []


def process_effective_balance_updates(state, preset) -> None:
    reg = state.validators
    n = len(reg)
    bal = _full_column(state.balances, n, np.uint64)
    eff = reg.col("effective_balance")
    inc = np.uint64(preset.EFFECTIVE_BALANCE_INCREMENT)
    hysteresis_inc = inc // np.uint64(preset.HYSTERESIS_QUOTIENT)
    downward = hysteresis_inc * np.uint64(preset.HYSTERESIS_DOWNWARD_MULTIPLIER)
    upward = hysteresis_inc * np.uint64(preset.HYSTERESIS_UPWARD_MULTIPLIER)
    update = (bal + downward < eff) | (eff + upward < bal)
    new_eff = np.minimum(bal - bal % inc,
                         np.uint64(preset.MAX_EFFECTIVE_BALANCE))
    reg.wcol("effective_balance")[update] = new_eff[update]


def process_slashings_reset(state, preset) -> None:
    next_epoch = current_epoch(state, preset) + 1
    state.slashings[next_epoch % preset.EPOCHS_PER_SLASHINGS_VECTOR] = 0


def process_randao_mixes_reset(state, preset) -> None:
    cur = current_epoch(state, preset)
    next_epoch = cur + 1
    state.randao_mixes.set(next_epoch % preset.EPOCHS_PER_HISTORICAL_VECTOR,
                           get_randao_mix(state, cur, preset))


def process_historical_update(state, fork: ForkName, preset, T) -> None:
    """historical_roots (pre-capella) / historical_summaries (capella+)."""
    next_epoch = current_epoch(state, preset) + 1
    if next_epoch % (preset.SLOTS_PER_HISTORICAL_ROOT
                     // preset.SLOTS_PER_EPOCH) != 0:
        return
    if fork >= ForkName.CAPELLA:
        state.historical_summaries = state.historical_summaries + [
            T.HistoricalSummary(
                block_summary_root=type(state).FIELDS["block_roots"]
                .hash_tree_root(state.block_roots),
                state_summary_root=type(state).FIELDS["state_roots"]
                .hash_tree_root(state.state_roots),
            )]
    else:
        batch = T.HistoricalBatch(block_roots=state.block_roots,
                                  state_roots=state.state_roots)
        state.historical_roots = state.historical_roots.append_root(
            batch.tree_hash_root())


def process_participation_flag_updates(state) -> None:
    n = len(state.validators)
    state.previous_epoch_participation = _full_column(
        state.current_epoch_participation, n, np.uint8)
    state.current_epoch_participation = np.zeros(n, dtype=np.uint8)


def get_next_sync_committee_indices(state, preset) -> list[int]:
    """Spec sampling: shuffled candidates + effective-balance acceptance,
    vectorized in committee-sized chunks (the scalar per-candidate loop
    cost ``2 * SHUFFLE_ROUND_COUNT`` hashes per candidate)."""
    epoch = current_epoch(state, preset) + 1
    from .helpers import get_active_validator_indices, get_seed
    from .shuffle import sample_committee_candidates
    active = get_active_validator_indices(state.validators, epoch)
    seed = get_seed(state, epoch, Domain.SYNC_COMMITTEE, preset)
    eff = state.validators.col("effective_balance")
    return sample_committee_candidates(
        eff, active.astype(np.int64), seed, preset.SHUFFLE_ROUND_COUNT,
        preset.MAX_EFFECTIVE_BALANCE, needed=preset.SYNC_COMMITTEE_SIZE)


def get_next_sync_committee(state, preset, T):
    from ..crypto import bls as B
    from ..crypto import curve as C
    indices = get_next_sync_committee_indices(state, preset)
    pubkeys = [state.validators.col("pubkey")[i].tobytes() for i in indices]
    agg = None
    for pk in pubkeys:
        agg = C.g1_add(agg, C.g1_decompress(pk))
    return T.SyncCommittee(pubkeys=pubkeys, aggregate_pubkey=C.g1_compress(agg))


def process_sync_committee_updates(state, preset, T) -> None:
    next_epoch = current_epoch(state, preset) + 1
    if next_epoch % preset.EPOCHS_PER_SYNC_COMMITTEE_PERIOD == 0:
        state.current_sync_committee = state.next_sync_committee
        state.next_sync_committee = get_next_sync_committee(state, preset, T)


# ---------------------------------------------------------------------------
# Single-pass epoch processing
# ---------------------------------------------------------------------------

#: Stage timings (ms) of the most recent single-pass epoch transition —
#: bench.py's ``epoch_transition_ms`` decomposition.
LAST_EPOCH_TIMINGS: dict = {}


def _epoch_device_enabled() -> bool:
    """``LIGHTHOUSE_TPU_EPOCH_DEVICE=1`` runs the fused rewards/inactivity
    sweep as torch ops on the device (per_epoch_device); off by default."""
    from ..common.knobs import knob_bool
    return knob_bool("LIGHTHOUSE_TPU_EPOCH_DEVICE")


@dataclass
class EpochContext:
    """Everything the altair+ epoch steps re-derive from the registry,
    computed once — Lighthouse's single-pass ``EpochProcessingCache`` idea:
    each column is read one time and every mask is shared."""
    prev: int
    cur: int
    active_prev: np.ndarray
    active_cur: np.ndarray
    eligible: np.ndarray
    not_slashed: np.ndarray
    prev_part: np.ndarray
    cur_part: np.ndarray
    unslashed_prev: tuple          # per participation flag, previous epoch
    target_cur: np.ndarray
    eff: np.ndarray
    total_active_balance: int
    base: np.ndarray


def build_epoch_context(state, preset) -> EpochContext:
    reg = state.validators
    n = len(reg)
    cur = current_epoch(state, preset)
    prev = previous_epoch(state, preset)
    act = reg.col("activation_epoch")
    ext = reg.col("exit_epoch")
    wd = reg.col("withdrawable_epoch")
    slashed = reg.col("slashed")
    eff = reg.col("effective_balance")
    active_prev = (act <= prev) & (prev < ext)
    active_cur = (act <= cur) & (cur < ext)
    eligible = active_prev | (slashed & (prev + 1 < wd))
    not_slashed = ~slashed
    prev_part = _full_column(state.previous_epoch_participation, n, np.uint8)
    cur_part = _full_column(state.current_epoch_participation, n, np.uint8)
    unslashed_prev = tuple(
        active_prev & ((prev_part & np.uint8(1 << f)) != 0) & not_slashed
        for f in range(len(PARTICIPATION_FLAG_WEIGHTS)))
    target_cur = (active_cur
                  & ((cur_part & np.uint8(1 << TIMELY_TARGET_FLAG_INDEX)) != 0)
                  & not_slashed)
    total = max(int(eff[active_cur].sum()),
                preset.EFFECTIVE_BALANCE_INCREMENT)
    per_inc = base_reward_per_increment(total, preset)
    base = (eff // np.uint64(preset.EFFECTIVE_BALANCE_INCREMENT)
            ) * np.uint64(per_inc)
    return EpochContext(
        prev=prev, cur=cur, active_prev=active_prev, active_cur=active_cur,
        eligible=eligible, not_slashed=not_slashed, prev_part=prev_part,
        cur_part=cur_part, unslashed_prev=unslashed_prev,
        target_cur=target_cur, eff=eff, total_active_balance=total,
        base=base)


def _participating_balance_from(eff: np.ndarray, mask: np.ndarray,
                                preset) -> int:
    return max(int(eff[mask].sum()), preset.EFFECTIVE_BALANCE_INCREMENT)


def _fused_inactivity_and_rewards(state, fork: ForkName, preset, spec,
                                  ctx: EpochContext, summary: EpochSummary,
                                  timings: dict) -> None:
    """``process_inactivity_updates`` + ``process_rewards_and_penalties`` as
    one columnar sweep over the shared context.  Bit-identical to the
    sequential steps (incl. u64 wrap/floor-division semantics): the score
    update runs first in-register, and the inactivity penalty reads the NEW
    scores, exactly as the spec's step order does."""
    import time
    n = len(state.validators)
    if ctx.cur == GENESIS_EPOCH:
        return
    in_leak = is_in_inactivity_leak(state, preset)
    target_prev = ctx.unslashed_prev[TIMELY_TARGET_FLAG_INDEX]

    if _epoch_device_enabled():
        from . import per_epoch_device as PED
        PED.fused_sweep(state, fork, preset, spec, ctx, summary, in_leak,
                        timings)
        return

    t0 = time.perf_counter()
    scores = _full_column(state.inactivity_scores, n, np.uint64)
    dec = np.minimum(np.uint64(1), scores)
    scores = np.where(ctx.eligible & target_prev, scores - dec, scores)
    scores = np.where(ctx.eligible & ~target_prev,
                      scores + np.uint64(spec.inactivity_score_bias), scores)
    if not in_leak:
        rec = np.minimum(np.uint64(spec.inactivity_score_recovery_rate),
                         scores)
        scores = np.where(ctx.eligible, scores - rec, scores)
    from ..types.device_state import store_column
    store_column(state, "inactivity_scores", scores,
                 touched=np.flatnonzero(ctx.eligible))
    timings["inactivity_ms"] = (time.perf_counter() - t0) * 1e3

    t0 = time.perf_counter()
    rewards = np.zeros(n, dtype=np.uint64)
    penalties = np.zeros(n, dtype=np.uint64)
    active_increments = (ctx.total_active_balance
                         // preset.EFFECTIVE_BALANCE_INCREMENT)
    for flag_index, weight in enumerate(PARTICIPATION_FLAG_WEIGHTS):
        participating = ctx.unslashed_prev[flag_index]
        unslashed_increments = (
            _participating_balance_from(ctx.eff, participating, preset)
            // preset.EFFECTIVE_BALANCE_INCREMENT)
        if not in_leak:
            reward_num = (ctx.base * np.uint64(weight)
                          * np.uint64(unslashed_increments))
            rewards += np.where(
                ctx.eligible & participating,
                reward_num
                // np.uint64(active_increments * WEIGHT_DENOMINATOR),
                np.uint64(0))
        if flag_index != TIMELY_HEAD_FLAG_INDEX:
            penalties += np.where(
                ctx.eligible & ~participating,
                ctx.base * np.uint64(weight) // np.uint64(WEIGHT_DENOMINATOR),
                np.uint64(0))
    quotient = (spec.inactivity_score_bias
                * inactivity_penalty_quotient(fork, preset))
    inact = ctx.eff * scores // np.uint64(quotient)
    penalties += np.where(ctx.eligible & ~target_prev, inact, np.uint64(0))

    summary.rewards, summary.penalties = rewards, penalties
    bal = _full_column(state.balances, n, np.uint64)
    bal = bal + rewards
    bal = np.where(bal >= penalties, bal - penalties, np.uint64(0))
    store_column(state, "balances", bal,
                 touched=np.flatnonzero((rewards != 0) | (penalties != 0)))
    timings["rewards_ms"] = (time.perf_counter() - t0) * 1e3


def process_epoch_single_pass(state, fork: ForkName, preset, spec,
                              T) -> EpochSummary:
    """Altair+ epoch transition as a single columnar sweep: one
    :class:`EpochContext` build feeds justification, inactivity, and
    rewards; the remaining steps are already one-column passes.  Stage
    timings land in :data:`LAST_EPOCH_TIMINGS`."""
    import time
    summary = EpochSummary()
    timings: dict = {}
    t_all = time.perf_counter()

    t0 = time.perf_counter()
    ctx = build_epoch_context(state, preset)
    timings["context_ms"] = (time.perf_counter() - t0) * 1e3

    t0 = time.perf_counter()
    if ctx.cur > GENESIS_EPOCH + 1:
        prev_target = _participating_balance_from(
            ctx.eff, ctx.unslashed_prev[TIMELY_TARGET_FLAG_INDEX], preset)
        cur_target = _participating_balance_from(ctx.eff, ctx.target_cur,
                                                 preset)
        summary.total_active_balance = ctx.total_active_balance
        summary.previous_target_balance = prev_target
        summary.current_target_balance = cur_target
        weigh_justification_and_finalization(
            state, ctx.total_active_balance, prev_target, cur_target,
            preset, T)
    timings["justification_ms"] = (time.perf_counter() - t0) * 1e3

    _fused_inactivity_and_rewards(state, fork, preset, spec, ctx, summary,
                                  timings)

    t0 = time.perf_counter()
    process_registry_updates(state, preset, spec, summary)
    timings["registry_ms"] = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    process_slashings(state, fork, preset)
    timings["slashings_ms"] = (time.perf_counter() - t0) * 1e3
    process_eth1_data_reset(state, preset)
    t0 = time.perf_counter()
    process_effective_balance_updates(state, preset)
    timings["effective_balance_ms"] = (time.perf_counter() - t0) * 1e3
    process_slashings_reset(state, preset)
    process_randao_mixes_reset(state, preset)
    process_historical_update(state, fork, preset, T)
    process_participation_flag_updates(state)
    t0 = time.perf_counter()
    process_sync_committee_updates(state, preset, T)
    timings["shuffle_ms"] = (time.perf_counter() - t0) * 1e3

    timings["total_ms"] = (time.perf_counter() - t_all) * 1e3
    LAST_EPOCH_TIMINGS.clear()
    LAST_EPOCH_TIMINGS.update(timings)
    # Stage adapter: the epoch decomposition bench.py reads becomes
    # child spans of the enclosing epoch-transition span.
    from ..common.tracing import TRACER
    TRACER.record_stages("epoch", cat="state_transition")
    return summary


# ---------------------------------------------------------------------------
# Entry point
# ---------------------------------------------------------------------------

def process_epoch_phase0(state, preset, spec, T) -> EpochSummary:
    """The phase0 epoch transition (PendingAttestation-driven) is not
    ported yet: the port runs Altair and later forks."""
    raise NotImplementedError(
        "the phase0 epoch transition (per_epoch_phase0) is not ported to "
        "lighthouse_tpu_torch yet")


def process_epoch(state, fork: ForkName, preset, spec, T) -> EpochSummary:
    """Altair+ epoch transition: the fused single-pass sweep."""
    if fork == ForkName.PHASE0:
        return process_epoch_phase0(state, preset, spec, T)
    return process_epoch_single_pass(state, fork, preset, spec, T)
