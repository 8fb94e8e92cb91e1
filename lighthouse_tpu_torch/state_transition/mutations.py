"""Registry mutations: exit initiation and slashing.

Counterpart of ``consensus/state_processing/src/common/
{initiate_validator_exit,slash_validator}.rs``.  These are inherently
sequential (each exit consumes churn), so they stay scalar; everything bulk
remains in the vectorized epoch steps.
"""

from __future__ import annotations

import numpy as np

from ..common.safe_arith import safe_add, safe_div, safe_mul, safe_sub
from ..types.chain_spec import (
    FAR_FUTURE_EPOCH,
    ForkName,
    PROPOSER_WEIGHT,
    WEIGHT_DENOMINATOR,
)
from .helpers import (
    compute_activation_exit_epoch,
    current_epoch,
    decrease_balance,
    get_validator_churn_limit,
    increase_balance,
)


def initiate_validator_exit(state, index: int, preset, spec) -> None:
    """Queue a validator exit behind the churn limit."""
    reg = state.validators
    if int(reg.col("exit_epoch")[index]) != FAR_FUTURE_EPOCH:
        return
    exit_epochs = reg.col("exit_epoch")
    pending = exit_epochs[exit_epochs != np.uint64(FAR_FUTURE_EPOCH)]
    exit_queue_epoch = max(
        int(pending.max()) if pending.size else 0,
        compute_activation_exit_epoch(current_epoch(state, preset),
                                      preset.MAX_SEED_LOOKAHEAD))
    exit_queue_churn = int((pending == np.uint64(exit_queue_epoch)).sum())
    if exit_queue_churn >= get_validator_churn_limit(state, preset, spec):
        exit_queue_epoch = safe_add(exit_queue_epoch, 1)
    reg.wcol("exit_epoch")[index] = exit_queue_epoch
    # `safe_add` discipline: an epoch sum past u64 is an INVALID
    # operation, not a wrapped uint64 in the column.
    reg.wcol("withdrawable_epoch")[index] = safe_add(
        exit_queue_epoch, spec.min_validator_withdrawability_delay)


def min_slashing_penalty_quotient(fork: ForkName, preset) -> int:
    if fork >= ForkName.BELLATRIX:
        return preset.MIN_SLASHING_PENALTY_QUOTIENT_BELLATRIX
    if fork >= ForkName.ALTAIR:
        return preset.MIN_SLASHING_PENALTY_QUOTIENT_ALTAIR
    return preset.MIN_SLASHING_PENALTY_QUOTIENT


def proportional_slashing_multiplier(fork: ForkName, preset) -> int:
    if fork >= ForkName.BELLATRIX:
        return preset.PROPORTIONAL_SLASHING_MULTIPLIER_BELLATRIX
    if fork >= ForkName.ALTAIR:
        return preset.PROPORTIONAL_SLASHING_MULTIPLIER_ALTAIR
    return preset.PROPORTIONAL_SLASHING_MULTIPLIER


def slash_validator(state, slashed_index: int, fork: ForkName, preset, spec,
                    whistleblower_index: int | None = None,
                    proposer_index: int | None = None) -> None:
    """Spec ``slash_validator``: exit + mark slashed + penalty + rewards."""
    from .committees import get_beacon_proposer_index

    epoch = current_epoch(state, preset)
    initiate_validator_exit(state, slashed_index, preset, spec)
    reg = state.validators
    reg.wcol("slashed")[slashed_index] = True
    reg.wcol("withdrawable_epoch")[slashed_index] = max(
        int(reg.col("withdrawable_epoch")[slashed_index]),
        safe_add(epoch, preset.EPOCHS_PER_SLASHINGS_VECTOR))
    eff = int(reg.col("effective_balance")[slashed_index])
    slot = epoch % preset.EPOCHS_PER_SLASHINGS_VECTOR
    state.slashings[slot] = np.uint64(
        safe_add(int(state.slashings[slot]), eff))
    decrease_balance(state, slashed_index,
                     safe_div(eff, min_slashing_penalty_quotient(fork,
                                                                 preset)))

    if proposer_index is None:
        proposer_index = get_beacon_proposer_index(state, preset)
    if whistleblower_index is None:
        whistleblower_index = proposer_index
    whistleblower_reward = safe_div(eff,
                                    preset.WHISTLEBLOWER_REWARD_QUOTIENT)
    if fork >= ForkName.ALTAIR:
        proposer_reward = safe_div(
            safe_mul(whistleblower_reward, PROPOSER_WEIGHT),
            WEIGHT_DENOMINATOR)
    else:
        proposer_reward = safe_div(whistleblower_reward,
                                   preset.PROPOSER_REWARD_QUOTIENT)
    increase_balance(state, proposer_index, proposer_reward)
    increase_balance(state, whistleblower_index,
                     safe_sub(whistleblower_reward, proposer_reward))
