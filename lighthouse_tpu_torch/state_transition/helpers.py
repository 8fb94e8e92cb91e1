"""Spec accessor/predicate helpers over the SoA state.

Counterpart of the misc helpers scattered through
``consensus/state_processing/src/common/`` and
``consensus/types/src/beacon_state.rs`` accessor methods.  Everything that
touches the validator registry is vectorized over the SoA columns.
"""

from __future__ import annotations

import hashlib

import numpy as np

from ..common.safe_arith import safe_add, safe_mul
from ..ssz import Container, Bytes4, Bytes32
from ..types.chain_spec import (
    Domain,
    FAR_FUTURE_EPOCH,
    GENESIS_EPOCH,
)


def sha(data: bytes) -> bytes:
    return hashlib.sha256(data).digest()


# -- epoch / slot math -------------------------------------------------------

def compute_epoch_at_slot(slot: int, slots_per_epoch: int) -> int:
    return slot // slots_per_epoch


def compute_start_slot_at_epoch(epoch: int, slots_per_epoch: int) -> int:
    return safe_mul(epoch, slots_per_epoch)


def compute_activation_exit_epoch(epoch: int, max_seed_lookahead: int = 4) -> int:
    return safe_add(safe_add(epoch, 1), max_seed_lookahead)


def current_epoch(state, preset) -> int:
    return compute_epoch_at_slot(state.slot, preset.SLOTS_PER_EPOCH)


def previous_epoch(state, preset) -> int:
    cur = current_epoch(state, preset)
    return cur - 1 if cur > GENESIS_EPOCH else GENESIS_EPOCH


# -- registry predicates (vectorized) ---------------------------------------

def is_active_at(registry, epoch: int) -> np.ndarray:
    """Boolean mask of validators active at ``epoch``."""
    return ((registry.col("activation_epoch") <= epoch)
            & (epoch < registry.col("exit_epoch")))


def get_active_validator_indices(registry, epoch: int) -> np.ndarray:
    return np.flatnonzero(is_active_at(registry, epoch)).astype(np.uint64)


def is_eligible_for_activation_queue(registry) -> np.ndarray:
    raise NotImplementedError("use mask form in per_epoch")


def is_slashable_at(registry, epoch: int) -> np.ndarray:
    """Mask: active-ish and not slashed (``is_slashable_validator``)."""
    return (~registry.col("slashed")
            & (registry.col("activation_epoch") <= epoch)
            & (epoch < registry.col("withdrawable_epoch")))


def get_total_balance(registry, indices: np.ndarray,
                      effective_balance_increment: int) -> int:
    """Sum of effective balances, floored at one increment
    (spec ``get_total_balance``)."""
    total = int(registry.col("effective_balance")[indices.astype(np.int64)].sum())
    return max(total, effective_balance_increment)


def get_total_active_balance(state, preset) -> int:
    idx = get_active_validator_indices(state.validators,
                                       current_epoch(state, preset))
    return get_total_balance(state.validators, idx,
                             preset.EFFECTIVE_BALANCE_INCREMENT)


# -- balances ---------------------------------------------------------------

def increase_balance(state, index: int, delta: int) -> None:
    """``safe_add`` discipline (`safe_arith`): a u64 overflow here is an
    INVALID operation, not a wrapped numpy value silently entering the
    balance column."""
    from ..common.safe_arith import safe_add
    state.balances[index] = np.uint64(
        safe_add(int(state.balances[index]), delta))


def decrease_balance(state, index: int, delta: int) -> None:
    """``saturating_sub`` per spec (balances clamp at zero)."""
    from ..common.safe_arith import saturating_sub
    state.balances[index] = np.uint64(
        saturating_sub(int(state.balances[index]), delta))


# -- roots / mixes / seeds ---------------------------------------------------

def get_block_root_at_slot(state, slot: int, preset) -> bytes:
    if not slot < state.slot <= slot + preset.SLOTS_PER_HISTORICAL_ROOT:
        raise ValueError(f"slot {slot} out of block-roots range at "
                         f"state slot {state.slot}")
    return state.block_roots.get(slot % preset.SLOTS_PER_HISTORICAL_ROOT)


def get_block_root(state, epoch: int, preset) -> bytes:
    return get_block_root_at_slot(
        state, compute_start_slot_at_epoch(epoch, preset.SLOTS_PER_EPOCH),
        preset)


def get_randao_mix(state, epoch: int, preset) -> bytes:
    return state.randao_mixes.get(epoch % preset.EPOCHS_PER_HISTORICAL_VECTOR)


def get_seed(state, epoch: int, domain_type: Domain, preset) -> bytes:
    mix = get_randao_mix(
        state,
        epoch + preset.EPOCHS_PER_HISTORICAL_VECTOR - preset.MIN_SEED_LOOKAHEAD - 1,
        preset)
    return sha(domain_type.value + epoch.to_bytes(8, "little") + mix)


# -- domains / signing roots -------------------------------------------------

class _ForkData(Container):
    current_version: Bytes4
    genesis_validators_root: Bytes32


class _SigningData(Container):
    object_root: Bytes32
    domain: Bytes32


def compute_fork_data_root(current_version: bytes,
                           genesis_validators_root: bytes) -> bytes:
    return _ForkData(
        current_version=current_version,
        genesis_validators_root=genesis_validators_root).tree_hash_root()


def compute_fork_digest(current_version: bytes,
                        genesis_validators_root: bytes) -> bytes:
    return compute_fork_data_root(current_version, genesis_validators_root)[:4]


def compute_domain(domain_type: Domain, fork_version: bytes = bytes(4),
                   genesis_validators_root: bytes = bytes(32)) -> bytes:
    fork_data_root = compute_fork_data_root(fork_version,
                                            genesis_validators_root)
    return domain_type.value + fork_data_root[:28]


def get_domain(state, domain_type: Domain, epoch: int | None, preset) -> bytes:
    """``BeaconState::get_domain`` (``types/src/beacon_state.rs``)."""
    if epoch is None:
        epoch = current_epoch(state, preset)
    fork_version = (state.fork.previous_version if epoch < state.fork.epoch
                    else state.fork.current_version)
    return compute_domain(domain_type, fork_version,
                          state.genesis_validators_root)


def compute_signing_root(obj, domain: bytes) -> bytes:
    root = obj if isinstance(obj, bytes) else obj.tree_hash_root()
    return _SigningData(object_root=root, domain=domain).tree_hash_root()


# -- churn -------------------------------------------------------------------

def get_validator_churn_limit(state, preset, spec) -> int:
    active = int(is_active_at(state.validators,
                              current_epoch(state, preset)).sum())
    return max(spec.min_per_epoch_churn_limit,
               active // spec.churn_limit_quotient)


# -- participation flags -----------------------------------------------------

def has_flag(flags: np.ndarray | int, flag_index: int):
    bit = 1 << flag_index
    if isinstance(flags, np.ndarray):
        return (flags & np.uint8(bit)) != 0
    return (flags & bit) != 0


def add_flag(flags, flag_index: int):
    if isinstance(flags, np.ndarray):
        return flags | np.uint8(1 << flag_index)
    return flags | (1 << flag_index)
