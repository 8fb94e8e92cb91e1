"""The fused epoch sweep as torch ops on the device of the state's columns.

Port of ``lighthouse_tpu/state_transition/per_epoch_device.py`` (a
``jax.jit`` program there): one pass computes the inactivity-score update,
the per-flag rewards and penalties, the inactivity penalty and the balance
application for every validator — the device twin of
:func:`.per_epoch._fused_inactivity_and_rewards`, enabled with
``LIGHTHOUSE_TPU_EPOCH_DEVICE=1``.

Exactness: the sweep is u64 arithmetic with the spec's wrap and floor
semantics.  Torch has no usable u64 arithmetic, so u64 values travel as
int64 bit patterns (what :func:`..device.to_device` already makes of a
u64 array): addition, subtraction, multiplication and the sum wrap mod
2^64 alike in both readings, and the three operations that differ get
unsigned forms here — comparison (:func:`_ult`, after flipping the top
bit), ``min`` / ``max`` through it, and floor division by a positive
scalar (:func:`_udiv`).  The tests hold the sweep equal to the numpy
sweep on values near 2^64.

The JAX package falls back to numpy when its kernel fails; the port does
not: with the knob on, the sweep runs on :func:`..device.get_device` or
raises.  ``scores`` and ``balances`` are adopted by the state's device
columns through ``store_column`` (no pull); ``rewards`` and ``penalties``
come back to the host for the epoch summary.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from ..types.chain_spec import (
    PARTICIPATION_FLAG_WEIGHTS,
    TIMELY_HEAD_FLAG_INDEX,
    TIMELY_TARGET_FLAG_INDEX,
    WEIGHT_DENOMINATOR,
)

_TOP = 1 << 63
_MASK63 = _TOP - 1


def _flip(x):
    """Order-preserving map of u64 bit patterns onto signed int64 (a
    tensor, or a python int in [0, 2^64) for a scalar operand)."""
    if isinstance(x, int):
        return x - _TOP
    return x ^ -_TOP


def _ult(a, b) -> torch.Tensor:
    """``a < b`` read as u64."""
    return _flip(a) < _flip(b)


def _umin(a: torch.Tensor, b) -> torch.Tensor:
    """u64 ``min(a, b)``; ``b`` a tensor or a python int."""
    b_t = b if isinstance(b, torch.Tensor) else _as_i64(b, a)
    return torch.where(_ult(a, b), a, b_t)


def _umax(a: torch.Tensor, b: int) -> torch.Tensor:
    return torch.where(_ult(a, b), _as_i64(b, a), a)


def _as_i64(v: int, like: torch.Tensor) -> torch.Tensor:
    """A u64 python int as the int64 scalar tensor of its bit pattern."""
    return torch.tensor(v - (1 << 64) if v >= _TOP else v,
                        dtype=torch.int64, device=like.device)


def _udiv(x: torch.Tensor, d: int) -> torch.Tensor:
    """``x // d`` with ``x`` u64 bit patterns and ``d`` a python int in
    [1, 2^64): halve to a non-negative int64, divide, double, and correct
    the one step the halving can lose."""
    if not 0 < d < (1 << 64):
        raise ValueError(f"u64 divisor out of range: {d}")
    if d >= _TOP:
        return (~_ult(x, d)).to(torch.int64)
    q = (((x >> 1) & _MASK63) // d) << 1
    r = x - q * d
    return q + (~_ult(r, d)).to(torch.int64)


def sweep(act, ext, wd, slashed, eff, prev_part, scores, balances, *,
          prev: int, bias: int, recovery: int, in_leak: bool, per_inc: int,
          increment: int, active_increments: int, quotient: int):
    """The fused sweep on int64 tensors holding u64 columns (``slashed``
    bool, ``prev_part`` uint8).  Returns ``(scores, rewards, penalties,
    balances)``, each a new tensor (the inputs are not written)."""
    zero = torch.zeros((), dtype=torch.int64, device=eff.device)
    active_prev = ~_ult(prev, act) & _ult(prev, ext)
    eligible = active_prev | (slashed & _ult(prev + 1, wd))
    not_slashed = ~slashed
    unslashed = [active_prev & ((prev_part & (1 << f)) != 0) & not_slashed
                 for f in range(len(PARTICIPATION_FLAG_WEIGHTS))]
    target = unslashed[TIMELY_TARGET_FLAG_INDEX]

    # inactivity scores (process_inactivity_updates order)
    scores = torch.where(eligible & target, scores - _umin(scores, 1),
                         scores)
    scores = torch.where(eligible & ~target, scores + bias, scores)
    if not in_leak:
        scores = torch.where(eligible, scores - _umin(scores, recovery),
                             scores)

    base = _udiv(eff, increment) * per_inc
    rewards = torch.zeros_like(eff)
    penalties = torch.zeros_like(eff)
    for flag_index, weight in enumerate(PARTICIPATION_FLAG_WEIGHTS):
        participating = unslashed[flag_index]
        part_bal = _umax(torch.where(participating, eff, zero).sum(),
                         increment)
        if not in_leak:
            reward_num = base * weight * _udiv(part_bal, increment)
            rewards = rewards + torch.where(
                eligible & participating,
                _udiv(reward_num, active_increments * WEIGHT_DENOMINATOR),
                zero)
        if flag_index != TIMELY_HEAD_FLAG_INDEX:
            penalties = penalties + torch.where(
                eligible & ~participating,
                _udiv(base * weight, WEIGHT_DENOMINATOR), zero)
    penalties = penalties + torch.where(
        eligible & ~target, _udiv(eff * scores, quotient), zero)

    balances = balances + rewards
    balances = torch.where(_ult(balances, penalties), zero,
                           balances - penalties)
    return scores, rewards, penalties, balances


def _column(arr, n: int, subsystem: str) -> torch.Tensor:
    """A state column on the device: the adopted tensor of a device
    column whose device copy is authoritative, else a copy of the host
    values (zero-extended to ``n``)."""
    from ..device import to_device
    from ..types.device_state import DeviceColumn
    if isinstance(arr, DeviceColumn) and arr._adopted \
            and arr.shape[0] == n:
        return arr._dev
    host = np.zeros(n, dtype=np.uint64)
    src = np.asarray(arr)
    host[:src.shape[0]] = src
    return to_device(host, subsystem)


def fused_sweep(state, fork, preset, spec, ctx, summary, in_leak: bool,
                timings: dict) -> None:
    """Run the sweep on the device and land its results in ``state`` and
    ``summary``.  Raises where the device cannot run it (no silent
    numpy fallback)."""
    from ..device import to_device, to_host
    from ..types.device_state import store_column
    from .per_epoch import base_reward_per_increment, \
        inactivity_penalty_quotient

    n = len(state.validators)
    reg = state.validators
    t0 = time.perf_counter()
    cols = [to_device(reg.col(name), "registry_mirror")
            for name in ("activation_epoch", "exit_epoch",
                         "withdrawable_epoch")]
    slashed = to_device(reg.col("slashed"), "registry_mirror").bool()
    eff = to_device(ctx.eff, "registry_mirror")
    prev_part = to_device(ctx.prev_part, "packed_cache")
    scores = _column(state.inactivity_scores, n, "packed_cache")
    balances = _column(state.balances, n, "packed_cache")
    inc = preset.EFFECTIVE_BALANCE_INCREMENT
    scores, rewards, penalties, balances = sweep(
        *cols, slashed, eff, prev_part, scores, balances,
        prev=int(ctx.prev), bias=int(spec.inactivity_score_bias),
        recovery=int(spec.inactivity_score_recovery_rate),
        in_leak=bool(in_leak),
        per_inc=int(base_reward_per_increment(ctx.total_active_balance,
                                              preset)),
        increment=int(inc),
        active_increments=int(ctx.total_active_balance // inc),
        quotient=int(spec.inactivity_score_bias
                     * inactivity_penalty_quotient(fork, preset)))
    summary.rewards = to_host(rewards, "packed_cache")
    summary.penalties = to_host(penalties, "packed_cache")
    store_column(state, "inactivity_scores", scores)
    store_column(state, "balances", balances)
    timings["inactivity_ms"] = 0.0
    timings["rewards_ms"] = (time.perf_counter() - t0) * 1e3
    timings["device"] = True
