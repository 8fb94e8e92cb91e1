"""Safe arithmetic — the role of ``consensus/safe_arith``
(``consensus/safe_arith/src/lib.rs``): spec math is
u64 with DEFINED overflow behavior (an overflowing block is INVALID,
not a wrapped number).

Python ints don't overflow, so the risk here is inverted: a negative
intermediate or an over-wide value silently flows into a numpy uint64
column and WRAPS there.  These helpers make the u64 bounds explicit at
the spec seams; `state_transition` uses them where the reference calls
``safe_add``/``safe_sub``/``safe_mul``.

Where it IS applied (every scalar spec seam):
balance credit/debit (`helpers.increase_balance`/`decrease_balance`),
epoch/slot products and exit-epoch sums (`helpers.compute_*`,
`mutations.initiate_validator_exit`), the whole slashing path
(`mutations.slash_validator`: slashings accumulator, penalty and
whistleblower/proposer reward chains), attestation proposer-reward
numerators and denominators, sync-aggregate reward derivation, deposit
effective-balance rounding, voluntary-exit eligibility epochs, and the
withdrawal sweep (both the scalar oracle and the vectorized fast path's
scalar emissions) in `per_block.py`.

Where it is NOT applied, and why: the vectorized epoch-processing
columns (`per_epoch.py`, `per_epoch_device.py`).  Those paths do their
arithmetic over whole uint64/int64 numpy columns where a per-element
python guard would deoptimize the single-pass sweep by orders of
magnitude; instead they bound inputs structurally — effective balances
are ≤ MAX_EFFECTIVE_BALANCE (32 ETH ≈ 2^35) and reward/penalty
numerators are products of ≤2^35 values with ≤2^6 weights over ≤2^40
validators, provably inside u64/i64 — and saturate explicitly
(`np.minimum`/`where` clamps) at the few seams (inactivity-score
decrement, balance deltas) where the spec saturates.  The single-pass
epoch is held byte for byte against the JAX package's stepwise epoch
(`tests/test_torch_epoch_sweep.py`), so a silent wrap in the vectorized
path cannot survive the differential.
"""

from __future__ import annotations

U64_MAX = 2**64 - 1


class ArithError(OverflowError):
    """The reference's ``ArithError`` — consensus code treats it as
    'operation invalid', never as a crash."""


def safe_add(a: int, b: int) -> int:
    r = int(a) + int(b)
    if r > U64_MAX:
        raise ArithError(f"u64 add overflow: {a} + {b}")
    return r


def safe_sub(a: int, b: int) -> int:
    r = int(a) - int(b)
    if r < 0:
        raise ArithError(f"u64 sub underflow: {a} - {b}")
    return r


def safe_mul(a: int, b: int) -> int:
    r = int(a) * int(b)
    if r > U64_MAX:
        raise ArithError(f"u64 mul overflow: {a} * {b}")
    return r


def safe_div(a: int, b: int) -> int:
    if int(b) == 0:
        raise ArithError(f"division by zero: {a} / {b}")
    return int(a) // int(b)


def saturating_sub(a: int, b: int) -> int:
    """``saturating_sub`` — clamps at zero (balance decreases)."""
    return max(int(a) - int(b), 0)


def assert_u64(v: int, what: str = "value") -> int:
    v = int(v)
    if not 0 <= v <= U64_MAX:
        raise ArithError(f"{what} out of u64 range: {v}")
    return v
