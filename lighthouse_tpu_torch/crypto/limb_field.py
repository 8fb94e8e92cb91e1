"""Host side of the 16-bit-limb Montgomery representation.

The port's copy of the host conversions and constants of
``lighthouse_tpu/crypto/limb_field.py``: a field element is 26
little-endian 16-bit limbs (R = 2^416 > 4N) holding a Montgomery residue
``x·R mod N`` with value < 2N (lazy reduction).  The device arithmetic
lives in :mod:`.pairing_kernel` (plain PyTorch) and ``csrc/
bls381_field.cuh`` (CUDA, 13 × 32-bit words of the same R).
"""

from __future__ import annotations

import numpy as np

from .fields import P as N_INT

LIMB_BITS = 16
LIMBS = 26
R_BITS = LIMB_BITS * LIMBS          # 416
R_INT = 1 << R_BITS
R_MOD_N = R_INT % N_INT
RINV_INT = pow(R_INT, -1, N_INT)
# -N^-1 mod R for the full-width Montgomery reduction.
NPRIME_INT = (-pow(N_INT, -1, R_INT)) % R_INT


def int_to_limbs(x: int) -> np.ndarray:
    """Python int (< R) → ``(26,)`` uint32 16-bit limbs, little-endian."""
    if not 0 <= x < R_INT:
        raise ValueError("value out of limb range")
    return np.array([(x >> (LIMB_BITS * i)) & 0xFFFF for i in range(LIMBS)],
                    dtype=np.uint32)


def limbs_to_int(limbs) -> int:
    """``(26,)`` limbs → python int (no modular reduction)."""
    limbs = np.asarray(limbs, dtype=np.uint64)
    return sum(int(v) << (LIMB_BITS * i) for i, v in enumerate(limbs))


N_LIMBS = int_to_limbs(N_INT)
N2_LIMBS = int_to_limbs(2 * N_INT)
_NPRIME_LIMBS = int_to_limbs(NPRIME_INT)


def to_mont(x: int) -> np.ndarray:
    """Canonical int → Montgomery-domain limbs."""
    return int_to_limbs((x % N_INT) * R_MOD_N % N_INT)


def from_mont(limbs) -> int:
    """Montgomery-domain limbs (any lazy representative) → canonical int."""
    return limbs_to_int(limbs) * RINV_INT % N_INT


ONE_MONT = to_mont(1)
