"""Constants of the batched pairing: the static exponent bit strings and
the Frobenius table.

The port's copy of the constants of ``lighthouse_tpu/crypto/
limb_pairing.py`` (``X_BITS_*``, ``P_MINUS_2_BITS``, ``_GAMMA``); the
JAX package's XLA pairing itself is not ported.
"""

from __future__ import annotations

import numpy as np

from . import fields as F
from . import limb_field as LF
from .fields import P as P_INT, BLS_X

X_ABS = -BLS_X  # 0xd201000000010000

# MSB-first bit arrays.
X_BITS_FULL = np.array([int(b) for b in bin(X_ABS)[2:]], dtype=np.int32)
X_BITS_MILLER = X_BITS_FULL[1:]                      # implicit leading 1
P_MINUS_2_BITS = np.array([int(b) for b in bin(P_INT - 2)[2:]], dtype=np.int32)


def _fq2_to_limbs(a) -> np.ndarray:
    return np.stack([LF.to_mont(a[0]), LF.to_mont(a[1])])


def _frobenius_tables() -> dict:
    """γn[i][j] ∈ Fq2 with frob^n(Σ c_ij v^j w^i) = Σ conj^n(c_ij)·γn_ij
    v^j w^i, derived by applying the host oracle's Frobenius to basis
    elements (asserting diagonality).  n → (2, 3, 2, 26) uint32."""
    tables = {}
    for n in (1, 2, 3):
        gam = np.zeros((2, 3, 2, LF.LIMBS), dtype=np.uint32)
        for i in range(2):
            for j in range(3):
                c6 = [list(F.FQ6_ZERO) for _ in range(2)]
                c6[i][j] = F.FQ2_ONE
                out = F.fq12_frobenius((tuple(c6[0]), tuple(c6[1])), n)
                for ii in range(2):
                    for jj in range(3):
                        if (ii, jj) != (i, j):
                            assert out[ii][jj] == F.FQ2_ZERO
                gam[i, j] = _fq2_to_limbs(out[i][j])
        tables[n] = gam
    return tables


_GAMMA = _frobenius_tables()
