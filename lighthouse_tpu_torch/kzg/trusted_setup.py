"""KZG trusted setup: loader, embedded minimal setup, insecure generator.

A setup for blob width W is the ceremony output in Lagrange form:

- ``g1_lagrange[i] = [L_i(tau)]·G1`` for the Lagrange basis over the
  bit-reversal-ordered roots-of-unity domain (what commit/prove consume);
- ``g2_monomial = ([1]·G2, [tau]·G2)`` (what the verifier consumes — the
  verifier never touches the G1 side, so verification works without ever
  materializing the Lagrange points).

This environment has no network access to the real ceremony transcript
(``trusted_setup_4096.json``), so setups here are **derived from a fixed,
public tau** via :func:`generate_insecure_setup` — cryptographically
worthless for production (anyone knowing tau can forge proofs) but
structurally identical, which is what the framework needs: the verifier
code path is byte-for-byte the one a real ceremony file would drive
through :func:`load_trusted_setup`, and :func:`dump_trusted_setup` of
:func:`generate_insecure_setup` regenerates any width.  Port of
``lighthouse_tpu/kzg/trusted_setup.py``.  The minimal-preset setup (width 4) is
embedded below as hex so loading it exercises the real parser.
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field
from functools import lru_cache
from typing import List, Optional, Sequence, Tuple

from ..crypto import curve as C
from .fr import BLS_MODULUS, compute_roots_of_unity


class SetupError(ValueError):
    pass


# Fixed public tau for insecure (test/bench) setups: nothing-up-the-sleeve
# derivation, mirroring the interop secret-key convention.
INSECURE_TAU = int.from_bytes(
    __import__("hashlib").sha256(b"lighthouse-tpu insecure kzg tau").digest(),
    "big") % BLS_MODULUS


@dataclass
class TrustedSetup:
    """Parsed setup for one blob width.

    ``tau`` is present ONLY on insecure locally-generated setups (it lets
    tests/bench compute commitments with one scalar-mul instead of a
    width-sized MSM); a ceremony file loaded from disk has ``tau=None``
    and everything still works — just slower to commit with.
    """
    width: int
    g1_lagrange: List[Tuple[int, int]]          # affine G1, no identity
    g2_monomial: Tuple[object, object]          # ([1]G2, [tau]G2) affine
    tau: Optional[int] = None
    roots: List[int] = field(default_factory=list)

    def __post_init__(self):
        if not self.roots:
            self.roots = compute_roots_of_unity(self.width)


def generate_insecure_setup(width: int,
                            tau: int = INSECURE_TAU) -> TrustedSetup:
    """Powers-of-tau from a KNOWN tau (insecure by construction).

    Lagrange G1 points come from evaluating each basis polynomial at tau:
    ``L_i(tau) = (tau^W - 1)·ω_i / (W·(tau - ω_i))`` — one G1 scalar-mul
    per point, no FFT needed.
    """
    roots = compute_roots_of_unity(width)
    if tau % BLS_MODULUS in roots:
        raise SetupError("degenerate tau (lies in the evaluation domain)")
    zh = (pow(tau, width, BLS_MODULUS) - 1) % BLS_MODULUS  # tau^W - 1
    w_inv = pow(width, BLS_MODULUS - 2, BLS_MODULUS)
    g1 = []
    for w in roots:
        li = zh * w % BLS_MODULUS * w_inv % BLS_MODULUS \
            * pow(tau - w, BLS_MODULUS - 2, BLS_MODULUS) % BLS_MODULUS
        g1.append(C.g1_mul(C.G1_GEN, li))
    g2 = (C.G2_GEN, C.g2_mul(C.G2_GEN, tau))
    return TrustedSetup(width=width, g1_lagrange=g1, g2_monomial=g2,
                        tau=tau, roots=roots)


def verification_setup(width: int, tau: int = INSECURE_TAU) -> TrustedSetup:
    """Verifier-only setup: G2 points + roots, NO Lagrange G1 table.

    Verification never reads ``g1_lagrange``, so chains that only verify
    (the availability gate) skip the width-sized G1 generation entirely —
    this is what :class:`~..beacon_chain.data_availability
    .DataAvailabilityChecker` builds lazily.
    """
    return TrustedSetup(width=width, g1_lagrange=[],
                        g2_monomial=(C.G2_GEN, C.g2_mul(C.G2_GEN, tau)),
                        tau=tau)


def dump_trusted_setup(setup: TrustedSetup) -> str:
    """Serialize in the c-kzg-4844 JSON layout (``trusted_setup.json``)."""
    return json.dumps({
        "g1_lagrange": ["0x" + C.g1_compress(p).hex()
                        for p in setup.g1_lagrange],
        "g2_monomial": ["0x" + C.g2_compress(p).hex()
                        for p in setup.g2_monomial],
    }, indent=1)


def load_trusted_setup(source) -> TrustedSetup:
    """Parse a c-kzg-4844-style JSON setup (dict, JSON text, or path).

    Every point is decompressed AND subgroup-checked — a malformed or
    out-of-subgroup setup point would silently break the binding property,
    so it is a hard load-time error, not a verify-time surprise.
    """
    if isinstance(source, str):
        if source.lstrip().startswith("{"):
            raw = json.loads(source)
        else:
            with open(source) as f:
                raw = json.load(f)
    else:
        raw = dict(source)
    try:
        g1_hex = raw["g1_lagrange"]
        g2_hex = raw["g2_monomial"]
    except KeyError as e:
        raise SetupError(f"setup missing field {e}") from None
    if len(g2_hex) < 2:
        raise SetupError("setup needs [1]G2 and [tau]G2")
    width = len(g1_hex)
    if width == 0 or width & (width - 1):
        raise SetupError("g1_lagrange length must be a power of two")

    def _unhex(s: str) -> bytes:
        return bytes.fromhex(s[2:] if s.startswith("0x") else s)

    g1 = []
    for s in g1_hex:
        p = C.g1_decompress(_unhex(s))
        if p is None or not C.g1_subgroup_check(p):
            raise SetupError("G1 setup point fails subgroup check")
        g1.append(p)
    g2 = []
    for s in g2_hex[:2]:
        p = C.g2_decompress(_unhex(s))
        if p is None or not C.g2_subgroup_check(p):
            raise SetupError("G2 setup point fails subgroup check")
        g2.append(p)
    if g2[0] != C.G2_GEN:
        raise SetupError("g2_monomial[0] must be the G2 generator")
    return TrustedSetup(width=width, g1_lagrange=g1,
                        g2_monomial=(g2[0], g2[1]))


# ---------------------------------------------------------------------------
# Embedded minimal-preset setup (width 4), generated from INSECURE_TAU by
# dump_trusted_setup(generate_insecure_setup(4)) — kept as JSON hex so
# loading it round-trips the real parser; the tests pin the equality.
# ---------------------------------------------------------------------------

EMBEDDED_MINIMAL_JSON = """{
 "g1_lagrange": [
  "0x9621bb0d38c7ff042c8c291679fa5bc071e5336e3d45402b538d1a33a9761cbbd6531cad029faf0ef249345e670c311c",
  "0xa69a507e4931d6863761bce20c3b0654273ed30c361a70b6f6bfdfffc2d5b01149a4697f58538cadd558994c210132ed",
  "0x922092e132540848e2cda5f95641b4ddf4ea8e6fd512f50c80df4fbc544fb1f2b08f1e3aebdc6da28dcd29b1db3539ac",
  "0xa86554cbecdc0c30a88f8e895f5af0293ce41e06d3ee485ae1751d5110c07c2a2a041d25baa011dc7a5a68abe94e3192"
 ],
 "g2_monomial": [
  "0x93e02b6052719f607dacd3a088274f65596bd0d09920b61ab5da61bbdc7f5049334cf11213945d57e5ac7d055d042b7e024aa2b2f08f0a91260805272dc51051c6e47ad4fa403b02b4510b647ae3d1770bac0326a805bbefd48056c8c121bdb8",
  "0xab4d4e98e57ed98a1016bc1426322471c951026ee32c9521e8a042c794880ad4423b1d608fe216e2b5746989c6a36e4806ebb6238a1eecead93692332eb81b6d496b5f8977b9d9a0e898db6c6f4c381e5cd6552d12c5c1dddba08700b125a6d9"
 ]
}"""


@lru_cache(maxsize=8)
def embedded_setup(width: int) -> TrustedSetup:
    """The framework's canonical insecure setup for ``width``: parsed from
    the embedded JSON when one is checked in for that width (exercising
    the real loader; the tests pin the JSON against regeneration from
    INSECURE_TAU), generated from INSECURE_TAU otherwise."""
    if width == 4:
        setup = load_trusted_setup(EMBEDDED_MINIMAL_JSON)
        setup.tau = INSECURE_TAU
        return setup
    return generate_insecure_setup(width)
