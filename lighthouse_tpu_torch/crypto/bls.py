"""BLS signatures over BLS12-381 (min-pubkey-size: pk in G1, sig in G2).

The port's copy of ``lighthouse_tpu/crypto/bls.py``: the host-facing
types, the consensus-critical validity rules, and the backend seam.

- ``SecretKey`` / ``PublicKey`` / ``Signature`` with compressed ZCash
  encodings (48/96 bytes); an infinity public key is invalid;
  deserialization subgroup-checks points; the infinity signature is
  representable and fails verification.
- ``SignatureSet`` + ``verify_signature_sets`` through the active backend.

Backends:

- ``tpu``    — the default: the device batch verify of
  :mod:`.tpu_backend` (the name is the JAX package's; here it runs on the
  CUDA kernels of ``csrc/bls381.cu``, and raises without a GPU unless the
  caller set the CPU device).
- ``python`` — the pure-Python pairing (ground truth), only when a caller
  selects it with ``set_backend("python")``.
- ``fake``   — always-true verification for logic tests.

Host group operations go through the native library (:mod:`.native`,
built with g++ from ``native/bls381.cpp``) once it is built, as in the JAX
package: key sums of 16 points or more, signing's G2 multiplication, and
the python backend's hash-to-curve and pairing.  Until the background
build lands, and under ``LIGHTHOUSE_TPU_NO_NATIVE=1``, they run in pure
Python.
"""

from __future__ import annotations

import secrets
from dataclasses import dataclass
from functools import lru_cache
from typing import Iterable, List, Optional, Sequence

from . import curve as C
from . import fields as F
from .hash_to_curve import hash_to_g2
from .pairing import multi_pairing_is_one

PUBLIC_KEY_BYTES_LEN = 48
SIGNATURE_BYTES_LEN = 96
SECRET_KEY_BYTES_LEN = 32
INFINITY_SIGNATURE = bytes([0xC0]) + b"\x00" * 95
RAND_BITS = 64


class BlsError(ValueError):
    pass


@lru_cache(maxsize=1 << 16)
def _g1_point_checked(data: bytes):
    """Decompress + subgroup-check a G1 pubkey encoding (memoized)."""
    try:
        point = C.g1_decompress(data)
    except ValueError as e:
        raise BlsError(str(e)) from e
    if point is None:
        raise BlsError("infinity public key is invalid")
    if not C.g1_subgroup_check(point):
        raise BlsError("public key not in the G1 subgroup")
    return point


def _g2_mul_fast(point, scalar: int):
    """[scalar]P through the native 256-bit ladder when it is built
    (signing and the RLC scalars), else the curve oracle."""
    from . import native

    if point is not None and 0 <= scalar < (1 << 256) and native.ready():
        return native.g2_mul(point, scalar)
    return C.g2_mul(point, scalar)


@lru_cache(maxsize=1 << 16)
def _g2_point_checked(data: bytes):
    try:
        point = C.g2_decompress(data)
    except ValueError as e:
        raise BlsError(str(e)) from e
    if point is not None and not C.g2_subgroup_check(point):
        raise BlsError("signature not in the G2 subgroup")
    return point


@dataclass(frozen=True)
class SecretKey:
    scalar: int

    @classmethod
    def random(cls) -> "SecretKey":
        # Rejection sampling: reducing mod R would bias ~9.5% of the range.
        while True:
            k = secrets.randbits(255)
            if 0 < k < F.R:
                return cls(k)

    @classmethod
    def deserialize(cls, data: bytes) -> "SecretKey":
        if len(data) != SECRET_KEY_BYTES_LEN:
            raise BlsError(f"secret key must be {SECRET_KEY_BYTES_LEN} bytes")
        k = int.from_bytes(data, "big")
        if k == 0 or k >= F.R:
            raise BlsError("secret key scalar out of range")
        return cls(k)

    def serialize(self) -> bytes:
        return self.scalar.to_bytes(32, "big")

    def public_key(self) -> "PublicKey":
        return PublicKey(C.g1_mul(C.G1_GEN, self.scalar))

    def sign(self, message: bytes) -> "Signature":
        return Signature(_g2_mul_fast(hash_to_g2(message), self.scalar))


@dataclass(frozen=True)
class PublicKey:
    point: tuple  # affine G1, never None (infinity pubkeys are invalid)

    def __post_init__(self):
        if self.point is None:
            raise BlsError("infinity public key is invalid")

    @classmethod
    def deserialize(cls, data: bytes) -> "PublicKey":
        if len(data) != PUBLIC_KEY_BYTES_LEN:
            raise BlsError(f"public key must be {PUBLIC_KEY_BYTES_LEN} bytes")
        return cls(_g1_point_checked(bytes(data)))

    def serialize(self) -> bytes:
        return C.g1_compress(self.point)


def aggregate_points(points):
    """G1 sum of pre-validated pubkey POINTS: the native Jacobian
    accumulator for 16 points or more once it is built (the shared
    path's 512-key sum), else pure-Python affine additions."""
    from . import native
    if len(points) >= 16 and native.ready():
        return native.g1_aggregate(list(points))
    acc = None
    for p in points:
        acc = C.g1_add(acc, p)
    return acc


def aggregate_public_keys(keys: Sequence[PublicKey]):
    """G1 sum of pubkey points (keys pre-validated at deserialization)."""
    return aggregate_points([k.point for k in keys])


@dataclass(frozen=True)
class Signature:
    point: Optional[tuple]  # affine G2; None = infinity signature

    @classmethod
    def deserialize(cls, data: bytes) -> "Signature":
        if len(data) != SIGNATURE_BYTES_LEN:
            raise BlsError(f"signature must be {SIGNATURE_BYTES_LEN} bytes")
        return cls(_g2_point_checked(bytes(data)))

    def serialize(self) -> bytes:
        return C.g2_compress(self.point)


def aggregate_signatures(sigs: Iterable[Signature]) -> Signature:
    """G2 sum; empty input yields the infinity signature."""
    acc = None
    for s in sigs:
        if s.point is not None:
            acc = C.g2_add(acc, s.point)
    return Signature(acc)


@dataclass(frozen=True)
class SignatureSet:
    """{aggregate signature, signing keys, one message}."""
    signature: Optional[Signature]
    signing_keys: List[PublicKey]
    message: bytes


def signature_set_key(s: SignatureSet) -> tuple:
    """Exact-identity key of a set: (message, signature point, signing
    key points).  Two sets with equal keys verify alike under any
    backend."""
    return (bytes(s.message),
            None if s.signature is None else s.signature.point,
            tuple(k.point for k in s.signing_keys))


def dedup_signature_sets(sets: Sequence[SignatureSet]
                         ) -> tuple[List[SignatureSet], int]:
    """Drop exact-duplicate sets (same message, keys AND signature)
    before a batch dispatch; returns ``(unique_sets, dropped)``.  The
    verdict is unchanged: the random-linear-combination batch verifies
    iff every distinct set does."""
    seen: set = set()
    out: List[SignatureSet] = []
    for s in sets:
        key = signature_set_key(s)
        if key in seen:
            continue
        seen.add(key)
        out.append(s)
    return out, len(sets) - len(out)


# ---------------------------------------------------------------------------
# Backend seam
# ---------------------------------------------------------------------------

class PythonBackend:
    """Pure-Python pairing backend (ground truth, slow)."""

    name = "python"

    def verify(self, signature: Signature, pubkeys: Sequence[PublicKey],
               message: bytes) -> bool:
        if signature.point is None or not pubkeys:
            return False
        agg_pk = aggregate_public_keys(pubkeys)
        if agg_pk is None:
            return False
        return multi_pairing_is_one([
            (C.g1_neg(C.G1_GEN), signature.point),
            (agg_pk, hash_to_g2(message)),
        ])

    def aggregate_verify(self, signature: Signature,
                         pubkeys: Sequence[PublicKey],
                         messages: Sequence[bytes]) -> bool:
        if signature.point is None:
            return False
        pairs = [(pk.point, hash_to_g2(m)) for pk, m in zip(pubkeys, messages)]
        pairs.append((C.g1_neg(C.G1_GEN), signature.point))
        return multi_pairing_is_one(pairs)

    def verify_signature_sets(self, sets: Sequence[SignatureSet]) -> bool:
        """Random-linear-combination batch verify: with per-set random
        nonzero 64-bit c_i,
            e(-g1, sum_i c_i * sig_i) * prod_i e(c_i * pk_agg_i, H(m_i)) == 1
        """
        if not sets:
            return False
        pairs = []
        sig_acc = None
        for s in sets:
            if s.signature is None or s.signature.point is None:
                return False
            if not s.signing_keys:
                return False
            c = 0
            while c == 0:
                c = secrets.randbits(RAND_BITS)
            agg_pk = aggregate_public_keys(s.signing_keys)
            if agg_pk is None:
                return False
            sig_acc = C.g2_add(sig_acc, _g2_mul_fast(s.signature.point, c))
            pairs.append((C.g1_mul(agg_pk, c), hash_to_g2(s.message)))
        if sig_acc is None:
            return False
        pairs.append((C.g1_neg(C.G1_GEN), sig_acc))
        return multi_pairing_is_one(pairs)


class FakeBackend:
    """Always-true verification for logic tests (deserialization rules
    still apply; only the pairing is skipped)."""

    name = "fake"

    def verify(self, signature, pubkeys, message) -> bool:
        return signature.point is not None and bool(pubkeys)

    def aggregate_verify(self, signature, pubkeys, messages) -> bool:
        return signature.point is not None and bool(pubkeys)

    def verify_signature_sets(self, sets) -> bool:
        if not sets:
            return False
        return all(
            s.signature is not None and s.signature.point is not None
            and s.signing_keys
            for s in sets)


_BACKENDS = {"python": PythonBackend(), "fake": FakeBackend()}
# None until a backend is chosen: then the device backend ("tpu").  The
# python oracle runs only when a caller selects it by name.
_active = None


def register_backend(name: str, backend) -> None:
    _BACKENDS[name] = backend


def set_backend(name: str) -> None:
    global _active
    _active = _BACKENDS[name]


def get_backend():
    global _active
    if _active is None:
        from . import tpu_backend  # noqa: F401  (registers "tpu")
        _active = _BACKENDS["tpu"]
    return _active


def verify_signature_sets(sets: Sequence[SignatureSet]) -> bool:
    return get_backend().verify_signature_sets(sets)
