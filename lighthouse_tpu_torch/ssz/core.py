"""SSZ base machinery and basic types.

Mirrors the reference's ``Encode``/``Decode`` traits
(``consensus/ssz/src/{encode,decode}.rs``) and the basic-type
impls (``consensus/ssz/src/{encode,decode}/impls.rs``), plus the basic-kind
arm of the ``TreeHash`` trait (``consensus/tree_hash/src/lib.rs:106-121``).

Every SSZ type is a *class* (never instantiated for basic kinds); values are
plain Python objects: ``int``, ``bool``, ``bytes``.  Class-level API:

- ``is_fixed_size()`` / ``fixed_size()``
- ``serialize(value) -> bytes`` / ``deserialize(data) -> value``
- ``hash_tree_root(value) -> bytes`` (32 bytes)
- ``default()``
"""

from __future__ import annotations

import hashlib

from ..ops.merkle import merkleize_host, mix_in_length_host

BYTES_PER_CHUNK = 32
BYTES_PER_LENGTH_OFFSET = 4


class SszError(ValueError):
    """Invalid SSZ bytes or value (the ``DecodeError`` analogue,
    ``consensus/ssz/src/decode.rs:9-40``)."""


def _chunkify(data: bytes) -> list[bytes]:
    """Right-pad to a 32-byte multiple and split into chunks."""
    if not data:
        return []
    pad = (-len(data)) % BYTES_PER_CHUNK
    data = data + b"\x00" * pad
    return [data[i:i + BYTES_PER_CHUNK]
            for i in range(0, len(data), BYTES_PER_CHUNK)]


class SszType:
    """Root of the SSZ type-class hierarchy."""

    @classmethod
    def is_fixed_size(cls) -> bool:
        raise NotImplementedError

    @classmethod
    def fixed_size(cls) -> int:
        raise SszError(f"{cls.__name__} is variable-size")

    @classmethod
    def serialize(cls, value) -> bytes:
        raise NotImplementedError

    @classmethod
    def deserialize(cls, data: bytes):
        raise NotImplementedError

    @classmethod
    def hash_tree_root(cls, value) -> bytes:
        raise NotImplementedError

    @classmethod
    def default(cls):
        raise NotImplementedError


# ---------------------------------------------------------------------------
# Unsigned integers
# ---------------------------------------------------------------------------

class _Uint(SszType):
    BITS: int = 0

    @classmethod
    def is_fixed_size(cls) -> bool:
        return True

    @classmethod
    def fixed_size(cls) -> int:
        return cls.BITS // 8

    @classmethod
    def serialize(cls, value) -> bytes:
        try:
            value = value.__index__()  # ints & numpy ints; rejects floats
        except AttributeError:
            raise SszError(f"uint{cls.BITS} requires an integer, "
                           f"got {type(value).__name__}") from None
        if not 0 <= value < (1 << cls.BITS):
            raise SszError(f"{value} out of range for uint{cls.BITS}")
        return value.to_bytes(cls.BITS // 8, "little")

    @classmethod
    def deserialize(cls, data: bytes) -> int:
        if len(data) != cls.BITS // 8:
            raise SszError(
                f"uint{cls.BITS} expects {cls.BITS // 8} bytes, got {len(data)}")
        return int.from_bytes(data, "little")

    @classmethod
    def hash_tree_root(cls, value) -> bytes:
        return cls.serialize(value).ljust(BYTES_PER_CHUNK, b"\x00")

    @classmethod
    def default(cls) -> int:
        return 0


class uint8(_Uint):
    BITS = 8


class uint16(_Uint):
    BITS = 16


class uint32(_Uint):
    BITS = 32


class uint64(_Uint):
    BITS = 64


class uint128(_Uint):
    BITS = 128


class uint256(_Uint):
    BITS = 256


class boolean(SszType):
    @classmethod
    def is_fixed_size(cls) -> bool:
        return True

    @classmethod
    def fixed_size(cls) -> int:
        return 1

    @classmethod
    def serialize(cls, value) -> bytes:
        return b"\x01" if value else b"\x00"

    @classmethod
    def deserialize(cls, data: bytes) -> bool:
        if data == b"\x00":
            return False
        if data == b"\x01":
            return True
        raise SszError(f"invalid boolean byte {data!r}")

    @classmethod
    def hash_tree_root(cls, value) -> bytes:
        return cls.serialize(value).ljust(BYTES_PER_CHUNK, b"\x00")

    @classmethod
    def default(cls) -> bool:
        return False


# ---------------------------------------------------------------------------
# Byte vectors / byte lists
# ---------------------------------------------------------------------------

_byte_vector_cache: dict[int, type] = {}
_byte_list_cache: dict[int, type] = {}


def ByteVector(length: int) -> type:
    """Fixed-length opaque bytes (``FixedVector<u8, N>`` fast path,
    ``consensus/ssz_types/src/fixed_vector.rs``)."""
    cls = _byte_vector_cache.get(length)
    if cls is not None:
        return cls

    class _ByteVector(SszType):
        LENGTH = length

        @classmethod
        def is_fixed_size(cls) -> bool:
            return True

        @classmethod
        def fixed_size(cls) -> int:
            return cls.LENGTH

        @classmethod
        def serialize(cls, value) -> bytes:
            value = bytes(value)
            if len(value) != cls.LENGTH:
                raise SszError(
                    f"ByteVector[{cls.LENGTH}] got {len(value)} bytes")
            return value

        @classmethod
        def deserialize(cls, data: bytes) -> bytes:
            return cls.serialize(data)

        @classmethod
        def hash_tree_root(cls, value) -> bytes:
            return merkleize_host(_chunkify(cls.serialize(value)))

        @classmethod
        def default(cls) -> bytes:
            return b"\x00" * cls.LENGTH

    _ByteVector.__name__ = f"ByteVector{length}"
    _byte_vector_cache[length] = _ByteVector
    return _ByteVector


def ByteList(limit: int) -> type:
    """Variable-length opaque bytes with a max length (e.g. transactions —
    ``consensus/types/src/execution_payload.rs`` ``Transaction``)."""
    cls = _byte_list_cache.get(limit)
    if cls is not None:
        return cls

    class _ByteList(SszType):
        LIMIT = limit

        @classmethod
        def is_fixed_size(cls) -> bool:
            return False

        @classmethod
        def serialize(cls, value) -> bytes:
            value = bytes(value)
            if len(value) > cls.LIMIT:
                raise SszError(f"ByteList[{cls.LIMIT}] got {len(value)} bytes")
            return value

        @classmethod
        def deserialize(cls, data: bytes) -> bytes:
            return cls.serialize(data)

        @classmethod
        def hash_tree_root(cls, value) -> bytes:
            value = cls.serialize(value)
            limit_chunks = (cls.LIMIT + BYTES_PER_CHUNK - 1) // BYTES_PER_CHUNK
            root = merkleize_host(_chunkify(value), limit=max(limit_chunks, 1))
            return mix_in_length_host(root, len(value))

        @classmethod
        def default(cls) -> bytes:
            return b""

    _ByteList.__name__ = f"ByteList{limit}"
    _byte_list_cache[limit] = _ByteList
    return _ByteList


Bytes4 = ByteVector(4)
Bytes20 = ByteVector(20)
Bytes32 = ByteVector(32)
Bytes48 = ByteVector(48)
Bytes96 = ByteVector(96)


def hash_concat(a: bytes, b: bytes) -> bytes:
    """``hash32_concat`` (``crypto/eth2_hashing/src/lib.rs:31-37``)."""
    return hashlib.sha256(a + b).digest()
