"""Columnar SSZ state fields with device-batched Merkleization.

Port of ``lighthouse_tpu/types/columns.py``.  The big ``BeaconState``
fields — roots vectors (8192–65536 entries), balances / inactivity scores
(~1M u64), participation flags (~1M u8) — are stored as numpy columns and
hashed as single batched Merkle reductions on the device
(:func:`device_merkle_root`), instead of the reference's per-field
incremental CPU caches (``consensus/cached_tree_hash``).  Wire encoding
stays bit-identical to SSZ (these are just ``Vector[Bytes32, N]`` /
``List[uint64, N]`` etc. with a columnar value representation).
"""

from __future__ import annotations

import numpy as np

from ..ssz.core import SszError, SszType
from ..ops.merkle import (
    _next_pow2,
    merkleize_auto,
    mix_in_length_host,
)
from ..ops.sha256 import words_to_bytes


def bytes_to_chunk_words(data: bytes) -> np.ndarray:
    """Byte string → ``(k, 8)`` u32 big-endian chunk words (zero-padded)."""
    pad = (-len(data)) % 32
    if pad:
        data = data + b"\x00" * pad
    if not data:
        return np.zeros((0, 8), dtype=np.uint32)
    return np.frombuffer(data, dtype=">u4").astype(np.uint32).reshape(-1, 8)


def device_merkle_root(chunk_words: np.ndarray, limit_chunks: int,
                       length_mixin: int | None = None) -> bytes:
    """Padded Merkle root of ``(k, 8)`` chunk words over a ``limit_chunks``
    tree, as one device reduction; optional SSZ length mixin.

    Widths of at least ``2^CHUNK_LOG2`` chunks go to the sub-tree kernel
    (:func:`..ops.merkle_kernel.merkle_root_chunked`, on the device the
    caller configured); smaller trees take
    :func:`..ops.merkle.merkleize_auto` (host hashing up to its
    threshold)."""
    from ..ops.merkle_kernel import CHUNK_LOG2, merkle_root_chunked

    depth = max((limit_chunks - 1).bit_length(), 0)
    k = chunk_words.shape[0]
    width = _next_pow2(max(k, 1))
    if k != width:
        padded = np.zeros((width, 8), dtype=np.uint32)
        padded[:k] = chunk_words
        chunk_words = padded
    chunk_words = np.asarray(chunk_words, dtype=np.uint32)
    if width >= (1 << CHUNK_LOG2):
        root = words_to_bytes(merkle_root_chunked(chunk_words, depth))
    else:
        root = words_to_bytes(merkleize_auto(chunk_words, depth))
    if length_mixin is not None:
        # SSZ mixes a 256-bit LE length; Python ints are exact here, so even
        # >2^32-entry lists (registry limit is 2^40) hash correctly.
        root = mix_in_length_host(root, int(length_mixin))
    return root


class Roots(np.ndarray):
    """``(n, 32) uint8`` array of 32-byte roots with bytes accessors."""

    @classmethod
    def zeros(cls, n: int) -> "Roots":
        return np.zeros((n, 32), dtype=np.uint8).view(cls)

    @classmethod
    def from_list(cls, items) -> "Roots":
        out = cls.zeros(len(items))
        for i, b in enumerate(items):
            out.set(i, b)
        return out

    def get(self, i: int) -> bytes:
        return self[i].tobytes()

    def set(self, i: int, root: bytes) -> None:
        if len(root) != 32:
            raise SszError("root must be 32 bytes")
        self[i] = np.frombuffer(root, dtype=np.uint8)

    def append_root(self, root: bytes) -> "Roots":
        """Functional append (lists are short-lived; vectors never grow)."""
        out = np.concatenate(
            [self, np.frombuffer(root, dtype=np.uint8)[None, :]], axis=0)
        return out.view(Roots)

    def words(self) -> np.ndarray:
        return np.ascontiguousarray(self).view(">u4").astype(np.uint32)


_cache: dict[tuple, type] = {}


def _cached(key, build):
    cls = _cache.get(key)
    if cls is None:
        cls = build()
        cls.__name__ = f"{key[0]}[{','.join(str(k) for k in key[1:])}]"
        _cache[key] = cls
    return cls


def RootsVector(length: int) -> type:
    """``Vector[Bytes32, N]`` with columnar value + device htr."""
    def build():
        class _RootsVector(SszType):
            LENGTH = length

            @classmethod
            def is_fixed_size(cls) -> bool:
                return True

            @classmethod
            def fixed_size(cls) -> int:
                return 32 * cls.LENGTH

            @classmethod
            def serialize(cls, value) -> bytes:
                value = _as_roots(value)
                if value.shape[0] != cls.LENGTH:
                    raise SszError("roots vector length mismatch")
                return value.tobytes()

            @classmethod
            def deserialize(cls, data: bytes) -> Roots:
                if len(data) != 32 * cls.LENGTH:
                    raise SszError("roots vector byte length mismatch")
                return np.frombuffer(data, dtype=np.uint8).reshape(
                    -1, 32).copy().view(Roots)

            @classmethod
            def hash_tree_root(cls, value) -> bytes:
                value = _as_roots(value)
                if value.shape[0] != cls.LENGTH:
                    raise SszError("roots vector length mismatch")
                return device_merkle_root(value.words(), cls.LENGTH)

            @classmethod
            def leaf_words(cls, value):
                """(chunk words, limit_chunks, length mixin) for the
                incremental hash cache."""
                value = _as_roots(value)
                return value.words(), cls.LENGTH, None

            @classmethod
            def default(cls) -> Roots:
                return Roots.zeros(cls.LENGTH)

        return _RootsVector
    return _cached(("RootsVector", length), build)


def RootsList(limit: int) -> type:
    """``List[Bytes32, N]`` with columnar value + device htr."""
    def build():
        class _RootsList(SszType):
            LIMIT = limit

            @classmethod
            def is_fixed_size(cls) -> bool:
                return False

            @classmethod
            def serialize(cls, value) -> bytes:
                value = _as_roots(value)
                if value.shape[0] > cls.LIMIT:
                    raise SszError("roots list exceeds limit")
                return value.tobytes()

            @classmethod
            def deserialize(cls, data: bytes) -> Roots:
                if len(data) % 32:
                    raise SszError("roots list byte length not 32-multiple")
                out = np.frombuffer(data, dtype=np.uint8).reshape(
                    -1, 32).copy().view(Roots)
                if out.shape[0] > cls.LIMIT:
                    raise SszError("roots list exceeds limit")
                return out

            @classmethod
            def hash_tree_root(cls, value) -> bytes:
                value = _as_roots(value)
                if value.shape[0] > cls.LIMIT:
                    raise SszError("roots list exceeds limit")
                return device_merkle_root(value.words(), cls.LIMIT,
                                          length_mixin=value.shape[0])

            @classmethod
            def leaf_words(cls, value):
                value = _as_roots(value)
                return value.words(), cls.LIMIT, value.shape[0]

            @classmethod
            def default(cls) -> Roots:
                return Roots.zeros(0)

        return _RootsList
    return _cached(("RootsList", limit), build)


def _as_roots(value) -> Roots:
    if isinstance(value, np.ndarray) and value.dtype == np.uint8 \
            and value.ndim == 2 and value.shape[1] == 32:
        return value.view(Roots)
    return Roots.from_list(list(value))


def _packed_uint(name: str, dtype, bits: int, bound: int, is_list: bool) -> type:
    per_chunk = 32 // (bits // 8)
    limit_chunks = max((bound + per_chunk - 1) // per_chunk, 1)

    class _Packed(SszType):
        BOUND = bound
        DTYPE = dtype

        @classmethod
        def is_fixed_size(cls) -> bool:
            return not is_list

        @classmethod
        def fixed_size(cls) -> int:
            if is_list:
                return SszType.fixed_size.__func__(cls)  # raises
            return bound * (bits // 8)

        @classmethod
        def _as_arr(cls, value) -> np.ndarray:
            arr = np.asarray(value)
            if arr.ndim != 1:
                raise SszError("packed column must be one-dimensional")
            if arr.size == 0:
                arr = np.zeros(0, dtype=dtype)
            if arr.dtype != dtype:
                if arr.dtype.kind not in "iu" and arr.dtype != bool:
                    raise SszError(f"cannot pack {arr.dtype} as uint{bits}")
                if arr.dtype.kind == "i" and int(arr.min()) < 0:
                    raise SszError("negative value in unsigned column")
                if (np.dtype(arr.dtype).itemsize * 8 > bits
                        and int(arr.max()) >= (1 << bits)):
                    raise SszError(f"value out of range for uint{bits}")
                arr = arr.astype(dtype)
            if is_list:
                if arr.shape[0] > bound:
                    raise SszError("list exceeds limit")
            elif arr.shape[0] != bound:
                raise SszError("vector length mismatch")
            return arr

        @classmethod
        def serialize(cls, value) -> bytes:
            arr = cls._as_arr(value)
            return arr.astype(arr.dtype.newbyteorder("<"), copy=False).tobytes()

        @classmethod
        def deserialize(cls, data: bytes) -> np.ndarray:
            item = bits // 8
            if len(data) % item:
                raise SszError("byte length not a multiple of element size")
            arr = np.frombuffer(
                data, dtype=np.dtype(dtype).newbyteorder("<")).astype(dtype)
            return cls._as_arr(arr)

        @classmethod
        def hash_tree_root(cls, value) -> bytes:
            arr = cls._as_arr(value)
            words = bytes_to_chunk_words(
                arr.astype(arr.dtype.newbyteorder("<"), copy=False).tobytes())
            return device_merkle_root(
                words, limit_chunks,
                length_mixin=arr.shape[0] if is_list else None)

        @classmethod
        def leaf_words(cls, value):
            arr = cls._as_arr(value)
            words = bytes_to_chunk_words(
                arr.astype(arr.dtype.newbyteorder("<"), copy=False).tobytes())
            return words, limit_chunks, (arr.shape[0] if is_list else None)

        @classmethod
        def default(cls) -> np.ndarray:
            return np.zeros(0 if is_list else bound, dtype=dtype)

    return _Packed


def PackedU64List(limit: int) -> type:
    """``List[uint64, N]`` (balances, inactivity scores) — device htr."""
    return _cached(("PackedU64List", limit),
                   lambda: _packed_uint("u64l", np.uint64, 64, limit, True))


def PackedU64Vector(length: int) -> type:
    """``Vector[uint64, N]`` (slashings) — device htr."""
    return _cached(("PackedU64Vector", length),
                   lambda: _packed_uint("u64v", np.uint64, 64, length, False))


def PackedU8List(limit: int) -> type:
    """``List[uint8, N]`` (participation flags) — device htr."""
    return _cached(("PackedU8List", limit),
                   lambda: _packed_uint("u8l", np.uint8, 8, limit, True))
