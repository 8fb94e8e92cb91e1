"""SSZ composite types: Vector, List, Bitvector, Bitlist, Container.

Mirrors ``consensus/ssz_types/src/{fixed_vector,variable_list,
bitfield}.rs`` (length-typed bounds) and the container encode/decode scheme of
``consensus/ssz/src/{encode,decode}.rs`` (fixed parts + 4-byte offsets for
variable parts, with the strict offset checks of ``SszDecoderBuilder``).
The ``Container`` metaclass plays the role of ``ssz_derive`` +
``tree_hash_derive`` proc-macros: field layout is read from class annotations.

Basic-element vectors/lists accept and produce numpy arrays where that is the
natural value (hot state fields like ``balances``); serialization of those is
a single little-endian ``tobytes``.
"""

from __future__ import annotations

import numpy as np

from .core import (
    BYTES_PER_CHUNK,
    BYTES_PER_LENGTH_OFFSET,
    SszError,
    SszType,
    _Uint,
    _chunkify,
    boolean,
)
from ..ops.merkle import merkleize_host, mix_in_length_host

_UINT_DTYPES = {8: np.uint8, 16: np.uint16, 32: np.uint32, 64: np.uint64}


def _is_basic(t: type) -> bool:
    return (isinstance(t, type)
            and (issubclass(t, _Uint) or issubclass(t, boolean)))


def _serialize_basic_seq(elem_t: type, values) -> bytes:
    """Fast path: one numpy tobytes for uint sequences, per-element otherwise.

    Range-validated: signed/oversized inputs raise instead of wrapping — the
    consensus encoding must never silently produce wrong bytes.
    """
    if issubclass(elem_t, _Uint) and elem_t.BITS in _UINT_DTYPES:
        dtype = _UINT_DTYPES[elem_t.BITS]
        try:
            arr = np.asarray(values)
        except OverflowError as e:
            raise SszError(f"value out of range for uint{elem_t.BITS}") from e
        if arr.ndim != 1:
            raise SszError("basic sequence must be one-dimensional")
        if arr.size == 0:
            return b""
        if arr.dtype == dtype:
            pass  # already exact — the hot case (state SoA columns)
        elif arr.dtype.kind in "iu" or arr.dtype == bool:
            if arr.dtype.kind == "i" and arr.size and int(arr.min()) < 0:
                raise SszError(f"negative value in uint{elem_t.BITS} sequence")
            if (arr.dtype.itemsize * 8 > elem_t.BITS and arr.size
                    and int(arr.max()) >= (1 << elem_t.BITS)):
                raise SszError(f"value out of range for uint{elem_t.BITS}")
            arr = arr.astype(dtype)
        elif arr.dtype == object:
            # Python ints too big for int64 inference; go per-element.
            return b"".join(elem_t.serialize(v) for v in values)
        else:
            raise SszError(
                f"cannot serialize {arr.dtype} array as uint{elem_t.BITS}")
        return arr.astype(arr.dtype.newbyteorder("<"), copy=False).tobytes()
    return b"".join(elem_t.serialize(v) for v in values)


def _deserialize_basic_seq(elem_t: type, data: bytes):
    if issubclass(elem_t, _Uint) and elem_t.BITS in _UINT_DTYPES:
        dtype = np.dtype(_UINT_DTYPES[elem_t.BITS]).newbyteorder("<")
        if len(data) % dtype.itemsize:
            raise SszError("byte length not a multiple of element size")
        return np.frombuffer(data, dtype=dtype).astype(
            _UINT_DTYPES[elem_t.BITS])
    size = elem_t.fixed_size()
    if len(data) % size:
        raise SszError("byte length not a multiple of element size")
    return [elem_t.deserialize(data[i:i + size])
            for i in range(0, len(data), size)]


def _seq_len(values) -> int:
    return int(values.shape[0]) if isinstance(values, np.ndarray) else len(values)


def _decode_fixed_seq(elem_t: type, data: bytes):
    """Fixed-size composite elements, concatenated."""
    size = elem_t.fixed_size()
    if len(data) % size:
        raise SszError("byte length not a multiple of element size")
    return [elem_t.deserialize(data[i:i + size])
            for i in range(0, len(data), size)]


def _decode_variable_seq(elem_t: type, data: bytes):
    """Variable-size elements: leading offset table, strictly validated
    (``consensus/ssz/src/decode/impls.rs`` Vec impl)."""
    if not data:
        return []
    if len(data) < BYTES_PER_LENGTH_OFFSET:
        raise SszError("truncated offset table")
    first = int.from_bytes(data[:BYTES_PER_LENGTH_OFFSET], "little")
    if first % BYTES_PER_LENGTH_OFFSET or first == 0:
        raise SszError("invalid first offset")
    count = first // BYTES_PER_LENGTH_OFFSET
    offsets = []
    for i in range(count):
        o = int.from_bytes(
            data[i * 4:(i + 1) * 4], "little")
        offsets.append(o)
    offsets.append(len(data))
    if offsets[0] != first or first > len(data):
        raise SszError("first offset out of bounds")
    out = []
    for i in range(count):
        if offsets[i] > offsets[i + 1]:
            raise SszError("offsets not monotonically increasing")
        out.append(elem_t.deserialize(data[offsets[i]:offsets[i + 1]]))
    return out


def _serialize_variable_seq(elem_t: type, values) -> bytes:
    parts = [elem_t.serialize(v) for v in values]
    fixed_len = BYTES_PER_LENGTH_OFFSET * len(parts)
    offsets = []
    pos = fixed_len
    for p in parts:
        offsets.append(pos.to_bytes(BYTES_PER_LENGTH_OFFSET, "little"))
        pos += len(p)
    return b"".join(offsets) + b"".join(parts)


def _htr_elements(elem_t: type, values, limit_chunks: int) -> bytes:
    """Merkle root of a sequence: packed chunks for basic elements, one
    32-byte root per element for composites
    (``consensus/tree_hash/src/lib.rs`` Vector/List kinds)."""
    if _is_basic(elem_t):
        chunks = _chunkify(_serialize_basic_seq(elem_t, values))
    else:
        chunks = [elem_t.hash_tree_root(v) for v in values]
    return merkleize_host(chunks, limit=max(limit_chunks, 1))


def _basic_chunk_count(elem_t: type, n: int) -> int:
    return (n * elem_t.fixed_size() + BYTES_PER_CHUNK - 1) // BYTES_PER_CHUNK


_vector_cache: dict[tuple, type] = {}
_list_cache: dict[tuple, type] = {}
_bitvector_cache: dict[int, type] = {}
_bitlist_cache: dict[int, type] = {}


def Vector(elem_t: type, length: int) -> type:
    """``FixedVector<T, N>``: exactly ``length`` elements."""
    key = (elem_t, length)
    cls = _vector_cache.get(key)
    if cls is not None:
        return cls
    if length <= 0:
        raise SszError("Vector length must be positive")

    class _Vector(SszType):
        ELEM = elem_t
        LENGTH = length

        @classmethod
        def is_fixed_size(cls) -> bool:
            return cls.ELEM.is_fixed_size()

        @classmethod
        def fixed_size(cls) -> int:
            if not cls.is_fixed_size():
                return super().fixed_size()
            return cls.ELEM.fixed_size() * cls.LENGTH

        @classmethod
        def serialize(cls, values) -> bytes:
            if _seq_len(values) != cls.LENGTH:
                raise SszError(
                    f"Vector[{cls.ELEM.__name__},{cls.LENGTH}] got "
                    f"{_seq_len(values)} elements")
            if _is_basic(cls.ELEM):
                return _serialize_basic_seq(cls.ELEM, values)
            if cls.ELEM.is_fixed_size():
                return b"".join(cls.ELEM.serialize(v) for v in values)
            return _serialize_variable_seq(cls.ELEM, values)

        @classmethod
        def deserialize(cls, data: bytes):
            if _is_basic(cls.ELEM):
                out = _deserialize_basic_seq(cls.ELEM, data)
            elif cls.ELEM.is_fixed_size():
                out = _decode_fixed_seq(cls.ELEM, data)
            else:
                out = _decode_variable_seq(cls.ELEM, data)
            if _seq_len(out) != cls.LENGTH:
                raise SszError("vector length mismatch")
            return out

        @classmethod
        def hash_tree_root(cls, values) -> bytes:
            if _seq_len(values) != cls.LENGTH:
                raise SszError("vector length mismatch")
            if _is_basic(cls.ELEM):
                limit = _basic_chunk_count(cls.ELEM, cls.LENGTH)
            else:
                limit = cls.LENGTH
            return _htr_elements(cls.ELEM, values, limit)

        @classmethod
        def default(cls):
            if issubclass(cls.ELEM, _Uint) and cls.ELEM.BITS in _UINT_DTYPES:
                return np.zeros(cls.LENGTH, dtype=_UINT_DTYPES[cls.ELEM.BITS])
            return [cls.ELEM.default() for _ in range(cls.LENGTH)]

    _Vector.__name__ = f"Vector[{elem_t.__name__},{length}]"
    _vector_cache[key] = _Vector
    return _Vector


def List(elem_t: type, limit: int) -> type:
    """``VariableList<T, N>``: up to ``limit`` elements.  The bound is what
    makes worst-case device batch shapes static (``SURVEY.md §5.7``)."""
    key = (elem_t, limit)
    cls = _list_cache.get(key)
    if cls is not None:
        return cls

    class _List(SszType):
        ELEM = elem_t
        LIMIT = limit

        @classmethod
        def is_fixed_size(cls) -> bool:
            return False

        @classmethod
        def serialize(cls, values) -> bytes:
            if _seq_len(values) > cls.LIMIT:
                raise SszError(
                    f"List[{cls.ELEM.__name__},{cls.LIMIT}] got "
                    f"{_seq_len(values)} elements")
            if _is_basic(cls.ELEM):
                return _serialize_basic_seq(cls.ELEM, values)
            if cls.ELEM.is_fixed_size():
                return b"".join(cls.ELEM.serialize(v) for v in values)
            return _serialize_variable_seq(cls.ELEM, values)

        @classmethod
        def deserialize(cls, data: bytes):
            if _is_basic(cls.ELEM):
                out = _deserialize_basic_seq(cls.ELEM, data)
            elif cls.ELEM.is_fixed_size():
                out = _decode_fixed_seq(cls.ELEM, data)
            else:
                out = _decode_variable_seq(cls.ELEM, data)
            if _seq_len(out) > cls.LIMIT:
                raise SszError("list exceeds limit")
            return out

        @classmethod
        def hash_tree_root(cls, values) -> bytes:
            n = _seq_len(values)
            if n > cls.LIMIT:
                raise SszError("list exceeds limit")
            if _is_basic(cls.ELEM):
                limit = _basic_chunk_count(cls.ELEM, cls.LIMIT)
            else:
                limit = cls.LIMIT
            root = _htr_elements(cls.ELEM, values, limit)
            return mix_in_length_host(root, n)

        @classmethod
        def default(cls):
            if issubclass(cls.ELEM, _Uint) and cls.ELEM.BITS in _UINT_DTYPES:
                return np.zeros(0, dtype=_UINT_DTYPES[cls.ELEM.BITS])
            return []

    _List.__name__ = f"List[{elem_t.__name__},{limit}]"
    _list_cache[key] = _List
    return _List


# ---------------------------------------------------------------------------
# Bitfields
# ---------------------------------------------------------------------------

def _bits_to_bytes(bits: np.ndarray) -> bytes:
    return np.packbits(bits, bitorder="little").tobytes()


def _bytes_to_bits(data: bytes, n: int) -> np.ndarray:
    return np.unpackbits(
        np.frombuffer(data, dtype=np.uint8), bitorder="little")[:n].astype(bool)


def Bitvector(length: int) -> type:
    """``BitVector<N>`` (``consensus/ssz_types/src/bitfield.rs``)."""
    cls = _bitvector_cache.get(length)
    if cls is not None:
        return cls
    if length <= 0:
        raise SszError("Bitvector length must be positive")

    class _Bitvector(SszType):
        LENGTH = length

        @classmethod
        def is_fixed_size(cls) -> bool:
            return True

        @classmethod
        def fixed_size(cls) -> int:
            return (cls.LENGTH + 7) // 8

        @classmethod
        def serialize(cls, bits) -> bytes:
            bits = np.asarray(bits, dtype=bool)
            if bits.shape != (cls.LENGTH,):
                raise SszError(f"Bitvector[{cls.LENGTH}] shape mismatch")
            return _bits_to_bytes(bits)

        @classmethod
        def deserialize(cls, data: bytes) -> np.ndarray:
            if len(data) != cls.fixed_size():
                raise SszError("bitvector byte length mismatch")
            # Excess high bits in the last byte must be zero.
            all_bits = np.unpackbits(
                np.frombuffer(data, dtype=np.uint8), bitorder="little")
            if all_bits[cls.LENGTH:].any():
                raise SszError("bitvector has set padding bits")
            return all_bits[:cls.LENGTH].astype(bool)

        @classmethod
        def hash_tree_root(cls, bits) -> bytes:
            limit = (cls.LENGTH + 255) // 256
            return merkleize_host(_chunkify(cls.serialize(bits)),
                                  limit=max(limit, 1))

        @classmethod
        def default(cls) -> np.ndarray:
            return np.zeros(cls.LENGTH, dtype=bool)

    _Bitvector.__name__ = f"Bitvector[{length}]"
    _bitvector_cache[length] = _Bitvector
    return _Bitvector


def Bitlist(limit: int) -> type:
    """``BitList<N>`` with the trailing delimiter bit."""
    cls = _bitlist_cache.get(limit)
    if cls is not None:
        return cls

    class _Bitlist(SszType):
        LIMIT = limit

        @classmethod
        def is_fixed_size(cls) -> bool:
            return False

        @classmethod
        def serialize(cls, bits) -> bytes:
            bits = np.asarray(bits, dtype=bool)
            if bits.ndim != 1 or bits.shape[0] > cls.LIMIT:
                raise SszError(f"Bitlist[{cls.LIMIT}] length mismatch")
            with_delim = np.append(bits, True)
            return _bits_to_bytes(with_delim)

        @classmethod
        def deserialize(cls, data: bytes) -> np.ndarray:
            if not data:
                raise SszError("empty bitlist bytes")
            if data[-1] == 0:
                raise SszError("bitlist missing delimiter bit")
            all_bits = np.unpackbits(
                np.frombuffer(data, dtype=np.uint8), bitorder="little")
            # data[-1] != 0, so the delimiter (highest set bit) is in the
            # last byte.
            n = len(all_bits) - 1 - int(np.argmax(all_bits[::-1]))
            if n > cls.LIMIT:
                raise SszError("bitlist exceeds limit")
            return all_bits[:n].astype(bool)

        @classmethod
        def hash_tree_root(cls, bits) -> bytes:
            bits = np.asarray(bits, dtype=bool)
            if bits.shape[0] > cls.LIMIT:
                raise SszError("bitlist exceeds limit")
            limit = (cls.LIMIT + 255) // 256
            root = merkleize_host(_chunkify(_bits_to_bytes(bits)),
                                  limit=max(limit, 1))
            return mix_in_length_host(root, int(bits.shape[0]))

        @classmethod
        def default(cls) -> np.ndarray:
            return np.zeros(0, dtype=bool)

    _Bitlist.__name__ = f"Bitlist[{limit}]"
    _bitlist_cache[limit] = _Bitlist
    return _Bitlist


# ---------------------------------------------------------------------------
# Containers
# ---------------------------------------------------------------------------

class ContainerMeta(type):
    """Collects SSZ field layout from class annotations — the framework's
    stand-in for ``#[derive(Encode, Decode, TreeHash)]``
    (``consensus/ssz_derive/src/lib.rs``)."""

    def __new__(mcs, name, bases, ns):
        import sys
        cls = super().__new__(mcs, name, bases, ns)
        # Inherit already-resolved base layouts (base-first field order,
        # like superstruct's common-field prefix), then this class's own
        # annotations.
        fields: dict[str, type] = {}
        for base in bases:
            fields.update(getattr(base, "FIELDS", {}))
        try:
            defining_globals = sys._getframe(1).f_globals
        except Exception:
            defining_globals = {}
        for fname, ftype in ns.get("__annotations__", {}).items():
            if isinstance(ftype, str):
                # PEP 563 (`from __future__ import annotations`) turns
                # annotations into strings; resolve them in the defining
                # scope, loudly, rather than silently producing an empty
                # field layout.
                try:
                    ftype = eval(ftype, defining_globals, dict(ns))  # noqa: S307
                except Exception as e:
                    raise SszError(
                        f"{name}.{fname}: cannot resolve string annotation "
                        f"{ftype!r} (PEP 563)") from e
            if isinstance(ftype, type) and issubclass(ftype, SszType):
                fields[fname] = ftype
        cls.FIELDS = fields
        return cls


class Container(SszType, metaclass=ContainerMeta):
    """SSZ container; subclass with annotated fields:

    ``class Checkpoint(Container): epoch: uint64; root: Bytes32``

    Instances hold field values as attributes.  Field order = annotation
    order (MRO base-first), matching SSZ's struct field order.
    """

    FIELDS: dict[str, type] = {}

    def __init__(self, **kwargs):
        cls = type(self)
        for fname, ftype in cls.FIELDS.items():
            if fname in kwargs:
                setattr(self, fname, kwargs.pop(fname))
            else:
                setattr(self, fname, ftype.default())
        if kwargs:
            raise TypeError(
                f"{cls.__name__} has no fields {sorted(kwargs)}")

    def __eq__(self, other):
        if type(self) is not type(other):
            return NotImplemented
        for fname in type(self).FIELDS:
            a, b = getattr(self, fname), getattr(other, fname)
            if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
                if not np.array_equal(np.asarray(a), np.asarray(b)):
                    return False
            elif a != b:
                return False
        return True

    def __repr__(self):
        inner = ", ".join(f"{f}={getattr(self, f)!r}"
                          for f in list(type(self).FIELDS)[:4])
        more = "" if len(type(self).FIELDS) <= 4 else ", …"
        return f"{type(self).__name__}({inner}{more})"

    def copy(self):
        """Field-shallow copy: containers recurse, lists/arrays are copied,
        scalars/bytes shared (immutable)."""
        out = type(self).__new__(type(self))
        for fname in type(self).FIELDS:
            v = getattr(self, fname)
            if isinstance(v, Container):
                v = v.copy()
            elif isinstance(v, np.ndarray):
                v = v.copy()
            elif getattr(v, "__ssz_mutable__", False):
                v = v.copy()  # e.g. the SoA ValidatorRegistry
            elif isinstance(v, list):
                v = [e.copy() if isinstance(e, Container)
                     else (e.copy() if isinstance(e, np.ndarray) else e)
                     for e in v]
            setattr(out, fname, v)
        return out

    # -- SszType classmethods ------------------------------------------------

    @classmethod
    def is_fixed_size(cls) -> bool:
        return all(t.is_fixed_size() for t in cls.FIELDS.values())

    @classmethod
    def fixed_size(cls) -> int:
        if not cls.is_fixed_size():
            return super().fixed_size()
        return sum(t.fixed_size() for t in cls.FIELDS.values())

    @classmethod
    def serialize(cls, value) -> bytes:
        # Class-level API (uniform with every SszType); instances use
        # ``encode()``.
        self = value
        fixed_parts: list[bytes | None] = []
        variable_parts: list[bytes] = []
        for fname, ftype in cls.FIELDS.items():
            v = getattr(self, fname)
            if ftype.is_fixed_size():
                fixed_parts.append(ftype.serialize(v))
                variable_parts.append(b"")
            else:
                fixed_parts.append(None)
                variable_parts.append(ftype.serialize(v))
        fixed_len = sum(
            len(p) if p is not None else BYTES_PER_LENGTH_OFFSET
            for p in fixed_parts)
        out = []
        pos = fixed_len
        for p, v in zip(fixed_parts, variable_parts):
            if p is not None:
                out.append(p)
            else:
                out.append(pos.to_bytes(BYTES_PER_LENGTH_OFFSET, "little"))
                pos += len(v)
        out.extend(v for v in variable_parts if v)
        return b"".join(out)

    def encode(self) -> bytes:
        return type(self).serialize(self)

    @classmethod
    def deserialize(cls, data: bytes):
        """Strict offset-validated decode (``SszDecoderBuilder``,
        ``consensus/ssz/src/decode.rs:196-344``)."""
        fixed_len = sum(
            t.fixed_size() if t.is_fixed_size() else BYTES_PER_LENGTH_OFFSET
            for t in cls.FIELDS.values())
        if len(data) < fixed_len:
            raise SszError(
                f"{cls.__name__}: {len(data)} bytes < fixed length {fixed_len}")
        values = {}
        offsets: list[tuple[str, type, int]] = []
        pos = 0
        for fname, ftype in cls.FIELDS.items():
            if ftype.is_fixed_size():
                size = ftype.fixed_size()
                values[fname] = ftype.deserialize(data[pos:pos + size])
                pos += size
            else:
                off = int.from_bytes(
                    data[pos:pos + BYTES_PER_LENGTH_OFFSET], "little")
                offsets.append((fname, ftype, off))
                pos += BYTES_PER_LENGTH_OFFSET
        if offsets:
            if offsets[0][2] != fixed_len:
                raise SszError("first offset does not point at end of fixed part")
            bounds = [o for (_, _, o) in offsets] + [len(data)]
            for i, (fname, ftype, off) in enumerate(offsets):
                if bounds[i] > bounds[i + 1] or off > len(data):
                    raise SszError("container offsets invalid")
                values[fname] = ftype.deserialize(data[bounds[i]:bounds[i + 1]])
        elif len(data) != fixed_len:
            raise SszError("trailing bytes after fixed-size container")
        out = cls.__new__(cls)
        for fname in cls.FIELDS:
            setattr(out, fname, values[fname])
        return out

    @classmethod
    def hash_tree_root(cls, value) -> bytes:
        self = value
        leaves = [ftype.hash_tree_root(getattr(self, fname))
                  for fname, ftype in cls.FIELDS.items()]
        return merkleize_host(leaves)

    def tree_hash_root(self) -> bytes:
        return type(self).hash_tree_root(self)

    @classmethod
    def default(cls):
        return cls()
