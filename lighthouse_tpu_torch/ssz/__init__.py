"""SimpleSerialize (SSZ): encoding, decoding, and Merkleization.

The framework's counterpart of the reference's serialization layer —
``consensus/ssz`` (Encode/Decode), ``consensus/ssz_types``
(length-bounded containers), and ``consensus/tree_hash`` (hash_tree_root).
Where the reference expresses bounds in the type system via ``typenum``,
here each SSZ type is a Python class object carrying its bound; bounds are
still static per type, which is what makes worst-case batch shapes known to
XLA (``SURVEY.md §5.7``).

Host (de)serialization is numpy-accelerated for basic-element vectors/lists;
Merkleization defers to :mod:`lighthouse_tpu_torch.ops.merkle` so that large trees
can run as batched device reductions.
"""

from .core import (
    SszError,
    SszType,
    BYTES_PER_CHUNK,
    BYTES_PER_LENGTH_OFFSET,
    boolean,
    uint8,
    uint16,
    uint32,
    uint64,
    uint128,
    uint256,
    ByteVector,
    ByteList,
    Bytes4,
    Bytes20,
    Bytes32,
    Bytes48,
    Bytes96,
)
from .composite import (
    Vector,
    List,
    Bitvector,
    Bitlist,
    Container,
)

__all__ = [
    "SszError", "SszType", "BYTES_PER_CHUNK", "BYTES_PER_LENGTH_OFFSET",
    "boolean", "uint8", "uint16", "uint32", "uint64", "uint128", "uint256",
    "ByteVector", "ByteList", "Bytes4", "Bytes20", "Bytes32", "Bytes48",
    "Bytes96", "Vector", "List", "Bitvector", "Bitlist", "Container",
]
