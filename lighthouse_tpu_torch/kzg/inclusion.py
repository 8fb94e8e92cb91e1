"""BlobSidecar commitment inclusion proofs (Deneb p2p spec; port of
``lighthouse_tpu/kzg/inclusion.py``).

A sidecar proves its ``kzg_commitment`` sits at ``index`` inside the
block body the sidecar's ``signed_block_header`` names — the Merkle branch
from the commitment's leaf up to ``body_root``
(``verify_blob_sidecar_inclusion_proof``, deneb/p2p-interface.md).  The
branch has three segments, bottom-up:

1. ``log2(MAX_BLOB_COMMITMENTS_PER_BLOCK)`` siblings inside the
   commitments list's data tree (leaf = hash_tree_root of the Bytes48);
2. the list's length chunk (SSZ ``mix_in_length`` sibling);
3. ``ceil(log2(#body fields))`` siblings in the body's field tree.

For the Deneb body (12 fields → depth 4) this reproduces the spec depths
exactly: mainnet 12 + 1 + 4 = 17, minimal 4 + 1 + 4 = 9.
"""

from __future__ import annotations

import hashlib
from typing import List

from ..ops.merkle import ZERO_HASHES_BYTES


def _hash(a: bytes, b: bytes) -> bytes:
    return hashlib.sha256(a + b).digest()


def _subtree_branch(leaves: List[bytes], depth: int,
                    index: int) -> List[bytes]:
    """Branch for ``leaves[index]`` in a zero-padded tree of ``depth``
    levels (virtual padding nodes at level l are ZERO_HASHES[l])."""
    branch = []
    level = list(leaves)
    idx = index
    for d in range(depth):
        sib = idx ^ 1
        branch.append(level[sib] if sib < len(level)
                      else ZERO_HASHES_BYTES[d])
        nxt = []
        for i in range(0, len(level), 2):
            left = level[i]
            right = level[i + 1] if i + 1 < len(level) \
                else ZERO_HASHES_BYTES[d]
            nxt.append(_hash(left, right))
        level = nxt or [ZERO_HASHES_BYTES[d + 1]]
        idx >>= 1
    return branch


def _body_field_roots(body) -> List[bytes]:
    cls = type(body)
    return [ftype.hash_tree_root(getattr(body, fname))
            for fname, ftype in cls.FIELDS.items()]


def _field_tree_depth(n_fields: int) -> int:
    d = 0
    while (1 << d) < n_fields:
        d += 1
    return d


def _commitment_leaf(commitment: bytes) -> bytes:
    """hash_tree_root of a Bytes48: two 32-byte chunks hashed."""
    c = bytes(commitment)
    return _hash(c[:32], c[32:] + b"\x00" * 16)


def blob_sidecar_inclusion_proof(body, index: int, preset) -> List[bytes]:
    """Build the branch for ``body.blob_kzg_commitments[index]``."""
    limit = preset.MAX_BLOB_COMMITMENTS_PER_BLOCK
    list_depth = _field_tree_depth(limit)
    commitments = list(body.blob_kzg_commitments)
    if not 0 <= index < len(commitments):
        raise IndexError("blob index outside the block's commitments")
    leaves = [_commitment_leaf(c) for c in commitments]
    branch = _subtree_branch(leaves, list_depth, index)
    branch.append(len(commitments).to_bytes(32, "little"))  # length chunk
    field_roots = _body_field_roots(body)
    field_idx = list(type(body).FIELDS).index("blob_kzg_commitments")
    branch.extend(_subtree_branch(field_roots,
                                  _field_tree_depth(len(field_roots)),
                                  field_idx))
    return branch


def verify_blob_sidecar_inclusion_proof(sidecar, preset) -> bool:
    """Fold the sidecar's branch from its commitment leaf up to the header
    body_root (spec ``verify_blob_sidecar_inclusion_proof``)."""
    limit = preset.MAX_BLOB_COMMITMENTS_PER_BLOCK
    list_depth = _field_tree_depth(limit)
    # 12 Deneb body fields; the commitments list is field index 11.
    field_idx, field_depth = 11, 4
    branch = [bytes(b) for b in sidecar.kzg_commitment_inclusion_proof]
    if len(branch) != list_depth + 1 + field_depth:
        return False
    # Bottom-up direction bits: blob index inside the list tree, then 0
    # (the data root is the LEFT child of the length mix-in), then the
    # field index inside the body tree.
    bits = [(int(sidecar.index) >> d) & 1 for d in range(list_depth)]
    bits.append(0)
    bits.extend((field_idx >> d) & 1 for d in range(field_depth))
    node = _commitment_leaf(sidecar.kzg_commitment)
    for bit, sib in zip(bits, branch):
        node = _hash(sib, node) if bit else _hash(node, sib)
    return node == bytes(sidecar.signed_block_header.message.body_root)
