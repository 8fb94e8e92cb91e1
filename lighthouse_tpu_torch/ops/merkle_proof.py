"""Merkle branch generation and verification, on the host.

Port of ``lighthouse_tpu/ops/merkle_proof.py`` as it is: ``MerkleTree``
(an incremental depth-``d`` tree over pushed leaves with zero-subtree
padding, and its proofs), ``verify_merkle_proof`` (the spec's
``is_valid_merkle_branch``) and ``DepositTree`` (the deposit contract's
tree with the count mixed in).  Host-side by design: deposits arrive a
few per block; the resident device trees serve branches through
:mod:`.proof_engine`.
"""

from __future__ import annotations

import hashlib

from .merkle import ZERO_HASHES_BYTES


def _hash(a: bytes, b: bytes) -> bytes:
    return hashlib.sha256(a + b).digest()


class MerkleTree:
    """Incremental fixed-depth binary Merkle tree with proof generation.

    Mirrors ``merkle_proof::MerkleTree`` semantics: a depth-``d`` tree whose
    leaves are pushed left-to-right, with all-zero subtrees padding the right.
    """

    def __init__(self, depth: int):
        if not 0 <= depth < len(ZERO_HASHES_BYTES):
            raise ValueError(f"unsupported depth {depth}")
        self.depth = depth
        self.leaves: list[bytes] = []

    def push_leaf(self, leaf: bytes) -> None:
        if len(leaf) != 32:
            raise ValueError("leaf must be 32 bytes")
        if len(self.leaves) >= (1 << self.depth):
            raise ValueError("tree is full")
        self.leaves.append(leaf)

    def _levels(self) -> list[list[bytes]]:
        """All levels bottom-up; level ``i`` holds the non-zero prefix."""
        levels = [list(self.leaves)]
        for d in range(self.depth):
            prev = levels[-1]
            if len(prev) % 2:
                prev = prev + [ZERO_HASHES_BYTES[d]]
            levels.append([_hash(prev[i], prev[i + 1])
                           for i in range(0, len(prev), 2)])
        return levels

    def root(self) -> bytes:
        if not self.leaves:
            return ZERO_HASHES_BYTES[self.depth]
        return self._levels()[self.depth][0]

    def proof(self, index: int) -> list[bytes]:
        """Sibling branch for leaf ``index``, bottom-up (length ``depth``)."""
        if not 0 <= index < (1 << self.depth):
            raise ValueError(f"index {index} out of range")
        levels = self._levels()
        branch = []
        for d in range(self.depth):
            sibling = (index >> d) ^ 1
            level = levels[d]
            branch.append(level[sibling] if sibling < len(level)
                          else ZERO_HASHES_BYTES[d])
        return branch


def verify_merkle_proof(leaf: bytes, branch: list[bytes], depth: int,
                        index: int, root: bytes) -> bool:
    """Spec ``is_valid_merkle_branch``."""
    value = leaf
    for i in range(depth):
        if (index >> i) & 1:
            value = _hash(branch[i], value)
        else:
            value = _hash(value, branch[i])
    return value == root


class DepositTree:
    """Deposit-contract tree: depth-32 ``MerkleTree`` whose root mixes in the
    deposit count, with proofs of length ``depth + 1`` (count as last node) —
    matching ``is_valid_merkle_branch(…, DEPOSIT_CONTRACT_TREE_DEPTH + 1, …)``
    in ``process_deposit`` and the eth1 ``deposit_cache`` layout."""

    def __init__(self, depth: int = 32):
        self.tree = MerkleTree(depth)

    def push(self, deposit_data_root: bytes) -> None:
        self.tree.push_leaf(deposit_data_root)

    @property
    def count(self) -> int:
        return len(self.tree.leaves)

    def root(self) -> bytes:
        return _hash(self.tree.root(), self.count.to_bytes(32, "little"))

    def proof(self, index: int) -> list[bytes]:
        return (self.tree.proof(index)
                + [self.count.to_bytes(32, "little")])
