"""Full ↔ blinded payload conversions — the working core of
``consensus/types/src/payload.rs`` (``AbstractExecPayload`` /
``BlindedPayload`` / ``FullPayload``).

The type-level machinery the reference needs (one generic block type
instantiated at two payload types) collapses in Python to two parallel
container families (:mod:`.factory`) plus these conversions.  The
load-bearing invariant: ``blind_block(b).tree_hash_root() ==
b.tree_hash_root()`` — the builder signs over the same root the proposer
committed to, because an SSZ header whose ``transactions_root`` is the
tree-hash of the transactions list merkleizes identically to the full
payload.
"""

from __future__ import annotations


def payload_to_header(payload, T, fork):
    """ExecutionPayload → ExecutionPayloadHeader (`payload.rs` From impl)."""
    header_cls = T.payload_header_cls(fork)
    payload_cls = T.payload_cls(fork)
    header = header_cls.default()
    for name, ftype in header_cls.FIELDS.items():
        if name == "transactions_root":
            setattr(header, name, payload_cls.FIELDS[
                "transactions"].hash_tree_root(payload.transactions))
        elif name == "withdrawals_root":
            setattr(header, name, payload_cls.FIELDS[
                "withdrawals"].hash_tree_root(payload.withdrawals))
        else:
            setattr(header, name, getattr(payload, name))
    return header


def blind_block(block, T):
    """BeaconBlock → BlindedBeaconBlock with the same tree-hash root."""
    fork = T.fork_of_block(block)
    blinded = T.blinded_block_cls(fork).default()
    for name in ("slot", "proposer_index", "parent_root", "state_root"):
        setattr(blinded, name, getattr(block, name))
    src, dst = block.body, T.blinded_body_cls(fork).default()
    for name in type(dst).FIELDS:
        if name == "execution_payload_header":
            dst.execution_payload_header = payload_to_header(
                src.execution_payload, T, fork)
        else:
            setattr(dst, name, getattr(src, name))
    blinded.body = dst
    return blinded


def unblind_block(blinded, payload, T):
    """BlindedBeaconBlock + the builder-revealed payload → full block.

    Refuses a payload that does not match the committed header
    (`validator/src/block_service.rs` unblinding check — accepting a
    substituted payload would let a builder make the proposer equivocate
    about execution content).
    """
    fork = T.fork_of_block(blinded)
    want = blinded.body.execution_payload_header.tree_hash_root()
    got = payload_to_header(payload, T, fork).tree_hash_root()
    if want != got:
        raise ValueError(
            f"builder payload root {got.hex()} does not match the blinded "
            f"block's committed header {want.hex()}")
    block = T.block_cls(fork).default()
    for name in ("slot", "proposer_index", "parent_root", "state_root"):
        setattr(block, name, getattr(blinded, name))
    src, dst = blinded.body, T.body_cls(fork).default()
    for name in type(dst).FIELDS:
        if name == "execution_payload":
            dst.execution_payload = payload
        else:
            setattr(dst, name, getattr(src, name))
    block.body = dst
    return block
