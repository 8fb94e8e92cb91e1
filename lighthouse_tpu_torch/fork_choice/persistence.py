"""Fork-choice persistence — `PersistedForkChoice`
(``beacon_node/beacon_chain/src/persisted_fork_choice.rs``
+ ``consensus/proto_array/src/ssz_container.rs``).

A restart must resume with the identical head: the proto-array node graph,
the per-validator latest-message votes, equivocations, checkpoints,
proposer boost and queued attestations all round-trip through one binary
blob (fixed-width struct records, little-endian — the role of the
reference's SSZ container).  The justified state itself is NOT embedded;
it reloads from the store by block root at boot.
"""

from __future__ import annotations

import struct

import numpy as np

from .fork_choice import ForkChoice, QueuedAttestation
from .device_proto_array import DeviceProtoArrayForkChoice
from .proto_array import ProtoArrayForkChoice, ProtoNode, VoteTracker

_MAGIC = b"LTFC\x01"
_ZERO32 = b"\x00" * 32


def _opt(i) -> int:
    return -1 if i is None else int(i)


def _unopt(i: int):
    return None if i < 0 else i


_NODE = struct.Struct("<q32s q32s q32s q32s bq qq 32s")


def _pack_node(n: ProtoNode) -> bytes:
    return _NODE.pack(
        n.slot, n.root, _opt(n.parent), n.state_root,
        n.justified_epoch, n.justified_root,
        n.finalized_epoch, n.finalized_root,
        n.execution_status, n.weight,
        _opt(n.best_child), _opt(n.best_descendant),
        n.execution_block_hash or _ZERO32)


def _unpack_node(data: bytes) -> ProtoNode:
    (slot, root, parent, state_root, je, jr, fe, fr, ex, weight, bc, bd,
     ebh) = _NODE.unpack(data)
    return ProtoNode(
        slot=slot, root=root, parent=_unopt(parent), state_root=state_root,
        justified_epoch=je, justified_root=jr, finalized_epoch=fe,
        finalized_root=fr, execution_status=ex,
        execution_block_hash=None if ebh == _ZERO32 else ebh,
        weight=weight, best_child=_unopt(bc), best_descendant=_unopt(bd))


def _pack_arr(a: np.ndarray) -> bytes:
    raw = np.ascontiguousarray(a).tobytes()
    return struct.pack("<I", len(raw)) + raw


def _unpack_arr(buf: memoryview, off: int, dtype) -> tuple[np.ndarray, int]:
    (n,) = struct.unpack_from("<I", buf, off)
    off += 4
    arr = np.frombuffer(buf[off:off + n], dtype=dtype).copy()
    return arr, off + n


def encode_fork_choice(fc: ForkChoice) -> bytes:
    p = fc.proto
    if hasattr(p, "to_host"):
        # Columnar proto-array: snapshot through the bit-exact host view
        # (pending buffered votes merge first) so the blob format is
        # identical across both flavours — a restart can flip the knob.
        p = p.to_host()
    out = [_MAGIC]
    out.append(struct.pack("<I", len(p.nodes)))
    out.extend(_pack_node(n) for n in p.nodes)
    out.append(_pack_arr(p.votes.current))
    out.append(_pack_arr(p.votes.next))
    out.append(_pack_arr(p.votes.next_epoch))
    out.append(_pack_arr(p.old_balances))
    eq = np.fromiter(sorted(p.equivocating), dtype=np.int64,
                     count=len(p.equivocating))
    out.append(_pack_arr(eq))
    out.append(struct.pack("<q32s q32s 32sq",
                           p.justified_checkpoint[0], p.justified_checkpoint[1],
                           p.finalized_checkpoint[0], p.finalized_checkpoint[1],
                           p.prev_boost_root, p.prev_boost_score))
    out.append(struct.pack(
        "<q32s q32s 32sq q",
        fc.justified_checkpoint[0], fc.justified_checkpoint[1],
        fc.finalized_checkpoint[0], fc.finalized_checkpoint[1],
        fc.proposer_boost_root, fc.current_slot, len(fc.queued)))
    for q in fc.queued:
        out.append(struct.pack("<qq32s", q.slot, q.target_epoch,
                               q.block_root))
        out.append(_pack_arr(np.asarray(q.indices, np.int64)))
    return b"".join(out)


def decode_fork_choice(data: bytes, *, preset, spec,
                       justified_state) -> ForkChoice:
    """Rebuild a ForkChoice.  ``justified_state`` must be the post-state of
    the persisted justified checkpoint's block (the caller resolves it from
    the store — `beacon_chain/builder.rs` does the same at boot)."""
    buf = memoryview(data)
    if bytes(buf[:5]) != _MAGIC:
        raise ValueError("bad fork-choice blob")
    off = 5
    (n_nodes,) = struct.unpack_from("<I", buf, off)
    off += 4
    proto = ProtoArrayForkChoice()
    for _ in range(n_nodes):
        node = _unpack_node(bytes(buf[off:off + _NODE.size]))
        off += _NODE.size
        proto.indices[node.root] = len(proto.nodes)
        proto.nodes.append(node)
    cur, off = _unpack_arr(buf, off, np.int32)
    nxt, off = _unpack_arr(buf, off, np.int32)
    nxte, off = _unpack_arr(buf, off, np.uint64)
    proto.votes = VoteTracker(cur, nxt, nxte)
    proto.old_balances, off = _unpack_arr(buf, off, np.uint64)
    eq, off = _unpack_arr(buf, off, np.int64)
    proto.equivocating = set(int(i) for i in eq)
    s = struct.Struct("<q32s q32s 32sq")
    je, jr, fe, fr, boost, boost_score = s.unpack_from(buf, off)
    off += s.size
    proto.justified_checkpoint = (je, jr)
    proto.finalized_checkpoint = (fe, fr)
    proto.prev_boost_root = boost
    proto.prev_boost_score = boost_score
    s2 = struct.Struct("<q32s q32s 32sq q")
    fje, fjr, ffe, ffr, pboost, cur_slot, n_q = s2.unpack_from(buf, off)
    off += s2.size
    fc = ForkChoice.__new__(ForkChoice)
    fc.preset = preset
    fc.spec = spec
    # Restore INTO the columnar form (the engine resumes with
    # weights/best-children/votes exactly where the snapshot left them —
    # no replay needed).
    fc.proto = DeviceProtoArrayForkChoice.from_host(proto)
    fc.justified_state = justified_state
    fc.justified_checkpoint = (fje, fjr)
    fc.finalized_checkpoint = (ffe, ffr)
    fc.proposer_boost_root = pboost
    fc.current_slot = cur_slot
    fc.queued = []
    for _ in range(n_q):
        s3 = struct.Struct("<qq32s")
        slot, target, root = s3.unpack_from(buf, off)
        off += s3.size
        idx, off = _unpack_arr(buf, off, np.int64)
        fc.queued.append(QueuedAttestation(
            slot=slot, indices=idx, block_root=root, target_epoch=target))
    return fc
