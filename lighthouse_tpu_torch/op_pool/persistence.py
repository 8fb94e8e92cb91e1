"""Operation-pool persistence — `PersistedOperationPool`
(``beacon_node/operation_pool/src/persistence.rs``).

A restart must not lose pending operations: stored aggregates (data +
merged bits + signature + committee), slashings, exits and BLS changes
round-trip through one blob.  SSZ for the consensus containers, fixed
headers for the framing.
"""

from __future__ import annotations

import struct

import numpy as np

from . import OperationPool, _StoredAttestation

_MAGIC = b"LTOP\x01"


def _blob(b: bytes) -> bytes:
    return struct.pack("<I", len(b)) + b


def _unblob(buf: memoryview, off: int) -> tuple[bytes, int]:
    (n,) = struct.unpack_from("<I", buf, off)
    off += 4
    return bytes(buf[off:off + n]), off + n


def encode_op_pool(pool: OperationPool, T) -> bytes:
    out = [_MAGIC]
    stored = [(k, s) for k, v in pool.attestations.items() for s in v]
    out.append(struct.pack("<I", len(stored)))
    for key, s in stored:
        out.append(_blob(key))
        out.append(_blob(T.AttestationData.serialize(s.data)))
        out.append(_blob(np.packbits(
            np.asarray(s.bits, bool), bitorder="little").tobytes()
            + struct.pack("<I", len(s.bits))))
        out.append(_blob(s.signature))
        out.append(_blob(np.asarray(s.committee, np.int64).tobytes()))
    for items, enc in (
            (list(pool.proposer_slashings.values()),
             T.ProposerSlashing.serialize),
            (pool.attester_slashings, T.AttesterSlashing.serialize),
            (list(pool.voluntary_exits.values()),
             T.SignedVoluntaryExit.serialize),
            (list(pool.bls_changes.values()),
             T.SignedBLSToExecutionChange.serialize)):
        out.append(struct.pack("<I", len(items)))
        out.extend(_blob(enc(it)) for it in items)
    return b"".join(out)


def decode_op_pool(data: bytes, preset, spec, T) -> OperationPool:
    buf = memoryview(data)
    if bytes(buf[:5]) != _MAGIC:
        raise ValueError("bad op-pool blob")
    off = 5
    pool = OperationPool(preset, spec)
    (n_att,) = struct.unpack_from("<I", buf, off)
    off += 4
    for _ in range(n_att):
        key, off = _unblob(buf, off)
        data_b, off = _unblob(buf, off)
        bits_b, off = _unblob(buf, off)
        sig, off = _unblob(buf, off)
        comm_b, off = _unblob(buf, off)
        (n_bits,) = struct.unpack("<I", bits_b[-4:])
        bits = np.unpackbits(
            np.frombuffer(bits_b[:-4], np.uint8),
            bitorder="little")[:n_bits].astype(bool)
        pool.attestations.setdefault(key, []).append(_StoredAttestation(
            data=T.AttestationData.deserialize(data_b),
            bits=bits, signature=sig,
            committee=np.frombuffer(comm_b, np.int64).copy()))
    for attr, dec, keyed in (
            ("proposer_slashings", T.ProposerSlashing.deserialize,
             lambda s: int(s.signed_header_1.message.proposer_index)),
            ("attester_slashings", T.AttesterSlashing.deserialize, None),
            ("voluntary_exits", T.SignedVoluntaryExit.deserialize,
             lambda e: int(e.message.validator_index)),
            ("bls_changes", T.SignedBLSToExecutionChange.deserialize,
             lambda c: int(c.message.validator_index))):
        (n,) = struct.unpack_from("<I", buf, off)
        off += 4
        for _ in range(n):
            raw, off = _unblob(buf, off)
            item = dec(raw)
            if keyed is None:
                getattr(pool, attr).append(item)
            else:
                getattr(pool, attr)[keyed(item)] = item
    return pool
