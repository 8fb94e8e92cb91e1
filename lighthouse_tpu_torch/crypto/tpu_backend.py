"""The ``tpu`` BLS backend of the port — batched signature verification on
the GPU (the registry name is the JAX package's).

Port of the shared-key path of ``lighthouse_tpu/crypto/tpu_backend.py``.
``verify_signature_sets`` collapses sets that share one signing-key list
to one aggregated key (``_dedup_shared_keygroups``), and when the whole
batch then signs under one key P (the sync-committee shape: 256 messages
× the same 512 keys, ``fast_aggregate_verify``), bilinearity collapses
the batch to TWO Miller lanes:

    ∏_i e(c_i·P, H(m_i)) · e(−G, Σ c_i·σ_i)
  = e(P, Σ c_i·H(m_i)) · e(−G, Σ c_i·σ_i)          == 1

Device stages (kernels of ``csrc/bls381.cu``): hash-to-G2 of every
message → two RLC sigma folds (H side, σ side) + ``sigma_combine`` (plain
PyTorch glue) → one fused Miller+fold cell with 2 live lanes → finalize.

Any other batch — sets under different keys, fewer than
``LIGHTHOUSE_TPU_SHARED_MIN`` sets — needs the general path (prepare +
product_chunks), which slice 3 of the port brings; it raises
``NotImplementedError`` here, never runs on the host or the CPU quietly.
The port has no native host library, so no small batch is sent to a host
pairing (the JAX package's ``LIGHTHOUSE_TPU_HOST_FASTPATH_MAX``) and key
aggregation is the pure-Python loop.
"""

from __future__ import annotations

import time
from functools import lru_cache

import numpy as np
import torch

from . import curve as C
from . import limb_field as LF
from .. import device as D

LAST_FAST_AGG_TIMINGS: dict = {}
# Fence each stage of the shared path and record its wall time in
# LAST_FAST_AGG_TIMINGS (costs a device sync per stage; off by default).
STAGE_TIMINGS = False

TRANSFERS = D.transfer_counter("crypto.tpu_backend")

_GENERAL_PATH = ("the general batch-verify path (prepare + product_chunks "
                 "kernels) is ported in slice 3")


def _next_pow2(n: int) -> int:
    return 1 if n <= 1 else 1 << (n - 1).bit_length()


@lru_cache(maxsize=1 << 16)
def _g1_aff_col(point) -> bytes:
    """Affine G1 → (64,) block-layout column (x at rows 0, y at 32)."""
    col = np.zeros(64, np.uint32)
    col[0:26] = LF.to_mont(point[0])
    col[32:58] = LF.to_mont(point[1])
    return col.tobytes()


@lru_cache(maxsize=1 << 16)
def _g2_aff_col(point) -> bytes:
    """Affine G2 → (128,) block-layout column (x0/x1/y0/y1 at 0/32/64/96)."""
    (x0, x1), (y0, y1) = point
    col = np.zeros(128, np.uint32)
    col[0:26] = LF.to_mont(x0)
    col[32:58] = LF.to_mont(x1)
    col[64:90] = LF.to_mont(y0)
    col[96:122] = LF.to_mont(y1)
    return col.tobytes()


def _rlc_message_sig_columns(entries, C, rand_fn):
    """The per-set column marshalling: RLC lo/hi scalar words,
    interleaved hash-to-curve u-planes, affine signature columns,
    set-liveness.  Returns (set_col, lo, hi, u_planes, sig_cols, sigmask,
    setlive) as host numpy arrays, byte for byte the JAX package's."""
    from . import htc_kernel as HK
    from . import pairing_kernel as PK

    S = PK.PREP_S
    n = len(entries)
    sets = np.arange(n)
    set_col = (sets // S) * S + (sets % S)

    rands = np.fromiter((rand_fn() for _ in range(n)), np.uint64, n)
    lo = np.zeros((1, C * S), np.uint32)
    hi = np.zeros((1, C * S), np.uint32)
    lo[0, set_col] = (rands & 0xFFFFFFFF).astype(np.uint32)
    hi[0, set_col] = (rands >> 32).astype(np.uint32)

    u_cols = np.frombuffer(
        b"".join(HK._u_cols(bytes(e[2])) for e in entries),
        np.uint32).reshape(n, 2, 2 * HK.BLOCK_ROWS)
    u_planes = np.zeros((2 * HK.BLOCK_ROWS, C * 2 * S), np.uint32)
    ubase = (sets // S) * 2 * S + (sets % S)
    u_planes[:, ubase] = u_cols[:, 0].T
    u_planes[:, ubase + S] = u_cols[:, 1].T

    sig_cols = np.zeros((128, C * S), np.uint32)
    sigmask = np.zeros((1, C * S), np.int32)
    have_sig = np.fromiter((e[0] is not None for e in entries), bool, n)
    if have_sig.any():
        sig_bytes = b"".join(_g2_aff_col(e[0])
                             for e in entries if e[0] is not None)
        cols = np.frombuffer(sig_bytes, np.uint32).reshape(-1, 128).T
        sig_cols[:, set_col[have_sig]] = cols
        sigmask[0, set_col[have_sig]] = 1
    setlive = np.zeros((1, C * S), np.int32)
    setlive[0, set_col] = 1
    return set_col, lo, hi, u_planes, sig_cols, sigmask, setlive


def _dedup_shared_keygroups(entries):
    """Collapse entries sharing an IDENTICAL pubkey list (more than 4
    keys, at least two entries) to one aggregated key.  Returns
    (entries', all_valid): an infinity aggregate means an invalid set."""
    from . import bls
    counts: dict = {}
    for e in entries:
        if len(e[1]) > 4:
            counts[tuple(e[1])] = counts.get(tuple(e[1]), 0) + 1
    shared = {k for k, n in counts.items() if n >= 2}
    if not shared:
        return entries, True
    t0 = time.perf_counter()
    agg: dict = {}
    for k in shared:
        agg[k] = bls.aggregate_points(list(k))
        if agg[k] is None:
            return entries, False
    LAST_FAST_AGG_TIMINGS["aggregate_keys_ms"] = (
        (time.perf_counter() - t0) * 1e3)
    out = []
    for e in entries:
        key = tuple(e[1])
        out.append((e[0], [agg[key]], e[2]) if key in shared else e)
    return out, True


def _shared_min_sets() -> int:
    from ..common.knobs import knob_int
    return knob_int("LIGHTHOUSE_TPU_SHARED_MIN")


def _shared_group_key(entries):
    """The common single pubkey point if the WHOLE batch shares one
    signing key (post-dedup) and every entry carries its own signature;
    None otherwise."""
    if len(entries) < _shared_min_sets():
        return None
    first = entries[0][1]
    if len(first) != 1:
        return None
    pt = first[0]
    for e in entries:
        if e[0] is None or len(e[1]) != 1 or e[1][0] != pt:
            return None
    return pt


def _stage_sync(timings, name, t0, dev):
    """When STAGE_TIMINGS is on, fence the queued work and record the
    stage's wall time; otherwise leave the stream running."""
    if not STAGE_TIMINGS:
        return t0
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t1 = time.perf_counter()
    timings[name] = (t1 - t0) * 1e3
    return t1


def shared_tail(pk_col, h_cols, sig_cols, setlive, sigmask, lo, hi,
                timings=None, t0=None):
    """The collapsed path's algebra on device tensors: two σ-style RLC
    folds (H side and σ side) → one 2-live-lane fused Miller+fold cell
    (lane 0: the shared key with Σ c_i·H_i, lane 1: −G with Σ c_i·σ_i; a
    fold that is the identity is masked) → finalize.  Returns a 0-dim
    bool tensor (no host sync)."""
    from . import pairing_kernel as PK

    (h_col, h_ident), (s_col, s_ident) = PK.sigma_combine(
        PK.sigma_kernel_call(h_cols, setlive, lo, hi),
        PK.sigma_kernel_call(sig_cols, sigmask, lo, hi))
    if timings is not None:
        t0 = _stage_sync(timings, "rlc_fold_ms", t0, pk_col.device)
    g2 = torch.zeros((128, pk_col.shape[1]), dtype=torch.int32,
                     device=pk_col.device)
    g2[:, 0] = h_col
    g2[:, 1] = s_col
    mask = torch.zeros((1, pk_col.shape[1]), dtype=torch.int32,
                       device=pk_col.device)
    mask[0, 0] = (~h_ident).to(torch.int32)
    mask[0, 1] = (~s_ident).to(torch.int32)
    prod = PK.miller_fold_kernel_call(pk_col, g2, mask)
    ok = PK.finalize_kernel_call(prod)[0, 0] != 0
    if timings is not None:
        _stage_sync(timings, "miller_final_ms", t0, pk_col.device)
    return ok


def pk_columns(pk_pt) -> np.ndarray:
    """(64, 256) Miller-cell G1 input: lane 0 the shared key, lane 1 −G."""
    from . import pairing_kernel as PK
    pk_col = np.zeros((64, 2 * PK.PREP_S), np.uint32)
    pk_col[:, 0] = np.frombuffer(_g1_aff_col(pk_pt), np.uint32)
    pk_col[:, 1] = np.frombuffer(_g1_aff_col(C.g1_neg(C.G1_GEN)), np.uint32)
    return pk_col


def verify_shared_columns(pk_col, u_planes, sig_cols, sigmask, setlive, lo,
                          hi, timings=None, t0=None) -> bool:
    """Run the shared tail on host numpy columns (the JAX package's
    marshalled arrays, or the port's own): copy them to the device,
    hash-to-G2 the u-planes, fold, pair, finalize, and return the
    verdict."""
    from . import htc_kernel as HK

    args = [D.to_device(a, TRANSFERS) for a in
            (pk_col, u_planes, sig_cols, sigmask, setlive, lo, hi)]
    pk_d, u_d, sig_d, sigmask_d, live_d, lo_d, hi_d = args
    h_cols = HK.hash_g2_kernel_call(u_d)
    if timings is not None:
        t0 = _stage_sync(timings, "htc_ms", t0, pk_d.device)
    ok = shared_tail(pk_d, h_cols, sig_d, live_d, sigmask_d, lo_d, hi_d,
                     timings, t0)
    TRANSFERS["d2h"] += 1
    return bool(ok)


def _dispatch_shared(entries, pk_pt, rand_fn) -> bool:
    """The collapsed path: marshal → hash-to-G2 → two RLC folds → one
    fused Miller+fold cell with 2 live lanes → finalize."""
    from . import pairing_kernel as PK

    S = PK.PREP_S
    n = len(entries)
    n_chunks = _next_pow2((n + S - 1) // S)
    t0 = time.perf_counter()
    (_set_col, lo, hi, u_planes, sig_cols, sigmask,
     setlive) = _rlc_message_sig_columns(entries, n_chunks, rand_fn)
    pk_col = pk_columns(pk_pt)
    timings = LAST_FAST_AGG_TIMINGS
    t0 = _stage_sync(timings, "marshal_ms", t0, D.get_device())
    verdict = verify_shared_columns(pk_col, u_planes, sig_cols, sigmask,
                                    setlive, lo, hi, timings, t0)
    timings["sets"] = n
    timings["path"] = "cuda_shared"
    return verdict


def _dispatch(entries, rand_fn) -> bool:
    """entries: list of (agg_sig_point, [pubkey points], message bytes);
    rand_fn() → 64-bit scalar.  Only the shared-key collapse is ported."""
    LAST_FAST_AGG_TIMINGS.clear()
    entries, valid = _dedup_shared_keygroups(entries)
    if not valid:
        return False
    shared_pt = _shared_group_key(entries)
    if shared_pt is None:
        raise NotImplementedError(
            f"this batch ({len(entries)} sets) does not share one signing "
            f"key list across at least {_shared_min_sets()} sets; "
            + _GENERAL_PATH)
    return _dispatch_shared(entries, shared_pt, rand_fn)


def _rand_nonzero() -> int:
    import secrets
    c = 0
    while c == 0:
        c = secrets.randbits(64)
    return c


class TpuBackend:
    """Device-batched verification registered as ``tpu`` in :mod:`.bls`."""

    name = "tpu"

    def verify_signature_sets(self, sets, rand_fn=None) -> bool:
        """RLC batch verify.  ``rand_fn`` (tests and the smoke script
        only) replaces the secret random 64-bit scalars; production calls
        leave it None.  Raises without a GPU unless the caller set the
        CPU device."""
        D.get_device()
        if not sets:
            return False
        entries = []
        for s in sets:
            if s.signature is None or s.signature.point is None:
                return False
            if not s.signing_keys:
                return False
            entries.append((s.signature.point,
                            [k.point for k in s.signing_keys],
                            bytes(s.message)))
        return _dispatch(entries, rand_fn=rand_fn or _rand_nonzero)

    def verify(self, signature, pubkeys, message) -> bool:
        raise NotImplementedError("single-set verify: " + _GENERAL_PATH)

    def aggregate_verify(self, signature, pubkeys, messages) -> bool:
        raise NotImplementedError("aggregate_verify: " + _GENERAL_PATH)


def register() -> None:
    from . import bls
    bls.register_backend("tpu", TpuBackend())


register()
