"""KZG blob verification on the card: the barycentric evaluation as a
hand-written CUDA kernel, and the pairing equation as lanes of the BLS
Miller+fold and finalize kernels.

Port of ``lighthouse_tpu/kzg/device.py``.

1. :func:`eval_blobs` — p_i(z_i) for B blobs at once,

       p(z) = (z^W - 1)/W · Σ_j f_j·ω_j/(z - ω_j),   p(ω_j) = f_j,

   by :func:`eval_kernel_call`: ``lh_kzg_eval_kernel`` of
   ``csrc/kzg_fr.cu`` (replaces ``_eval_kernel``, a ``jax.jit`` program
   with no ``pallas_call``).  A blob's big-endian 32-byte elements become
   8 little-endian u32 words on the host (one numpy reorder; the
   canonical check of ``validate_blob`` runs there first and raises
   :class:`.kzg.KzgError` for exactly the JAX package's cases).  The
   roots go up once per width and device in the card's Montgomery form
   (x·2^256 mod r) and stay resident; each z is converted to that form
   once on the host (:func:`mont_words`).  The kernel takes canonical
   elements and gives canonical values; its plain version
   :func:`eval_plain` runs the JAX program's steps on the JAX limbs
   (:mod:`.fr_limb`) between conversions.
2. :func:`verify_blob_kzg_proof_batch_device` — the JAX package's flow:
   decode and subgroup-check the points, the Fiat-Shamir challenges,
   :func:`eval_blobs`, the RLC powers and each claim's two G1 sides
   (:func:`.kzg._proof_pairs`, the host fold's own group math) on the
   host; then every blob's two lanes with FIXED G2 sides,

       e(r_i·(C_i - y_i·G1 + z_i·Q_i), -G2) · e(r_i·Q_i, [τ]G2)   (∏ i)

   go through :func:`..crypto.pairing_kernel.miller_fold_kernel_call` and
   :func:`..crypto.pairing_kernel.finalize_kernel_call` in 256-lane
   cells.  **Lane placement**: blob i sits in cell i // 128 at lane
   i mod 128 (its −G2 lane) and lane 128 + i mod 128 (its [τ]G2 lane), so
   Miller+fold's product of lane j with lane j + 128 is that blob's two
   pairings; cells are padded to a power of two for the finalize.  An
   identity G1 side (the zero blob's commitment and proof are the point at
   infinity) is a lane with mask 0, which the kernel sets to 1.  The G2
   plane (−G2 in the first half of each cell, [τ]G2 in the second) is
   built once per setup and device and stays resident.  The finalize's
   cubed final exponentiation is 1 exactly when the plain one is (3 is
   prime to r), so the verdicts are the host fold's.

A wrapper runs its plain version only for a tensor on the CPU; for a CUDA
tensor it launches its kernel or raises.  :data:`LAUNCHES` counts
``lh_kzg_eval`` calls (one per call, the kernel and its finishing launch
together).  The stage split of the last batch lands in
:data:`LAST_KZG_TIMINGS` (the tracer's ``kzg`` stage source) and bytes in
the device ledger under ``kzg``.
"""

from __future__ import annotations

import ctypes
import time
from typing import Dict

import numpy as np
import torch

from .. import device as DEV
from ..common.device_ledger import LEDGER
from ..common.metrics import observe
from . import fr_limb as FL
from .fr import BLS_MODULUS, BYTES_PER_FIELD_ELEMENT
from .trusted_setup import TrustedSetup

# Stage decomposition of the last batch verify (the tracer's ``kzg``
# source; bench and chip_smoke read it).
LAST_KZG_TIMINGS: Dict[str, float] = {}

LAUNCHES = {"kzg_eval": 0}

WORDS = 8                 # u32 words of one Fr element on the card
THREADS = 64              # elements a block of lh_kzg_eval_kernel
PARTIAL_WORDS = 17        # a block's partial: sum, hit f, hit flag
CELL = 256                # Miller+fold lanes a cell
HALF = CELL // 2

_N_WORDS_BE = np.array([(BLS_MODULUS >> (32 * (WORDS - 1 - i))) & 0xFFFFFFFF
                        for i in range(WORDS)], np.uint32)


def reset_stage_timings() -> None:
    """Clear the stage dict — the mutation surface OTHER modules use
    (e.g. the availability gate before a host-path verify, so stale
    device stages can't attach to a host span)."""
    LAST_KZG_TIMINGS.clear()


# ---------------------------------------------------------------------------
# Host words
# ---------------------------------------------------------------------------

def _geq_modulus(be: np.ndarray) -> np.ndarray:
    """(..., 8) most-significant-first u32 words → value >= N."""
    gt = be > _N_WORDS_BE
    diff = gt | (be < _N_WORDS_BE)
    first = diff.argmax(axis=-1)[..., None]
    return ~diff.any(axis=-1) | np.take_along_axis(gt, first, -1)[..., 0]


def blob_words(blobs, width: int) -> np.ndarray:
    """Blobs → (B, W, 8) little-endian u32 words of their elements, after
    ``validate_blob``'s checks blob by blob in order (a wrong length or an
    element >= r raises :class:`.kzg.KzgError` with its message)."""
    from .kzg import KzgError
    out = np.empty((len(blobs), width, WORDS), np.uint32)
    for b, blob in enumerate(blobs):
        blob = bytes(blob)
        if len(blob) != width * BYTES_PER_FIELD_ELEMENT:
            raise KzgError(f"blob must be {width * 32} bytes, got "
                           f"{len(blob)}")
        be = np.frombuffer(blob, dtype=">u4").reshape(width, WORDS)
        bad = np.flatnonzero(_geq_modulus(be))
        if bad.size:
            raise KzgError(f"blob element {int(bad[0])} is non-canonical")
        out[b] = be[:, ::-1]
    return out


def ints_words(xs) -> np.ndarray:
    """Python ints in [0, 2^256) → (n, 8) little-endian u32 words."""
    raw = b"".join(int(x).to_bytes(32, "little") for x in xs)
    return np.frombuffer(raw, dtype="<u4").reshape(-1, WORDS).astype(
        np.uint32)


_R_CARD = (1 << 256) % BLS_MODULUS     # the card's Montgomery radix mod r


def mont_words(xs) -> np.ndarray:
    """Python ints in [0, r) → (n, 8) words of their Montgomery form on
    the card, x·2^256 mod r."""
    return ints_words([int(x) * _R_CARD % BLS_MODULUS for x in xs])


def words_ints(words: np.ndarray) -> list:
    """(n, 8) little-endian u32 words → Python ints."""
    words = np.ascontiguousarray(np.asarray(words).astype("<u4"))
    return [int.from_bytes(row.tobytes(), "little") for row in words]


# ---------------------------------------------------------------------------
# The barycentric evaluation: plain version and kernel
# ---------------------------------------------------------------------------

def eval_mont_plain(f: torch.Tensor, z: torch.Tensor, roots: torch.Tensor,
                    width: int) -> torch.Tensor:
    """The JAX package's ``_eval_kernel`` as torch ops, limb for limb:
    f (B, W, 17) Montgomery evals, z (B, 17), roots (W, 17) → (B, 17)
    Montgomery p_i(z_i)."""
    d = FL.sub(z[:, None, :], roots[None, :, :])           # (B, W, 17)
    hit = FL.is_zero(d)                                    # (B, W)
    dinv = FL.inv(d)                                       # inv(0) = 0
    terms = FL.mont_mul(FL.mont_mul(f, roots[None]), dinv)
    acc = terms
    n = width
    while n > 1:
        n //= 2
        acc = FL.add(acc[:, :n, :], acc[:, n:2 * n, :])
    acc = acc[:, 0, :]
    zw = z
    for _ in range(width.bit_length() - 1):
        zw = FL.mont_mul(zw, zw)
    w_inv = FL._const(FL.to_mont(pow(width, BLS_MODULUS - 2, BLS_MODULUS)),
                      z)
    factor = FL.mont_mul(FL.sub(zw, FL._const(FL.ONE_MONT, z)), w_inv)
    out = FL.mont_mul(acc, factor)
    fhit = FL.select(hit, f, torch.zeros_like(f))
    n = width
    while n > 1:
        n //= 2
        fhit = FL.add(fhit[:, :n, :], fhit[:, n:2 * n, :])
    return FL.select(torch.any(hit, dim=1), fhit[:, 0, :], out)


def _i32(words: torch.Tensor) -> torch.Tensor:
    """int64 u32 words → their int32 bit patterns."""
    return torch.where(words >= 1 << 31, words - (1 << 32),
                       words).to(torch.int32)


@torch.inference_mode()
def eval_plain(f: torch.Tensor, zm: torch.Tensor,
               roots: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of :func:`eval_kernel_call`: the canonical f
    (the JAX package's ``to_mont``) and the card-Montgomery z and roots
    (a product by 2^16 takes x·2^256 to x·2^272) go to the JAX package's
    Montgomery limbs, run :func:`eval_mont_plain`, and come back
    canonical (its ``from_mont``)."""
    def from_card(x):
        limbs = FL.words_to_limbs(x)
        return FL.canonical(FL.mont_mul(limbs, FL._const(
            FL.to_mont(1 << 16), limbs)))

    out = eval_mont_plain(FL.to_mont_t(FL.words_to_limbs(f)), from_card(zm),
                          from_card(roots), roots.shape[0])
    return _i32(FL.limbs_to_words(FL.from_mont_t(out)))


def eval_kernel_call(f: torch.Tensor, z: torch.Tensor,
                     roots: torch.Tensor) -> torch.Tensor:
    """f (B, W, 8) canonical, z (B, 8) and roots (W, 8) in the card's
    Montgomery form (:func:`mont_words`): int32 little-endian words, W a
    power of two → (B, 8) int32 canonical p_i(z_i)."""
    for t, name in ((f, "f"), (z, "z"), (roots, "roots")):
        if t.dtype != torch.int32 or t.shape[-1] != WORDS:
            raise ValueError(f"{name} must be int32 (..., {WORDS}) words, "
                             f"got {t.dtype} {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError("kernel inputs must be contiguous")
    if f.dim() != 3 or z.dim() != 2 or roots.dim() != 2:
        raise ValueError("f must be (B, W, 8), z (B, 8), roots (W, 8)")
    blobs, width = f.shape[0], f.shape[1]
    if z.shape[0] != blobs or roots.shape[0] != width:
        raise ValueError(f"f {tuple(f.shape)}, z {tuple(z.shape)} and "
                         f"roots {tuple(roots.shape)} disagree")
    if width < 1 or width & (width - 1):
        raise ValueError(f"width must be a power of two, got {width}")
    if not f.device == z.device == roots.device:
        raise ValueError("f, z and roots must share a device")
    if f.device.type == "cpu":
        return eval_plain(f, z, roots)
    if f.device.type != "cuda":
        raise ValueError(f"unsupported device {f.device}")
    blocks = -(-width // THREADS)
    partial = torch.empty((blobs, blocks, PARTIAL_WORDS), dtype=torch.int32,
                          device=f.device)
    out = torch.empty((blobs, WORDS), dtype=torch.int32, device=f.device)
    _check_rc(kernel_library().lh_kzg_eval(
        f.data_ptr(), z.data_ptr(), roots.data_ptr(), partial.data_ptr(),
        out.data_ptr(), blobs, width, width.bit_length() - 1, blocks,
        _stream(f)), "kzg_eval")
    LAUNCHES["kzg_eval"] += 1
    return out


_ROOTS: dict = {}


def roots_on_device(setup: TrustedSetup) -> torch.Tensor:
    """The setup's roots as (W, 8) card-Montgomery words
    (:func:`mont_words`) on the port's device, uploaded once per width and
    device."""
    dev = DEV.get_device()
    key = (setup.width, str(dev))
    got = _ROOTS.get(key)
    if got is None:
        got = _ROOTS[key] = DEV.to_device(mont_words(setup.roots), "kzg")
    return got


def eval_words(f: np.ndarray, zs, setup: TrustedSetup) -> list:
    """p_i(z_i) of validated blob words ``f`` (:func:`blob_words`) at the
    ints ``zs``, on the port's device; ints out."""
    if len(f) == 0:
        return []
    f_t = DEV.to_device(f, "kzg")
    z_t = DEV.to_device(mont_words(zs), "kzg")
    out = eval_kernel_call(f_t, z_t, roots_on_device(setup))
    return words_ints(DEV.to_host(out, "kzg"))


def eval_blobs(blobs, zs, setup: TrustedSetup) -> list:
    """Batched p_i(z_i) for B blobs (bytes) at B points (ints), on the
    port's device.  Raises :class:`.kzg.KzgError` for a blob
    ``validate_blob`` refuses."""
    return eval_words(blob_words(blobs, setup.width), zs, setup)


# ---------------------------------------------------------------------------
# Batch verification
# ---------------------------------------------------------------------------

_G2_PLANES: dict = {}


def _g2_plane(setup: TrustedSetup, cells: int) -> torch.Tensor:
    """(128, cells·256) affine G2 columns on the port's device: −G2 in
    the first half of each cell, [τ]G2 in the second; built once per
    setup point, width and device."""
    from ..crypto import curve as C
    from ..crypto.tpu_backend import _g2_aff_col
    dev = DEV.get_device()
    key = (setup.g2_monomial[1], cells, str(dev))
    got = _G2_PLANES.get(key)
    if got is None:
        neg = np.frombuffer(_g2_aff_col(C.g2_neg(C.G2_GEN)), np.uint32)
        tau = np.frombuffer(_g2_aff_col(setup.g2_monomial[1]), np.uint32)
        plane = np.empty((128, cells, 2, HALF), np.uint32)
        plane[:, :, 0] = neg[:, None, None]
        plane[:, :, 1] = tau[:, None, None]
        got = _G2_PLANES[key] = DEV.to_device(
            plane.reshape(128, cells * CELL), "kzg")
    return got


def lane_planes(g1a, g1b) -> tuple:
    """Each claim's two G1 sides → the (64, cells·256) affine G1 plane and
    the (1, cells·256) mask, blob i at lanes i mod 128 and 128 + i mod 128
    of cell i // 128; an identity side (None) is a masked lane."""
    from ..crypto.tpu_backend import _g1_aff_col, _next_pow2
    cells = _next_pow2(-(-len(g1a) // HALF))
    g1 = np.zeros((64, cells * CELL), np.uint32)
    mask = np.zeros((1, cells * CELL), np.int32)
    for i, sides in enumerate(zip(g1a, g1b)):
        cell, k = divmod(i, HALF)
        for half, p in enumerate(sides):
            if p is None:
                continue
            j = cell * CELL + half * HALF + k
            g1[:, j] = np.frombuffer(_g1_aff_col(p), np.uint32)
            mask[0, j] = 1
    return g1, mask


def verify_blob_kzg_proof_batch_device(blobs, commitments, proofs,
                                       setup: TrustedSetup) -> bool:
    """B blobs → one evaluation launch, one Miller+fold over 2B lanes and
    one finalize, on the port's device.  The same accept/reject set as
    :func:`.kzg.verify_blob_kzg_proof_batch_host` (tests and
    ``chip_smoke.py`` hold them equal)."""
    from ..crypto import pairing_kernel as PK
    from . import kzg as K
    if not (len(blobs) == len(commitments) == len(proofs)):
        raise K.KzgError("batch length mismatch")
    if not blobs:
        return True
    t0 = time.perf_counter()
    cpts = [K.bytes_to_kzg_commitment(c) for c in commitments]
    qpts = [K.bytes_to_kzg_proof(q) for q in proofs]
    f = blob_words(blobs, setup.width)
    zs = [K.compute_challenge(bytes(b), c, setup.width)
          for b, c in zip(blobs, commitments)]
    t_chal = time.perf_counter()
    ys = eval_words(f, zs, setup)
    t_eval = time.perf_counter()
    rs = K._rlc_powers(commitments, zs, ys, proofs, setup.width)
    g1a, g1b = [], []
    for cpt, z, y, qpt, r in zip(cpts, zs, ys, qpts, rs):
        (a, _neg_g2), (b, _x2) = K._proof_pairs(cpt, z, y, qpt, setup, r=r)
        g1a.append(a)
        g1b.append(b)
    g1, mask = lane_planes(g1a, g1b)
    cells = g1.shape[1] // CELL
    t_prep = time.perf_counter()
    prod = PK.miller_fold_kernel_call(
        DEV.to_device(g1, "kzg"), _g2_plane(setup, cells),
        DEV.to_device(mask, "kzg"))
    ok = bool(DEV.to_host(PK.finalize_kernel_call(prod), "kzg")[0, 0])
    t_pair = time.perf_counter()
    LEDGER.note_dispatch("kzg", (t_pair - t_prep) * 1e3)
    reset_stage_timings()
    LAST_KZG_TIMINGS.update({
        "blobs": len(blobs),
        "lanes": cells * CELL,
        "challenge_ms": round((t_chal - t0) * 1e3, 2),
        "eval_ms": round((t_eval - t_chal) * 1e3, 2),
        "lane_prep_ms": round((t_prep - t_eval) * 1e3, 2),
        "pairing_ms": round((t_pair - t_prep) * 1e3, 2),
    })
    observe("kzg_eval_seconds", t_eval - t_chal)
    observe("kzg_lane_prep_seconds", t_prep - t_eval)
    observe("kzg_pairing_seconds", t_pair - t_prep)
    return ok


# ---------------------------------------------------------------------------
# The CUDA library
# ---------------------------------------------------------------------------

_LIB = "kzg_fr"
_P, _LL, _I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
_SIGNATURES = {
    # f, z, roots, partial, out, blobs, width, log2 width, partial
    # blocks, stream
    "lh_kzg_eval": [_P, _P, _P, _P, _P, _LL, _LL, _I, _I, _P],
    # threads a block of lh_kzg_eval_kernel
    "lh_kzg_threads": [],
    # xy, out, chain length, stream
    "lh_fr_mul_chain": [_P, _P, _I, _P],
}
_LIB_READY = []


def kernel_library() -> ctypes.CDLL:
    """The built and loaded KZG kernel library (compiles at first call)."""
    from ..ops.cuda_build import load
    lib = load(_LIB, _SIGNATURES)
    if not _LIB_READY:
        if lib.lh_kzg_threads() != THREADS:
            raise RuntimeError(f"kzg_fr.cu runs {lib.lh_kzg_threads()} "
                               f"threads a block, the wrapper {THREADS}")
        _LIB_READY.append(True)
    return lib


def _check_rc(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what} failed: CUDA error {rc}")


def _stream(x: torch.Tensor) -> int:
    return torch.cuda.current_stream(x.device).cuda_stream


def _require_cuda_words(x: torch.Tensor, rows: int) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    if x.dtype != torch.int32 or x.shape != (rows, WORDS) \
            or not x.is_contiguous():
        raise ValueError(f"expected contiguous int32 ({rows}, {WORDS}) "
                         f"words, got {x.dtype} {tuple(x.shape)}")


def fr_mul_chain_kernel(xy: torch.Tensor, n: int) -> torch.Tensor:
    """x ← x·y/2^256 mod r, n dependent products on ONE thread of the
    card: xy (2, 8) words (x, then y) → x, (1, 8).  The latency probe that
    prices the evaluation's chain bound in ``chip_smoke.py``."""
    _require_cuda_words(xy, 2)
    out = torch.empty((1, WORDS), dtype=torch.int32, device=xy.device)
    _check_rc(kernel_library().lh_fr_mul_chain(xy.data_ptr(), out.data_ptr(),
                                               n, _stream(xy)),
              "fr_mul_chain")
    return out


def fr_mul_chain_plain(x: int, y: int, n: int) -> int:
    """Plain version of :func:`fr_mul_chain_kernel` (host ints)."""
    rinv = pow(1 << 256, -1, BLS_MODULUS)
    for _ in range(n):
        x = x * y * rinv % BLS_MODULUS
    return x
