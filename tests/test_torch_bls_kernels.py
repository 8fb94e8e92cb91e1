"""The plain versions of the port's four BLS kernels against the host
oracles of the JAX package (hash_to_g2, the curve law, the pairing and
its cubed final exponentiation), on the CPU at the kernels' shapes.  The
JAX package's own kernels are Pallas programs; driven eagerly their
ladders take minutes here, so the host oracles hold both packages.
"""

import shutil

import numpy as np
import pytest
import torch

from lighthouse_tpu.crypto import curve as JC
from lighthouse_tpu.crypto import fields as F
from lighthouse_tpu.crypto import hash_to_curve as JH2C
from lighthouse_tpu.crypto import pairing as JPAIR
from lighthouse_tpu_torch import device
from lighthouse_tpu_torch.crypto import htc_kernel as HK
from lighthouse_tpu_torch.crypto import limb_field as LF
from lighthouse_tpu_torch.crypto import pairing_kernel as PK
from lighthouse_tpu_torch.crypto import tpu_backend as TB
from lighthouse_tpu_torch.ops import cuda_build

S = PK.PREP_S


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The plain versions run thousands of small ops: one torch thread per
    test worker (for the module's fixtures too) keeps parallel workers from
    oversubscribing the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def on_cpu():
    prev = device.default_device()
    device.set_default_device("cpu")
    yield
    device.set_default_device(prev)


def _canon_col(planes: torch.Tensor, k: int, lane: int) -> list:
    """Canonical ints of the k Fq blocks of one lane."""
    arr = planes.numpy()
    return [LF.from_mont(arr[32 * b:32 * b + 26, lane].astype(np.uint64))
            for b in range(k)]


def _fq12_of(planes: torch.Tensor, lane: int):
    c = _canon_col(planes, 12, lane)
    return tuple(tuple((c[(i * 3 + j) * 2], c[(i * 3 + j) * 2 + 1])
                       for j in range(3)) for i in range(2))


def _i32(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a).view(np.int32).copy())


def test_hash_g2_plain_matches_host_hash_to_g2():
    msgs = [b"", b"sync-comm-000", b"\x00" * 32]
    u = HK.u_planes_for_messages([(0, i, m) for i, m in enumerate(msgs)], 1)
    out = HK.hash_g2_kernel_call(_i32(u))        # CPU → the plain version
    assert out.shape == (128, S) and out.dtype == torch.int32
    for i, m in enumerate(msgs):
        x0, x1, y0, y1 = _canon_col(out, 4, i)
        assert ((x0, x1), (y0, y1)) == JH2C.hash_to_g2(m)


def test_sigma_plain_and_combine_match_host_rlc_sum():
    rng = np.random.default_rng(8)
    n = 5
    sigs = [JC.g2_mul(JC.G2_GEN, int(rng.integers(1, 2 ** 62)))
            for _ in range(n)]
    cs = [int(rng.integers(1, 2 ** 63)) * 2 + 1 for _ in range(n)]
    sig_cols = np.zeros((128, 2 * S), np.uint32)
    mask = np.zeros((1, 2 * S), np.int32)
    lo = np.zeros((1, 2 * S), np.uint32)
    hi = np.zeros((1, 2 * S), np.uint32)
    lanes = [0, 3, 77, S + 1, S + 100]                  # both chunks live
    for lane, sg, c in zip(lanes, sigs, cs):
        sig_cols[:, lane] = np.frombuffer(TB._g2_aff_col(sg), np.uint32)
        mask[0, lane] = 1
        lo[0, lane], hi[0, lane] = c & 0xFFFFFFFF, c >> 32
    lo[0, 9] = 12345                  # a dead lane with a nonzero scalar
    partials = PK.sigma_kernel_call(_i32(sig_cols), _i32(mask), _i32(lo),
                                    _i32(hi))
    assert partials.shape == (192, 2 * S)
    col, ident = PK.sigma_combine(partials)
    want = None
    for sg, c in zip(sigs, cs):
        want = JC.g2_add(want, JC.g2_mul(sg, c))
    x0, x1, y0, y1 = _canon_col(col.reshape(128, 1), 4, 0)
    assert not bool(ident)
    assert ((x0, x1), (y0, y1)) == want
    # an all-dead batch folds to the identity
    z = torch.zeros((1, 2 * S), dtype=torch.int32)
    _col, ident = PK.sigma_combine(PK.sigma_kernel_call(
        _i32(sig_cols), z, z, z))
    assert bool(ident)


@pytest.fixture(scope="module")
def miller_cell():
    """A 256-lane Miller+fold cell: lane 0 (P, Q) with lane 128 (−P, Q),
    lane 1 (P2, Q2) alone; the rest dead."""
    rng = np.random.default_rng(9)
    P1 = JC.g1_mul(JC.G1_GEN, int(rng.integers(1, 2 ** 62)))
    Q1 = JC.g2_mul(JC.G2_GEN, int(rng.integers(1, 2 ** 62)))
    P2 = JC.g1_mul(JC.G1_GEN, int(rng.integers(1, 2 ** 62)))
    Q2 = JC.g2_mul(JC.G2_GEN, int(rng.integers(1, 2 ** 62)))
    g1 = np.zeros((64, 2 * S), np.uint32)
    g2 = np.zeros((128, 2 * S), np.uint32)
    mask = np.zeros((1, 2 * S), np.int32)
    for lane, (p, q) in ((0, (P1, Q1)), (S, (JC.g1_neg(P1), Q1)),
                         (1, (P2, Q2))):
        g1[:, lane] = np.frombuffer(TB._g1_aff_col(p), np.uint32)
        g2[:, lane] = np.frombuffer(TB._g2_aff_col(q), np.uint32)
        mask[0, lane] = 1
    prod = PK.miller_fold_kernel_call(_i32(g1), _i32(g2), _i32(mask))
    return prod, (P2, Q2)


def test_miller_fold_plain_matches_host_pairing(miller_cell):
    prod, (P2, Q2) = miller_cell
    assert prod.shape == (384, S)
    fe3 = JPAIR.final_exponentiation_cubed
    # lane 0: e(P, Q)·e(−P, Q) → 1; lane 1: e(P2, Q2); lane 2: dead → 1
    assert fe3(_fq12_of(prod, 0)) == F.FQ12_ONE
    assert fe3(_fq12_of(prod, 1)) == fe3(JPAIR.miller_loop(P2, Q2))
    assert _fq12_of(prod, 2) == F.FQ12_ONE


def test_finalize_plain_matches_host_final_exponentiation(miller_cell):
    prod, _ = miller_cell
    ok, g = PK.finalize_kernel_call(prod, with_value=True)
    assert ok.shape == (1, 1) and int(ok) == 0          # e(P2, Q2) ≠ 1
    want = JPAIR.final_exponentiation_cubed(_fq12_of(prod, 1))
    assert _fq12_of(g, 0) == want
    one_block = prod.clone()
    one_block[:, 1] = one_block[:, 2]                   # lane 1 → 1
    assert int(PK.finalize_kernel_call(one_block)) == 1
    # 256 lanes (the block of 1s beside it) fold to the same product
    one = torch.from_numpy(TB._ONE_BLOCK.view(np.int32))
    ok, g256 = PK.finalize_kernel_call(torch.cat([prod, one], 1),
                                       with_value=True)
    assert int(ok) == 0 and _fq12_of(g256, 0) == want


def test_each_build_hashes_only_the_headers_it_includes(tmp_path,
                                                        monkeypatch):
    """An edit of the BLS field header rebuilds ``bls381`` and leaves the
    state root's ``sha256_merkle`` build as it was."""
    assert cuda_build._sources("sha256_merkle") == ["sha256_merkle.cu"]
    assert cuda_build._sources("bls381") == ["bls381.cu", "bls381_field.cuh"]
    for src in ("sha256_merkle.cu", "bls381.cu", "bls381_field.cuh"):
        shutil.copy(f"{cuda_build.CSRC}/{src}", tmp_path)
    monkeypatch.setattr(cuda_build, "CSRC", str(tmp_path))
    before = {n: cuda_build.library_path(n) for n in ("sha256_merkle",
                                                      "bls381")}
    with open(tmp_path / "bls381_field.cuh", "a") as fh:
        fh.write("// edited\n")
    assert cuda_build.library_path("sha256_merkle") == before["sha256_merkle"]
    assert cuda_build.library_path("bls381") != before["bls381"]
