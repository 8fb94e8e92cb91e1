"""The port's ``sigma_combine`` and finalize, their plain versions against
the JAX package, and the CUDA kernels' bodies run on the host.

``sigma_combine_plain`` is held raw against the JAX package's XLA glue
``sigma_combine``.  The CUDA header ``csrc/bls381_field.cuh`` compiles as
plain C++ too: a small shim built with g++ runs ``sigma_combine_lane``
(the body of ``lh_sigma_combine_kernel``) and ``finalize_body`` (the body
of ``lh_finalize_kernel``, every cooperative phase run for thread 0 ...
T-1 in turn) on the host, and both must equal the plain versions limb for
limb.  A tensor off the CPU never takes a plain version.
"""

import ctypes
import shutil
import subprocess

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lighthouse_tpu.crypto import curve as JC
from lighthouse_tpu.crypto import pairing_kernel as JPK
from lighthouse_tpu_torch import device
from lighthouse_tpu_torch.crypto import fields as F
from lighthouse_tpu_torch.crypto import limb_field as LF
from lighthouse_tpu_torch.crypto import pairing_kernel as PK
from lighthouse_tpu_torch.crypto import tpu_backend as TB
from lighthouse_tpu_torch.ops import cuda_build

S = PK.PREP_S

_HOST_SHIM = r"""
#include "bls381_field.cuh"
#include <stdlib.h>
#include <string.h>
extern "C" {
int host_init(const uint32_t* words, int n) {
  if ((size_t)n * 4 != sizeof(BlsConsts)) return -2;
  memcpy(&KC, words, sizeof(BlsConsts));
  return 0;
}
int host_sigma_combine(const int32_t* part, long long m, int C, int32_t* col) {
  return sigma_combine_lane(part, m, C, col);
}
int host_finalize(const int32_t* f, int32_t* ok, int32_t* g) {
  FinShared* sh = (FinShared*)malloc(sizeof(FinShared));
  if (!sh) return -1;
  finalize_body(HostRun<LH_COOP_THREADS>(), *sh, f, ok, g);
  free(sh);
  return 0;
}
}
"""


@pytest.fixture(autouse=True)
def on_cpu():
    """The plain versions run thousands of small ops: one torch thread
    each keeps parallel test workers from oversubscribing the cores."""
    prev, threads = device.default_device(), torch.get_num_threads()
    device.set_default_device("cpu")
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
    device.set_default_device(prev)


def _rand_planes(rng, k: int, m: int, lanes=None) -> np.ndarray:
    """(32·k, m) int32 blocks of random field elements below 2N on
    ``lanes`` (every lane by default), zeros elsewhere."""
    out = np.zeros((k, 32, m), np.int32)
    for b in range(k):
        for j in range(m) if lanes is None else lanes:
            v = int(rng.integers(1, 2 ** 62)) ** 7 % (2 * F.P)
            out[b, :26, j] = LF.int_to_limbs(v).astype(np.int32)
    return out.reshape(32 * k, m)


def _t(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(a.copy())


def _dead_partial(C: int) -> np.ndarray:
    """The partial of an all-dead sigma input: every chunk's sum is the
    identity.  One dead chunk through ``sigma_plain``, repeated C times."""
    z = torch.zeros((1, S), dtype=torch.int32)
    sig = torch.zeros((128, S), dtype=torch.int32)
    return np.tile(PK.sigma_kernel_call(sig, z, z, z).numpy(), (1, C))


def test_sigma_combine_plain_matches_jax_raw():
    """Two chunks of random projective sums through the JAX package's
    eager XLA glue and the port's plain version: the same limbs."""
    part = _rand_planes(np.random.default_rng(41), 6, 2 * S, lanes=(0, S))
    col, ident = JPK.sigma_combine(jnp.asarray(part.view(np.uint32)))
    ours, flag = PK.sigma_combine_plain(_t(part))
    assert np.array_equal(np.asarray(col).view(np.int32), ours.numpy())
    assert bool(ident) == bool(flag) is False


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    """The shim above, built with g++ against the CUDA header, its
    constant block filled from ``cuda_consts()``."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("no g++ on this machine")
    d = tmp_path_factory.mktemp("host_kernels")
    (d / "host_shim.cpp").write_text(_HOST_SHIM)
    so = d / "libhost_kernels.so"
    subprocess.run([gxx, "-O1", "-std=c++17", "-shared", "-fPIC",
                    "-I", cuda_build.CSRC, "-o", str(so),
                    str(d / "host_shim.cpp")], check=True, capture_output=True)
    lib = ctypes.CDLL(str(so))
    P = ctypes.c_void_p
    lib.host_init.argtypes = [P, ctypes.c_int]
    lib.host_sigma_combine.argtypes = [P, ctypes.c_longlong, ctypes.c_int, P]
    lib.host_finalize.argtypes = [P, P, P]
    consts = PK.cuda_consts()
    assert lib.host_init(consts.ctypes.data, consts.size) == 0
    return lib


@pytest.mark.parametrize("C, n, dead", [(2, 1, False), (2, 2, False),
                                        (8, 1, False), (8, 2, False),
                                        (2, 2, True), (8, 1, True)])
def test_sigma_combine_lane_on_host_matches_plain(host_lib, C, n, dead):
    """sigma_combine_lane (one thread per partial) against the plain
    version on 1 or 2 partials; ``dead`` makes the last partial all-dead,
    whose sum is the identity."""
    rng = np.random.default_rng(100 * C + n)
    parts = [_rand_planes(rng, 6, C * S, lanes=range(0, C * S, S))
             for _ in range(n)]
    if dead:
        parts[-1] = _dead_partial(C)
    want = PK.sigma_combine_plain(*[_t(p) for p in parts])
    want = [want] if n == 1 else want
    for p, (w_col, w_flag) in zip(parts, want):
        col = np.zeros(128, np.int32)
        flag = host_lib.host_sigma_combine(p.ctypes.data, C * S, C,
                                           col.ctypes.data)
        assert np.array_equal(col, w_col.numpy())
        assert flag == int(w_flag)
    if dead:
        assert int(want[-1][1]) == 1 and not want[-1][0].any()


def _host_finalize(lib, f: np.ndarray):
    f = np.ascontiguousarray(f, np.int32)
    ok = np.zeros((1, 1), np.int32)
    g = np.zeros((384, 1), np.int32)
    assert lib.host_finalize(f.ctypes.data, ok.ctypes.data, g.ctypes.data) == 0
    return ok, g


@pytest.fixture(scope="module")
def pairing_cell():
    """The 128-lane products of a Miller+fold cell built as
    ``test_torch_bls_kernels.miller_cell`` builds it: lane 0 holds
    e(P, Q)·e(−P, Q), lane 1 e(P2, Q2), the rest are dead (1)."""
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
    return PK.miller_fold_kernel_call(_t(g1.view(np.int32)),
                                      _t(g2.view(np.int32)), _t(mask)).numpy()


@pytest.mark.parametrize("case", ["pairing cell", "product one",
                                  "random lanes"])
def test_finalize_body_on_host_matches_plain(host_lib, pairing_cell, case):
    """finalize_body, phase by phase for every thread, against
    finalize_plain: the verdict exactly and the cubed final
    exponentiation limb for limb."""
    f = pairing_cell.copy()
    want_ok = 0
    if case == "product one":
        f[:, 1] = f[:, 2]               # lane 1 dead too: ∏ = e(P,Q)e(−P,Q)
        want_ok = 1
    elif case == "random lanes":
        f = _rand_planes(np.random.default_rng(43), 12, S)
    ok, g = _host_finalize(host_lib, f)
    ok_p, g_p = PK.finalize_plain(_t(f), with_value=True)
    assert int(ok[0, 0]) == int(ok_p) == want_ok
    assert np.array_equal(g, g_p.numpy())


@pytest.mark.parametrize("n", [0, 1, 7])
def test_fp_mul_chain_plain_is_x_times_y_to_the_n(n):
    """The plain twin of the latency probe: n dependent Montgomery
    products x <- x·y·R^-1, checked with Python integers mod p."""
    xy = _rand_planes(np.random.default_rng(44 + n), 1, 2)
    x, y = (LF.limbs_to_int(xy[:26, j].astype(np.int64)) for j in (0, 1))
    out = PK.fp_mul_chain_plain(_t(xy), n)
    want = x * pow(y * LF.RINV_INT, n, F.P) % F.P
    assert LF.limbs_to_int(out.numpy()[:26, 0].astype(np.int64)) % F.P == want


def _meta(rows: int, lanes: int) -> torch.Tensor:
    return torch.empty((rows, lanes), dtype=torch.int32, device="meta")


_OFF_CPU_CALLS = {
    "sigma_combine": lambda: PK.sigma_combine(_meta(192, 2 * S)),
    "sigma_combine, two partials": lambda: PK.sigma_combine(
        _meta(192, 8 * S), _meta(192, 8 * S)),
    "finalize": lambda: PK.finalize_kernel_call(_meta(384, S)),
}


@pytest.mark.parametrize("call", sorted(_OFF_CPU_CALLS))
def test_off_cpu_tensor_launches_or_raises(call, monkeypatch):
    """A tensor that is not on the CPU goes to the kernel or raises: it
    is refused where it is not a CUDA tensor, and past that check a
    kernel library that cannot load raises through; neither time does the
    plain version run."""
    plain = []
    monkeypatch.setattr(PK, "sigma_combine_plain",
                        lambda *a: plain.append(a))
    monkeypatch.setattr(PK, "finalize_plain",
                        lambda *a, **k: plain.append(a))
    with pytest.raises(ValueError, match="unsupported device meta"):
        _OFF_CPU_CALLS[call]()

    def no_library():
        raise RuntimeError("kernel library unavailable")

    monkeypatch.setattr(PK, "_require_cuda", lambda x: None)
    monkeypatch.setattr(PK, "kernel_library", no_library)
    with pytest.raises(RuntimeError, match="kernel library unavailable"):
        _OFF_CPU_CALLS[call]()
    assert not plain


def test_general_entry_raises_without_gpu_before_any_plain_version(
        monkeypatch):
    """With the default device ``cuda`` and no GPU, a general-path batch
    raises; neither plain version runs in its place."""
    from lighthouse_tpu_torch.crypto import bls
    plain = []
    monkeypatch.setattr(PK, "sigma_combine_plain",
                        lambda *a: plain.append(a))
    monkeypatch.setattr(PK, "finalize_plain",
                        lambda *a, **k: plain.append(a))
    monkeypatch.setattr(bls, "_active", None)
    sks = [bls.SecretKey(0x10000 + 7 * i) for i in range(4)]
    sets = [bls.SignatureSet(sk.sign(b"m%d" % i), [sk.public_key()],
                             b"m%d" % i) for i, sk in enumerate(sks)]
    device.set_default_device("cuda")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bls.verify_signature_sets(sets)
    assert not plain
