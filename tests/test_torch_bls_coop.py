"""The thread-group bodies of ``lh_miller_fold_kernel`` and
``lh_hash_g2_kernel`` run on the host, held raw against the plain
versions.

The CUDA header ``csrc/bls381_field.cuh`` compiles as plain C++: a small
shim built with g++ runs ``miller_fold_body`` (one group per lane pair)
and ``hash_g2_body`` (one group per message) group by group, every phase
for the threads of a group one after the other, and both must equal the
plain versions limb for limb for groups of 32, 64 and 128 threads.  The
layer's rule is that no item of a phase reads what another item of that
phase writes; the card runs a phase's threads in no fixed order, so each
body is run with the threads of every phase in three orders (0 ... G-1,
G-1 ... 0 and one fixed shuffle): an item that breaks the rule reads
another value in one of them, and the output changes.
"""

import ctypes
import shutil
import subprocess

import numpy as np
import pytest
import torch

from lighthouse_tpu.crypto import curve as JC
from lighthouse_tpu_torch import device
from lighthouse_tpu_torch.crypto import fields as F
from lighthouse_tpu_torch.crypto import htc_kernel as HK
from lighthouse_tpu_torch.crypto import limb_field as LF
from lighthouse_tpu_torch.crypto import pairing_kernel as PK
from lighthouse_tpu_torch.crypto import tpu_backend as TB
from lighthouse_tpu_torch.ops import cuda_build

S = PK.PREP_S

_HOST_SHIM = r"""
#include "bls381_field.cuh"
#include <stdlib.h>
#include <string.h>
template <int G>
static void miller_groups(const int32_t* g1, const int32_t* g2,
                          const int32_t* mask, int32_t* out, long long m,
                          MillerShared* sh, int order) {
  const HostRun<G> run(order);
  for (long long p = 0; p < m / 2; ++p)
    miller_fold_body(run, *sh, g1, g2, mask, out, m, p);
}
template <int G>
static void hash_groups(const int32_t* u, int32_t* out, long long m2,
                        HashShared* sh, int order) {
  const HostRun<G> run(order);
  for (long long k = 0; k < m2 / 2; ++k)
    hash_g2_body(run, *sh, u, out, m2, k);
}
extern "C" {
int host_init(const uint32_t* words, int n) {
  if ((size_t)n * 4 != sizeof(BlsConsts)) return -2;
  memcpy(&KC, words, sizeof(BlsConsts));
  return 0;
}
int host_miller_fold(const int32_t* g1, const int32_t* g2,
                     const int32_t* mask, int32_t* out, long long m, int G,
                     int order) {
  MillerShared* sh = (MillerShared*)malloc(sizeof(MillerShared));
  if (!sh) return -1;
  if (G == 32) miller_groups<32>(g1, g2, mask, out, m, sh, order);
  else if (G == 64) miller_groups<64>(g1, g2, mask, out, m, sh, order);
  else miller_groups<128>(g1, g2, mask, out, m, sh, order);
  free(sh);
  return 0;
}
int host_finalize(const int32_t* f, int32_t* ok, int32_t* g, int order) {
  FinShared* sh = (FinShared*)malloc(sizeof(FinShared));
  if (!sh) return -1;
  finalize_body(HostRun<LH_COOP_THREADS>(order), *sh, f, ok, g);
  free(sh);
  return 0;
}
int host_hash_g2(const int32_t* u, int32_t* out, long long m2, int G,
                 int order) {
  HashShared* sh = (HashShared*)malloc(sizeof(HashShared));
  if (!sh) return -1;
  if (G == 32) hash_groups<32>(u, out, m2, sh, order);
  else if (G == 64) hash_groups<64>(u, out, m2, sh, order);
  else hash_groups<128>(u, out, m2, sh, order);
  free(sh);
  return 0;
}
}
"""


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


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    """The shim above, built with g++ against the CUDA header, its
    constant block filled from ``cuda_consts()``."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("no g++ on this machine")
    d = tmp_path_factory.mktemp("host_groups")
    (d / "host_shim.cpp").write_text(_HOST_SHIM)
    so = d / "libhost_groups.so"
    subprocess.run([gxx, "-O1", "-std=c++17", "-shared", "-fPIC",
                    "-I", cuda_build.CSRC, "-o", str(so),
                    str(d / "host_shim.cpp")], check=True, capture_output=True)
    lib = ctypes.CDLL(str(so))
    P = ctypes.c_void_p
    lib.host_init.argtypes = [P, ctypes.c_int]
    lib.host_miller_fold.argtypes = [P, P, P, P, ctypes.c_longlong,
                                     ctypes.c_int, ctypes.c_int]
    lib.host_hash_g2.argtypes = [P, P, ctypes.c_longlong, ctypes.c_int,
                                 ctypes.c_int]
    lib.host_finalize.argtypes = [P, P, P, ctypes.c_int]
    consts = PK.cuda_consts()
    assert lib.host_init(consts.ctypes.data, consts.size) == 0
    return lib


# the orders HostRun runs a phase's threads in
ORDERS = {"forward": 0, "reverse": 1, "shuffled": 2}


def _t(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(a.copy())


@pytest.fixture(scope="module")
def miller_cells():
    """A 256-lane Miller cell as ``miller_fold_kernel_call`` takes it:
    pair 0 with both lanes live (e(P, Q) and e(−P, Q)), pair 1 with only
    lane j live, pairs 2 and 7 with only lane j + 128 live, pair 3 dead
    over real points, the rest dead over zeros; and the same planes with
    every lane dead.  Each with its plain fold."""
    rng = np.random.default_rng(51)
    g1 = np.zeros((64, 2 * S), np.uint32)
    g2 = np.zeros((128, 2 * S), np.uint32)
    mask = np.zeros((1, 2 * S), np.int32)
    P1 = JC.g1_mul(JC.G1_GEN, int(rng.integers(1, 2 ** 62)))
    Q1 = JC.g2_mul(JC.G2_GEN, int(rng.integers(1, 2 ** 62)))
    lanes = [(0, P1, Q1, 1), (S, JC.g1_neg(P1), Q1, 1)]
    for lane in (1, S + 2, S + 7, 3):
        lanes.append((lane, JC.g1_mul(JC.G1_GEN, int(rng.integers(1, 2 ** 62))),
                      JC.g2_mul(JC.G2_GEN, int(rng.integers(1, 2 ** 62))),
                      int(lane != 3)))
    for lane, p, q, live in lanes:
        g1[:, lane] = np.frombuffer(TB._g1_aff_col(p), np.uint32)
        g2[:, lane] = np.frombuffer(TB._g2_aff_col(q), np.uint32)
        mask[0, lane] = live
    g1, g2 = g1.view(np.int32), g2.view(np.int32)
    cells = {}
    for name, m in (("pairs", mask), ("all dead", np.zeros_like(mask))):
        want = PK.miller_fold_plain(_t(g1), _t(g2), _t(m)).numpy()
        cells[name] = (g1, g2, m, want)
    return cells


@pytest.mark.parametrize("order", sorted(ORDERS))
@pytest.mark.parametrize("G", [32, 64, 128])
@pytest.mark.parametrize("case", ["pairs", "all dead"])
def test_miller_fold_groups_on_host_match_plain(host_lib, miller_cells, G,
                                                case, order):
    """miller_fold_body, one group of G threads per lane pair, against
    miller_fold_plain raw, with the threads of each phase in ``order``:
    live pairs, pairs with one live lane either side, dead pairs over
    real points and over zeros (ONE · ONE)."""
    g1, g2, mask, want = miller_cells[case]
    out = np.zeros((384, S), np.int32)
    assert host_lib.host_miller_fold(g1.ctypes.data, g2.ctypes.data,
                                     mask.ctypes.data, out.ctypes.data,
                                     2 * S, G, ORDERS[order]) == 0
    assert np.array_equal(out, want)


@pytest.fixture(scope="module")
def hash_cell():
    """One 128-message cell of five distinct messages in slots 0..19 and
    zero padding lanes after them (u = 0 takes SSWU's tv2 = 0 branch),
    with its plain hash."""
    msgs = [(0, j, b"coop-%d" % (j % 5)) for j in range(20)]
    u = HK.u_planes_for_messages(msgs, 1).view(np.int32).copy()
    return u, HK.hash_g2_plain(_t(u)).numpy()


@pytest.mark.parametrize("order", sorted(ORDERS))
@pytest.mark.parametrize("G", [32, 64, 128])
def test_hash_g2_groups_on_host_match_plain(host_lib, hash_cell, G, order):
    """hash_g2_body, one group of G threads per message, against
    hash_g2_plain raw on real messages and zero padding lanes, with the
    threads of each phase in ``order``."""
    u, want = hash_cell
    out = np.zeros((128, S), np.int32)
    assert host_lib.host_hash_g2(u.ctypes.data, out.ctypes.data, 2 * S,
                                 G, ORDERS[order]) == 0
    assert np.array_equal(out, want)
    assert want[:, 20:].any() and (want[:, 20:] == want[:, 127:]).all()


@pytest.mark.parametrize("order", ["reverse", "shuffled"])
def test_finalize_body_on_host_in_every_order(host_lib, order):
    """finalize_body (one group of LH_COOP_THREADS) on random lanes with
    the threads of each phase in ``order``, against finalize_plain raw
    (``test_torch_bls_finalize.py`` runs it in thread order)."""
    rng = np.random.default_rng(44)
    f = np.zeros((12, 32, S), np.int32)      # random elements below 2N
    for b in range(12):
        for j in range(S):
            v = int(rng.integers(1, 2 ** 62)) ** 7 % (2 * F.P)
            f[b, :26, j] = LF.int_to_limbs(v).astype(np.int32)
    f = f.reshape(384, S)
    ok = np.zeros((1, 1), np.int32)
    g = np.zeros((384, 1), np.int32)
    assert host_lib.host_finalize(f.ctypes.data, ok.ctypes.data,
                                  g.ctypes.data, ORDERS[order]) == 0
    ok_p, g_p = PK.finalize_plain(_t(f), with_value=True)
    assert int(ok[0, 0]) == int(ok_p) == 0
    assert np.array_equal(g, g_p.numpy())
