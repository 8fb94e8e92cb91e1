"""The thread-group bodies of the BLS kernels run on the host, held raw
against the plain versions.

The CUDA header ``csrc/bls381_field.cuh`` compiles as plain C++: a small
shim built with g++ runs ``miller_fold_body`` and ``miller_body`` (one
group per lane pair), ``hash_g2_body`` (one group per message),
``sigma_ladder_body`` (one group per lane) with the sigma butterfly's
cluster steps (``sigma_fold_step``, the cluster's blocks one after the
other between its barriers), ``prepare_body`` (one group per set, sub-warp
groups included), ``product_pair_body`` (one group per output lane) and
``product_class_body`` (the roll butterfly: a block per residue class, its
groups one after the other between the block's barriers) group by group,
every phase for the threads of a group one after the other, and each must
equal its plain version limb for limb at every group size its kernel may
launch with.  The layer's rule is that no item of a phase
reads what another item of that phase writes; the card runs a phase's
threads (and a cluster's blocks) in no fixed order, so each body is run
with the threads of every phase in three orders (0 ... G-1, G-1 ... 0 and
one fixed shuffle): an item that breaks the rule reads another value in
one of them, and the output changes.  The butterfly's groups run in the
same three orders within each level.
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
template <int G>
static void sigma_groups(const int32_t* sig, const int32_t* mask,
                         const int32_t* lo, const int32_t* hi, int32_t* out,
                         long long m, SigmaLane* sh, int order) {
  const HostRun<G> run(order);
  for (long long l = 0; l < m; ++l)
    sigma_ladder_body(run, *sh, sig, mask, lo, hi, out, m, l);
}
// The butterfly of each chunk: the cluster's blocks step by step, in
// ``order`` between the cluster barriers.
static void sigma_fold(int32_t* out, long long m, SigmaFoldShared* sh,
                       int order) {
  const HostRun<LH_SIGMA_FOLD_THREADS> run(order);
  const HostRun<LH_SIGMA_CLUSTER> blocks(order);
  for (long long c = 0; c < m / LH_LANES; ++c) {
    const long long lane0 = c * LH_LANES;
    for (int r = 0; r < LH_SIGMA_CLUSTER; ++r)
      sigma_fold_load(run, sh[r], out, m, lane0 + r * LH_SIGMA_FOLD_LANES);
    for (int s = 0; s < LH_SIGMA_STEPS; ++s)
      for (int i = 0; i < LH_SIGMA_CLUSTER; ++i) {
        const int r = blocks.perm[i];
        sigma_fold_step(run, sh[r], [&](int q) { return &sh[q]; }, r, s);
      }
    for (int r = 0; r < LH_SIGMA_CLUSTER; ++r)
      sigma_fold_store(run, sh[r], out, m, lane0 + r * LH_SIGMA_FOLD_LANES);
  }
}
template <int G>
static void prepare_groups(const int32_t* pk, const int32_t* kmask,
                           const int32_t* lo, const int32_t* hi, int32_t* out,
                           int32_t* flags, long long m, int K, PrepShared* sh,
                           int order) {
  const HostRun<G> run(order);
  for (long long s = 0; s < m; ++s)
    prepare_body(run, *sh, pk, kmask, lo, hi, out, flags, m, K, s);
}
template <int G>
static void product_groups(const int32_t* f, const int32_t* mask,
                           int32_t* out, long long m, PairShared* sh,
                           int order) {
  const HostRun<G> run(order);
  for (long long l = 0; l < m / 2; ++l)
    product_pair_body(run, *sh, f, mask, out, m, l);
}
// The roll butterfly block by block (class t = 0 ... 127): each level's
// groups one after the other in ``order``, the block's barrier between
// levels, as product_classes runs it on the card.
template <int G, int K>
static int product_blocks(const int32_t* f, const int32_t* mask,
                          int32_t* out, long long m, int order) {
  const HostRun<G> run(order);
  const HostRun<LH_PRODUCT_GROUPS_MAX> perm(order);
  const ProductShape s = product_shape(m, K);
  Fp12* buf = (Fp12*)malloc(2 * s.R * sizeof(Fp12));
  ProductWave<K>* waves =
      (ProductWave<K>*)malloc(s.groups * sizeof(ProductWave<K>));
  if (!buf || !waves) return -1;
  auto groups = [&](auto&& fn) {
    for (int i = 0; i < LH_PRODUCT_GROUPS_MAX; ++i)
      if (perm.perm[i] < s.groups) fn(perm.perm[i]);
  };
  for (int t = 0; t < LH_LANES; ++t)
    product_class_body<K>(run, groups, buf, waves, f, mask, out, m, t);
  free(buf);
  free(waves);
  return 0;
}
// The Miller loop alone on the n pairs given by index.
template <int G>
static void miller_alone_groups(const int32_t* g1, const int32_t* g2,
                                int32_t* out, long long m,
                                const long long* pairs, int n,
                                MillerShared* sh, int order) {
  const HostRun<G> run(order);
  for (int k = 0; k < n; ++k) miller_body(run, *sh, g1, g2, out, m, pairs[k]);
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
int host_sigma(const int32_t* sig, const int32_t* mask, const int32_t* lo,
               const int32_t* hi, int32_t* out, long long m, int G,
               int order) {
  SigmaLane* sh = (SigmaLane*)malloc(sizeof(SigmaLane));
  SigmaFoldShared* fs =
      (SigmaFoldShared*)malloc(LH_SIGMA_CLUSTER * sizeof(SigmaFoldShared));
  if (!sh || !fs) return -1;
  if (G == 32) sigma_groups<32>(sig, mask, lo, hi, out, m, sh, order);
  else sigma_groups<64>(sig, mask, lo, hi, out, m, sh, order);
  sigma_fold(out, m, fs, order);
  free(sh);
  free(fs);
  return 0;
}
int host_product_chunks(const int32_t* f, const int32_t* mask, int32_t* out,
                        long long m, int G, int order) {
  PairShared* sh = (PairShared*)malloc(sizeof(PairShared));
  if (!sh) return -1;
  if (G == 32) product_groups<32>(f, mask, out, m, sh, order);
  else product_groups<64>(f, mask, out, m, sh, order);
  free(sh);
  return 0;
}
int host_product(const int32_t* f, const int32_t* mask, int32_t* out,
                 long long m, int G, int K, int order) {
  if (G == 32 && K == 1) return product_blocks<32, 1>(f, mask, out, m, order);
  if (G == 32 && K == 2) return product_blocks<32, 2>(f, mask, out, m, order);
  if (G == 64 && K == 1) return product_blocks<64, 1>(f, mask, out, m, order);
  if (G == 64 && K == 2) return product_blocks<64, 2>(f, mask, out, m, order);
  return -2;
}
int host_miller(const int32_t* g1, const int32_t* g2, int32_t* out,
                long long m, const long long* pairs, int n, int G,
                int order) {
  MillerShared* sh = (MillerShared*)malloc(sizeof(MillerShared));
  if (!sh) return -1;
  if (G == 32) miller_alone_groups<32>(g1, g2, out, m, pairs, n, sh, order);
  else miller_alone_groups<64>(g1, g2, out, m, pairs, n, sh, order);
  free(sh);
  return 0;
}
int host_prepare(const int32_t* pk, const int32_t* kmask, const int32_t* lo,
                 const int32_t* hi, int32_t* out, int32_t* flags, long long m,
                 int K, int G, int order) {
  PrepShared* sh = (PrepShared*)malloc(sizeof(PrepShared));
  if (!sh) return -1;
  if (G == 8) prepare_groups<8>(pk, kmask, lo, hi, out, flags, m, K, sh, order);
  else if (G == 16) prepare_groups<16>(pk, kmask, lo, hi, out, flags, m, K, sh, order);
  else prepare_groups<32>(pk, kmask, lo, hi, out, flags, m, K, sh, order);
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
    lib.host_sigma.argtypes = [P, P, P, P, P, ctypes.c_longlong, ctypes.c_int,
                               ctypes.c_int]
    lib.host_prepare.argtypes = [P, P, P, P, P, P, ctypes.c_longlong,
                                 ctypes.c_int, ctypes.c_int, ctypes.c_int]
    lib.host_product_chunks.argtypes = [P, P, P, ctypes.c_longlong,
                                        ctypes.c_int, ctypes.c_int]
    lib.host_miller.argtypes = [P, P, P, ctypes.c_longlong, P, ctypes.c_int,
                                ctypes.c_int, ctypes.c_int]
    lib.host_product.argtypes = [P, P, P, ctypes.c_longlong, ctypes.c_int,
                                 ctypes.c_int, ctypes.c_int]
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


def _u32_plane(values) -> np.ndarray:
    return np.asarray(values, np.uint64).astype(np.uint32).view(
        np.int32).reshape(1, -1)


@pytest.fixture(scope="module")
def sigma_chunk():
    """One 128-lane chunk as ``sigma_kernel_call`` takes it: live lanes
    over real G2 points (four, repeated) with random 64-bit scalars, lanes
    with scalar 1, a 32-bit scalar and scalar 0, a masked lane with a
    nonzero scalar (its ladder runs from the identity), and dead lanes
    (mask 0, scalar 0) over the same points; and the plain output (every
    lane of the chunk holds its own sum).  Few live lanes keep the plain
    ladder quick; the butterfly runs over all 128."""
    rng = np.random.default_rng(61)
    pts = [JC.g2_mul(JC.G2_GEN, int(rng.integers(1, 2 ** 62)))
           for _ in range(4)]
    sig = np.zeros((128, S), np.uint32)
    for j in range(S):
        sig[:, j] = np.frombuffer(TB._g2_aff_col(pts[j % 4]), np.uint32)
    mask = np.zeros((1, S), np.int32)
    lo = np.zeros(S, np.uint64)
    hi = np.zeros(S, np.uint64)
    live = [3 * j + j % 2 for j in range(24)]          # spread over the chunk
    mask[0, live] = 1
    lo[live] = rng.integers(0, 2 ** 32, 24, dtype=np.uint64)
    hi[live] = rng.integers(0, 2 ** 32, 24, dtype=np.uint64)
    lo[live[1]], hi[live[1]] = 1, 0                    # scalar 1
    hi[live[2]] = 0                                    # a 32-bit scalar
    lo[live[3]], hi[live[3]] = 0, 0                    # live, scalar 0
    lo[100], hi[100] = 0x9e3779b9, 0x7f4a7c15          # masked, scalar set
    sig = sig.view(np.int32)
    lo, hi = _u32_plane(lo), _u32_plane(hi)
    want = PK.sigma_plain(_t(sig), _t(mask), _t(lo), _t(hi)).numpy()
    return sig, mask, lo, hi, want


@pytest.mark.parametrize("order", sorted(ORDERS))
@pytest.mark.parametrize("G", [32, 64])
def test_sigma_groups_on_host_match_plain(host_lib, sigma_chunk, G, order):
    """sigma_ladder_body (one group of G threads per lane) and the
    butterfly's cluster steps against sigma_plain raw over all 128 lanes,
    with the threads of each phase and the cluster's blocks in
    ``order``."""
    sig, mask, lo, hi, want = sigma_chunk
    out = np.zeros((192, S), np.int32)
    assert host_lib.host_sigma(sig.ctypes.data, mask.ctypes.data,
                               lo.ctypes.data, hi.ctypes.data,
                               out.ctypes.data, S, G, ORDERS[order]) == 0
    assert np.array_equal(out, want)


PREP_K = 3


@pytest.fixture(scope="module")
def prepare_chunk():
    """One 128-set chunk with K = 3 as ``prepare_kernel_call`` takes it:
    real G1 keys (eight, cycled) with random 64-bit scalars, sets with a
    masked slot, a set whose keys are P and -P (its sum is the identity),
    dead sets (no live slot, scalar 0) and a keyless set with a scalar;
    and the plain output and flags."""
    rng = np.random.default_rng(62)
    keys = [JC.g1_mul(JC.G1_GEN, int(rng.integers(1, 2 ** 62)))
            for _ in range(8)]
    pk = np.zeros((64, PREP_K * S), np.uint32)
    kmask = np.ones((1, PREP_K * S), np.int32)
    for s_ in range(S):
        for k in range(PREP_K):
            pk[:, k * S + s_] = np.frombuffer(
                TB._g1_aff_col(keys[(3 * s_ + k) % 8]), np.uint32)
    kmask[0, 1 * S + 5] = 0                  # set 5: slot 1 masked
    kmask[0, 0 * S + 6] = kmask[0, 2 * S + 6] = 0    # set 6: slot 1 only
    p = keys[3]
    pk[:, 0 * S + 77] = np.frombuffer(TB._g1_aff_col(p), np.uint32)
    pk[:, 1 * S + 77] = np.frombuffer(TB._g1_aff_col(JC.g1_neg(p)), np.uint32)
    kmask[0, 2 * S + 77] = 0                 # set 77: P + (-P)
    lo = rng.integers(0, 2 ** 32, S, dtype=np.uint64)
    hi = rng.integers(0, 2 ** 32, S, dtype=np.uint64)
    for s_ in range(110, 121):               # dead sets, then keyless 120
        kmask[0, [k * S + s_ for k in range(PREP_K)]] = 0
    lo[110:120], hi[110:120] = 0, 0
    lo[121], hi[121] = 1, 0
    pk = pk.view(np.int32)
    lo, hi = _u32_plane(lo), _u32_plane(hi)
    g, f = PK.prepare_plain(_t(pk), _t(kmask), _t(lo), _t(hi), PREP_K)
    return pk, kmask, lo, hi, g.numpy(), f.numpy()


@pytest.mark.parametrize("order", sorted(ORDERS))
@pytest.mark.parametrize("G", [8, 16, 32])
def test_prepare_groups_on_host_match_plain(host_lib, prepare_chunk, G,
                                            order):
    """prepare_body (one group of G threads per set; 8 and 16 are
    sub-warp groups) against prepare_plain raw, points and flags, with the
    threads of each phase in ``order``."""
    pk, kmask, lo, hi, want_g, want_f = prepare_chunk
    out = np.zeros((64, S), np.int32)
    flags = np.zeros((1, S), np.int32)
    assert host_lib.host_prepare(pk.ctypes.data, kmask.ctypes.data,
                                 lo.ctypes.data, hi.ctypes.data,
                                 out.ctypes.data, flags.ctypes.data, S,
                                 PREP_K, G, ORDERS[order]) == 0
    assert np.array_equal(out, want_g)
    assert np.array_equal(flags, want_f)
    for s_ in (77, 110, 119, 120):           # identity sums and dead sets
        assert flags[0, s_] == 1 and not out[:, s_].any()
    assert flags[0, 0] == 0 and flags[0, 5] == 0 and flags[0, 6] == 0


def _rand_fq12_planes(rng, m: int) -> np.ndarray:
    """(384, m) int32 blocks of random values below 2N: limbs 0..22
    random, limb 23 below 2N >> 368 = 0x3402, limbs 24 and 25 zero."""
    f = np.zeros((12, 32, m), np.int32)
    f[:, :23] = rng.integers(0, 2 ** 16, (12, 23, m))
    f[:, 23] = rng.integers(0, 0x3402, (12, m))
    return f.reshape(384, m)


@pytest.fixture(scope="module")
def product_planes():
    """512 lanes (two chunks) of random Fq12 values, with the mask all
    ones and a random mask (about 30% of the lanes ONE), each with its
    plain product_chunks."""
    rng = np.random.default_rng(71)
    f = _rand_fq12_planes(rng, 4 * S)
    cases = {}
    for name, mask in (("ones", np.ones((1, 4 * S), np.int32)),
                       ("random mask", (rng.random((1, 4 * S)) < 0.7)
                        .astype(np.int32))):
        cases[name] = (f, mask,
                       PK.product_chunks_plain(_t(f), _t(mask)).numpy())
    return cases


@pytest.mark.parametrize("order", sorted(ORDERS))
@pytest.mark.parametrize("G", [32, 64])
@pytest.mark.parametrize("case", ["ones", "random mask"])
def test_product_pair_groups_on_host_match_plain(host_lib, product_planes, G,
                                                 case, order):
    """product_pair_body, one group of G threads per output lane, against
    product_chunks_plain raw on 512 → 256 lanes, with the threads of each
    phase in ``order``."""
    f, mask, want = product_planes[case]
    out = np.zeros((384, 2 * S), np.int32)
    assert host_lib.host_product_chunks(f.ctypes.data, mask.ctypes.data,
                                        out.ctypes.data, 4 * S, G,
                                        ORDERS[order]) == 0
    assert np.array_equal(out, want)


# Pairs (lanes 2p, 2p + 1) the host runs of the 384-lane Miller planes:
# one in each 128-lane block, a pair over zeros and the last pair.
MILLER_PAIRS = (0, 65, 100, 128, 191)


@pytest.fixture(scope="module")
def miller_planes():
    """384 lanes (three blocks) as ``miller_kernel_call`` takes them:
    real points on lanes 0 and 1 (e(P, Q) and e(−P, Q)), 131, 256 and
    383, zeros elsewhere; and the plain Miller values (its dedup runs the
    zero lanes once)."""
    rng = np.random.default_rng(72)
    m = 3 * S
    g1 = np.zeros((64, m), np.uint32)
    g2 = np.zeros((128, m), np.uint32)
    P1 = JC.g1_mul(JC.G1_GEN, int(rng.integers(1, 2 ** 62)))
    Q1 = JC.g2_mul(JC.G2_GEN, int(rng.integers(1, 2 ** 62)))
    lanes = [(0, P1, Q1), (1, JC.g1_neg(P1), Q1)]
    for lane in (131, 256, 383):
        lanes.append((lane, JC.g1_mul(JC.G1_GEN, int(rng.integers(1, 2 ** 62))),
                      JC.g2_mul(JC.G2_GEN, int(rng.integers(1, 2 ** 62)))))
    for lane, p, q in lanes:
        g1[:, lane] = np.frombuffer(TB._g1_aff_col(p), np.uint32)
        g2[:, lane] = np.frombuffer(TB._g2_aff_col(q), np.uint32)
    g1, g2 = g1.view(np.int32), g2.view(np.int32)
    return g1, g2, PK.miller_plain(_t(g1), _t(g2)).numpy()


@pytest.mark.parametrize("order", sorted(ORDERS))
@pytest.mark.parametrize("G", [32, 64])
def test_miller_groups_on_host_match_plain(host_lib, miller_planes, G, order):
    """miller_body, one group of G threads per lane pair (2p, 2p + 1),
    against miller_plain raw on the pairs of MILLER_PAIRS of 384 lanes
    (real points, a real point beside a zero lane, two zero lanes), with
    the threads of each phase in ``order``; the columns of the other
    pairs stay unwritten."""
    g1, g2, want = miller_planes
    m = g1.shape[1]
    pairs = np.array(MILLER_PAIRS, np.int64)
    out = np.zeros((384, m), np.int32)
    assert host_lib.host_miller(g1.ctypes.data, g2.ctypes.data,
                                out.ctypes.data, m, pairs.ctypes.data,
                                len(pairs), G, ORDERS[order]) == 0
    cols = np.concatenate([2 * pairs, 2 * pairs + 1])
    assert np.array_equal(out[:, cols], want[:, cols])
    rest = np.setdiff1d(np.arange(m), cols)
    assert not out[:, rest].any()
    assert not np.array_equal(want[:, 0], want[:, 200])     # real vs zero


# (threads a group, lanes a group's wave) of the butterfly: the port's
# shape (LH_PRODUCT_G, LH_PRODUCT_LANES) and the probe's others
PRODUCT_SHAPES = ((32, 1), (32, 2), (64, 1), (64, 2))
PRODUCT_MASKS = ("ones", "random mask", "all zero")


@pytest.fixture(scope="module")
def butterfly_planes():
    """1024 lanes of random Fq12 values and three masks over them (all
    ones, about 30% of the lanes ONE, all ONE); ``want(m, case)`` is the
    plain butterfly of the first m lanes, computed once."""
    rng = np.random.default_rng(81)
    f = _rand_fq12_planes(rng, 8 * S)
    masks = {"ones": np.ones((1, 8 * S), np.int32),
             "random mask": (rng.random((1, 8 * S)) < 0.7).astype(np.int32),
             "all zero": np.zeros((1, 8 * S), np.int32)}
    done = {}

    def want(m, case):
        if (m, case) not in done:
            fm = np.ascontiguousarray(f[:, :m])
            mm = np.ascontiguousarray(masks[case][:, :m])
            done[m, case] = (fm, mm, PK.product_plain(_t(fm), _t(mm)).numpy())
        return done[m, case]

    return want


@pytest.mark.parametrize("order", sorted(ORDERS))
@pytest.mark.parametrize("shape", PRODUCT_SHAPES, ids=lambda s: "G%d-K%d" % s)
@pytest.mark.parametrize("case", PRODUCT_MASKS)
@pytest.mark.parametrize("m", [S, 2 * S, 4 * S, 8 * S])
def test_product_butterfly_on_host_matches_plain(host_lib, butterfly_planes,
                                                 m, case, shape, order):
    """product_class_body, a block per residue class with groups of G
    threads taking K lanes a wave, against product_plain raw on M = 128 …
    1024 lanes (at 128 no level runs: the masked input), with the threads
    of each phase and the groups of each level in ``order``."""
    f, mask, want = butterfly_planes(m, case)
    out = np.zeros((384, m), np.int32)
    assert host_lib.host_product(f.ctypes.data, mask.ctypes.data,
                                 out.ctypes.data, m, *shape,
                                 ORDERS[order]) == 0
    assert np.array_equal(out, want)
