"""The port's KZG (``lighthouse_tpu_torch/kzg``) on the CPU, against the
JAX package's ``lighthouse_tpu/kzg``.

- The Fr host helpers, roots of unity, Fiat-Shamir and the barycentric
  oracle equal the JAX package's on seeded inputs.
- ``fr_limb``'s add / sub / mont_mul / select / is_zero equal the JAX
  package's limb for limb on a few hundred seeded elements (zeros, lazy
  values up to 2N, the k·N zeros), and ``inv`` is ``pow(x, r - 2, r)``
  with 0 → 0.
- ``eval_blobs`` through the plain version equals the host oracle at W =
  4 and W = 64 (random blobs, an in-domain challenge, the zero blob, a
  blob of r - 1), and its Montgomery core equals the JAX package's
  ``_eval_kernel`` limb for limb at W = 4.
- The kernel's field core (``csrc/kzg_fr.cuh``, which compiles as plain
  C++ too) built with g++ gives the oracle's values on the same cases.
- The pinned vectors of ``tests/test_kzg.py`` reproduce; the embedded
  setup equals its regeneration and the loader rejects junk.
- Single and batch host verification give the JAX package's verdicts
  (and its ``KzgError`` cases); the card's route through the kernels'
  plain versions (``verify_blob_kzg_proof_batch_device`` on the CPU
  device) gives the JAX host fold's verdicts on a valid, a swapped and a
  zero-blob batch.
- Sidecar inclusion branches equal the JAX package's at the MINIMAL and
  MAINNET depths, and a tampered branch fails.
"""

import ctypes
import random
import shutil
import subprocess

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from lighthouse_tpu.kzg import device as JD
from lighthouse_tpu.kzg import fr as jfr
from lighthouse_tpu.kzg import fr_limb as JFL
from lighthouse_tpu.kzg import kzg as JK
from lighthouse_tpu.kzg import trusted_setup as JTS
from lighthouse_tpu_torch import device
from lighthouse_tpu_torch.kzg import device as D
from lighthouse_tpu_torch.kzg import fr
from lighthouse_tpu_torch.kzg import fr_limb as FL
from lighthouse_tpu_torch.kzg import kzg as K
from lighthouse_tpu_torch.kzg import trusted_setup as TS

from tests import test_kzg as V

N = fr.BLS_MODULUS
SETUP = TS.embedded_setup(4)
JSETUP = JTS.embedded_setup(4)


@pytest.fixture(autouse=True, scope="module")
def _cpu():
    prev, threads = device.default_device(), torch.get_num_threads()
    device.set_default_device("cpu")
    torch.set_num_threads(1)
    yield
    device.set_default_device(prev)
    torch.set_num_threads(threads)


# -- Fr host helpers -----------------------------------------------------------

@pytest.mark.parametrize("width", [1, 2, 4, 64, 4096])
def test_roots_of_unity_equal_the_reference(width):
    assert fr.compute_roots_of_unity(width) == \
        jfr.compute_roots_of_unity(width)


def test_fr_host_helpers_equal_the_reference():
    rng = random.Random(0)
    xs = [0, 1, N - 1] + [rng.randrange(N) for _ in range(20)]
    for x in xs:
        b = fr.bls_field_to_bytes(x)
        assert b == jfr.bls_field_to_bytes(x)
        assert fr.bytes_to_bls_field(b) == jfr.bytes_to_bls_field(b) == x
    for data in (b"", b"abc", bytes(range(200))):
        assert fr.hash_to_bls_field(data) == jfr.hash_to_bls_field(data)
    assert fr.compute_powers(xs[5], 9) == jfr.compute_powers(xs[5], 9)
    for bad in (N.to_bytes(32, "big"), b"\xff" * 32, b"\x00" * 31):
        with pytest.raises(fr.FrError):
            fr.bytes_to_bls_field(bad)
        with pytest.raises(jfr.FrError):
            jfr.bytes_to_bls_field(bad)
    for width in (3, 0):
        with pytest.raises(fr.FrError):
            fr.compute_roots_of_unity(width)


def test_barycentric_oracle_equals_the_reference():
    rng = random.Random(1)
    for width in (4, 64):
        roots = fr.compute_roots_of_unity(width)
        evals = [rng.randrange(N) for _ in range(width)]
        for z in (rng.randrange(N), roots[3], N + 5):
            assert fr.evaluate_polynomial_in_evaluation_form(
                evals, z, roots) == jfr.evaluate_polynomial_in_evaluation_form(
                evals, z, roots)


# -- fr_limb, limb for limb ----------------------------------------------------

def _limb_operands():
    rng = random.Random(2)
    xs = [rng.randrange(2 * N) for _ in range(300)]
    ys = [rng.randrange(2 * N) for _ in range(300)]
    xs[:3] = [0, N, 2 * N - 1]
    ys[3:6] = [0, N - 1, N]
    a = np.stack([JFL.int_to_limbs(x) for x in xs])
    b = np.stack([JFL.int_to_limbs(y) for y in ys])
    return a, b


@pytest.mark.parametrize("op", ["add", "sub", "mont_mul"])
def test_fr_limb_binary_ops_equal_the_reference(op):
    a, b = _limb_operands()
    want = np.asarray(getattr(JFL, op)(jnp.asarray(a), jnp.asarray(b)))
    got = getattr(FL, op)(torch.from_numpy(a.astype(np.int64)),
                          torch.from_numpy(b.astype(np.int64)))
    assert (got.numpy() == want.astype(np.int64)).all()


def test_fr_limb_select_and_is_zero_equal_the_reference():
    a, b = _limb_operands()
    mask = np.random.default_rng(3).random(len(a)) < 0.5
    want = np.asarray(JFL.select(jnp.asarray(mask), jnp.asarray(a),
                                 jnp.asarray(b)))
    got = FL.select(torch.from_numpy(mask), torch.from_numpy(
        a.astype(np.int64)), torch.from_numpy(b.astype(np.int64)))
    assert (got.numpy() == want.astype(np.int64)).all()
    z = np.concatenate([np.stack([JFL.int_to_limbs(k * N) for k in range(4)]),
                        a[3:40]])
    assert (np.asarray(JFL.is_zero(jnp.asarray(z))) ==
            FL.is_zero(torch.from_numpy(z.astype(np.int64))).numpy()).all()


def test_fr_limb_inv_and_montgomery_form():
    rng = random.Random(4)
    xs = [0, 1, N - 1] + [rng.randrange(N) for _ in range(5)]
    limbs = FL.to_mont_array(xs)
    assert (limbs == JFL.to_mont_array(xs).astype(np.int64)).all()
    assert list(FL.from_mont_array(limbs)) == xs
    got = FL.from_mont_array(FL.inv(torch.from_numpy(limbs)).numpy())
    assert list(got) == [pow(x, N - 2, N) for x in xs]
    assert got[0] == 0
    canon = torch.from_numpy(np.stack([FL.int_to_limbs(x) for x in xs]))
    assert (FL.to_mont_t(canon).numpy() == limbs).all()
    assert (FL.from_mont_t(torch.from_numpy(limbs)).numpy()
            == canon.numpy()).all()


# -- the barycentric evaluation --------------------------------------------

def _eval_case(width: int, seed: int):
    rng = random.Random(seed)
    roots = fr.compute_roots_of_unity(width)
    polys = [[rng.randrange(N) for _ in range(width)] for _ in range(4)]
    polys[1] = [0] * width
    polys[2] = [N - 1] * width
    zs = [rng.randrange(N), roots[width // 2], rng.randrange(N), roots[0]]
    return polys, zs, roots


@pytest.mark.parametrize("width", [4, 64])
def test_eval_blobs_plain_equals_the_oracle(width):
    polys, zs, roots = _eval_case(width, 5)
    setup = TS.verification_setup(width)
    got = D.eval_blobs([K.polynomial_to_blob(p) for p in polys], zs, setup)
    assert got == [jfr.evaluate_polynomial_in_evaluation_form(p, z, roots)
                   for p, z in zip(polys, zs)]
    assert D.LAUNCHES["kzg_eval"] == 0      # the CPU runs the plain version


def test_eval_core_equals_the_reference_program_limb_for_limb():
    """``eval_mont_plain`` against the JAX package's jitted
    ``_eval_kernel`` at W = 4 (its CPU compile takes ~13 s here)."""
    polys, zs, roots = _eval_case(4, 6)
    args = [JFL.to_mont_array(x) for x in (polys, zs, roots)]
    want = np.asarray(JD._eval_kernel(*[jnp.asarray(a) for a in args], 4))
    got = D.eval_mont_plain(*[torch.from_numpy(a.astype(np.int64))
                              for a in args], 4)
    assert (got.numpy() == want.astype(np.int64)).all()


def test_blob_words_and_validation_equal_the_reference():
    polys, _, _ = _eval_case(4, 7)
    blobs = [K.polynomial_to_blob(p) for p in polys]
    words = D.blob_words(blobs, 4)
    assert D.words_ints(words.reshape(-1, 8)) == [v for p in polys for v in p]
    assert D.words_ints(D.ints_words([0, 1, N - 1])) == [0, 1, N - 1]
    assert D.words_ints(D.mont_words([0, 1, N - 1])) == [
        0, 2 ** 256 % N, (N - 1) * 2 ** 256 % N]
    good = blobs[0]
    cases = [good[:32] + N.to_bytes(32, "big") + good[64:],
             b"\xff" * 128, good[:96], good + b"\x00"]
    for bad in cases:
        with pytest.raises(K.KzgError) as mine:
            D.blob_words([good, bad], 4)
        with pytest.raises(JK.KzgError) as ref:
            JK.validate_blob(bad, 4)
        assert str(mine.value) == str(ref.value)


_SHIM = r"""
#include "kzg_fr.cuh"
extern "C" void host_eval(const uint32_t* f, const uint32_t* z_mont,
                          const uint32_t* roots, uint32_t* out, long long B,
                          long long W, int log2w) {
  for (long long b = 0; b < B; ++b) {
    Fr zm = fr_load(z_mont + b * 8);
    Fr sum = fr_zero(), fh = fr_zero();
    bool any = false;
    for (long long j = 0; j < W; ++j) {
      bool hit;
      Fr fj = fr_load(f + (b * W + j) * 8);
      sum = fr_add(sum, kzg_term(fj, fr_load(roots + j * 8), zm, &hit));
      if (hit) { fh = fr_add(fh, fj); any = true; }
    }
    fr_store(out + b * 8, kzg_finish(sum, fh, any, zm, log2w));
  }
}
extern "C" void host_mul_chain(const uint32_t* xy, uint32_t* out, int n) {
  Fr x = fr_load(xy), y = fr_load(xy + 8);
  for (int k = 0; k < n; ++k) x = fr_mul(x, y);
  fr_store(out, x);
}
"""


@pytest.fixture(scope="module")
def field_core(tmp_path_factory):
    """``csrc/kzg_fr.cuh`` built with g++ as host code, with a loop over a
    blob's elements in the kernel's per-element and finishing steps."""
    import os
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("no g++ on this machine")
    d = tmp_path_factory.mktemp("kzg_shim")
    (d / "shim.cpp").write_text(_SHIM)
    csrc = os.path.join(os.path.dirname(D.__file__), os.pardir, "csrc")
    subprocess.run([gxx, "-O1", "-std=c++17", "-shared", "-fPIC", "-I", csrc,
                    "-o", str(d / "shim.so"), str(d / "shim.cpp")],
                   check=True, capture_output=True)
    lib = ctypes.CDLL(str(d / "shim.so"))
    p = ctypes.c_void_p
    lib.host_eval.argtypes = [p, p, p, p, ctypes.c_longlong,
                              ctypes.c_longlong, ctypes.c_int]
    lib.host_mul_chain.argtypes = [p, p, ctypes.c_int]
    return lib


@pytest.mark.parametrize("width", [1, 4, 64])
def test_kernel_field_core_equals_the_oracle(field_core, width):
    polys, zs, roots = _eval_case(width, 8)
    f = D.blob_words([K.polynomial_to_blob(p) for p in polys], width)
    z, r = D.mont_words(zs), D.mont_words(roots)
    out = np.zeros((len(polys), 8), np.uint32)
    field_core.host_eval(f.ctypes.data, z.ctypes.data, r.ctypes.data,
                         out.ctypes.data, len(polys), width,
                         width.bit_length() - 1)
    assert D.words_ints(out) == [
        jfr.evaluate_polynomial_in_evaluation_form(p, zz, roots)
        for p, zz in zip(polys, zs)]


def test_kernel_product_chain_equals_its_plain_version(field_core):
    rng = random.Random(9)
    x, y = rng.randrange(N), rng.randrange(N)
    xy = D.ints_words([x, y])
    out = np.zeros((1, 8), np.uint32)
    field_core.host_mul_chain(xy.ctypes.data, out.ctypes.data, 64)
    assert D.words_ints(out) == [D.fr_mul_chain_plain(x, y, 64)]


# -- pinned vectors, setup -----------------------------------------------------

def test_pinned_challenge_evaluation_commitment_and_proof():
    evals = K.blob_to_polynomial(V.BLOB, 4)
    z = K.compute_challenge(V.BLOB, V.COMMITMENT, 4)
    assert z == V.Z
    assert fr.evaluate_polynomial_in_evaluation_form(
        evals, z, SETUP.roots) == V.Y
    assert D.eval_blobs([V.BLOB], [z], SETUP) == [V.Y]
    assert K.blob_to_kzg_commitment(V.BLOB, SETUP) == V.COMMITMENT
    assert K.compute_blob_kzg_proof(V.BLOB, V.COMMITMENT, SETUP) == V.PROOF
    assert K.blob_to_kzg_commitment(V.BLOB2, SETUP) == V.COMMITMENT2
    assert K.compute_blob_kzg_proof(V.BLOB2, V.COMMITMENT2, SETUP) == V.PROOF2


def test_embedded_setup_matches_regeneration_and_the_reference():
    regen = TS.dump_trusted_setup(TS.generate_insecure_setup(4))
    assert regen == TS.EMBEDDED_MINIMAL_JSON == JTS.EMBEDDED_MINIMAL_JSON
    assert TS.INSECURE_TAU == JTS.INSECURE_TAU
    assert SETUP.g1_lagrange == JSETUP.g1_lagrange
    assert SETUP.g2_monomial == JSETUP.g2_monomial
    assert TS.verification_setup(4).g2_monomial == SETUP.g2_monomial


def _off_subgroup_g1() -> bytes:
    """A compressed G1 point on the curve but outside the r-order
    subgroup (the smallest x that gives one)."""
    from lighthouse_tpu_torch.crypto import curve as C, fields as F
    x = 1
    while True:
        y = F.fq_sqrt((x ** 3 + 4) % F.P)
        if y is not None and not C.g1_subgroup_check((x, y)):
            return C.g1_compress((x, y))
        x += 1


def test_setup_loader_rejects_junk():
    good = __import__("json").loads(TS.EMBEDDED_MINIMAL_JSON)
    g1, g2 = good["g1_lagrange"], good["g2_monomial"]
    off = "0x" + _off_subgroup_g1().hex()
    for junk in ({"g1_lagrange": [], "g2_monomial": []},
                 {"g2_monomial": g2},
                 {"g1_lagrange": g1, "g2_monomial": g2[:1]},
                 {"g1_lagrange": g1[:3], "g2_monomial": g2},
                 {"g1_lagrange": [off] + g1[1:], "g2_monomial": g2},
                 {"g1_lagrange": g1, "g2_monomial": g2[::-1]}):
        with pytest.raises(TS.SetupError):
            TS.load_trusted_setup(junk)
        with pytest.raises(JTS.SetupError):
            JTS.load_trusted_setup(junk)
    assert TS.load_trusted_setup(good).g1_lagrange == SETUP.g1_lagrange


# -- host verification ---------------------------------------------------------

# case → (blob, commitment, proof), the verdict
_SINGLE = {
    "valid": ((V.BLOB, V.COMMITMENT, V.PROOF), True),
    "valid2": ((V.BLOB2, V.COMMITMENT2, V.PROOF2), True),
    "wrong_proof": ((V.BLOB, V.COMMITMENT, V.PROOF2), False),
    "wrong_commitment": ((V.BLOB, V.COMMITMENT2, V.PROOF), False),
    "out_of_subgroup_commitment": ((V.BLOB, V.OUT_OF_SUBGROUP, V.PROOF),
                                   "KzgError"),
    "out_of_subgroup_proof": ((V.BLOB, V.COMMITMENT, V.OUT_OF_SUBGROUP),
                              "KzgError"),
    "off_subgroup_commitment": ((V.BLOB, _off_subgroup_g1(), V.PROOF),
                                "KzgError"),
    "non_canonical": (((N).to_bytes(32, "big") + V.BLOB[32:], V.COMMITMENT,
                       V.PROOF), "KzgError"),
}


def _verdict(fn, *args):
    try:
        return bool(fn(*args))
    except (K.KzgError, JK.KzgError) as e:
        return type(e).__name__


@pytest.mark.parametrize("case", sorted(_SINGLE))
def test_single_verify_equals_the_reference(case):
    (b, c, p), verdict = _SINGLE[case]
    got = _verdict(K.verify_blob_kzg_proof, b, c, p, SETUP)
    want = _verdict(JK.verify_blob_kzg_proof, b, c, p, JSETUP)
    assert got == want == verdict


_BATCHES = {
    "valid": ([V.BLOB, V.BLOB2], [V.COMMITMENT, V.COMMITMENT2],
              [V.PROOF, V.PROOF2]),
    "swapped": ([V.BLOB, V.BLOB2], [V.COMMITMENT, V.COMMITMENT2],
                [V.PROOF2, V.PROOF]),
    "wrong_commitment": ([V.BLOB, V.BLOB2], [V.COMMITMENT2, V.COMMITMENT2],
                         [V.PROOF, V.PROOF2]),
    "out_of_subgroup": ([V.BLOB], [V.OUT_OF_SUBGROUP], [V.PROOF]),
    "off_subgroup": ([V.BLOB, V.BLOB2], [V.COMMITMENT, _off_subgroup_g1()],
                     [V.PROOF, V.PROOF2]),
    "non_canonical": ([V.BLOB, b"\xff" * 128], [V.COMMITMENT, V.COMMITMENT2],
                      [V.PROOF, V.PROOF2]),
    "length_mismatch": ([V.BLOB], [V.COMMITMENT, V.COMMITMENT2], [V.PROOF]),
    "empty": ([], [], []),
}


@pytest.mark.parametrize("case", sorted(_BATCHES))
def test_batch_host_verify_equals_the_reference(case):
    args = _BATCHES[case]
    got = _verdict(K.verify_blob_kzg_proof_batch, *args, SETUP)
    want = _verdict(JK.verify_blob_kzg_proof_batch, *args, JSETUP, False)
    assert got == want
    assert got == _verdict(K.verify_blob_kzg_proof_batch_host, *args, SETUP)


# -- the card's route through the plain versions -------------------------------

@pytest.fixture(scope="module")
def card_route():
    """Three 2-blob batches through the card's route on the CPU device
    (evaluation, Miller+fold and finalize as plain versions), each with
    the JAX host fold's verdict and the route's stage split."""
    zero = bytes(128)
    cz = K.blob_to_kzg_commitment(zero, SETUP)
    pz = K.compute_blob_kzg_proof(zero, cz, SETUP)
    assert cz == pz == b"\xc0" + bytes(47)     # the point at infinity
    batches = {
        "valid": _BATCHES["valid"],
        "swapped": _BATCHES["swapped"],
        "zero_blob": ([V.BLOB, zero], [V.COMMITMENT, cz], [V.PROOF, pz]),
    }
    out = {}
    for name, args in batches.items():
        got = D.verify_blob_kzg_proof_batch_device(*args, SETUP)
        want = JK.verify_blob_kzg_proof_batch(*args, JSETUP, use_device=False)
        out[name] = (got, want, dict(D.LAST_KZG_TIMINGS))
    return out


@pytest.mark.parametrize("case,verdict", [("valid", True),
                                          ("swapped", False),
                                          ("zero_blob", True)])
def test_card_route_plain_versions_give_the_host_fold_verdicts(
        card_route, case, verdict):
    got, want, stages = card_route[case]
    assert got is verdict and want is verdict
    assert stages["blobs"] == 2 and stages["lanes"] == 256
    assert set(stages) == {"blobs", "lanes", "challenge_ms", "eval_ms",
                           "lane_prep_ms", "pairing_ms"}


def test_lane_planes_place_each_blob_on_a_folded_pair():
    from lighthouse_tpu_torch.crypto import curve as C
    a = [C.g1_mul(C.G1_GEN, 3), None, C.g1_mul(C.G1_GEN, 5)]
    b = [C.G1_GEN, None, None]
    g1, mask = D.lane_planes(a, b)
    assert g1.shape == (64, 256) and mask.shape == (1, 256)
    assert np.flatnonzero(mask[0]).tolist() == [0, 2, 128]
    g1, mask = D.lane_planes([C.G1_GEN] * 129, [C.G1_GEN] * 129)
    assert g1.shape[1] == 512
    assert np.flatnonzero(mask[0]).tolist() == (
        list(range(256)) + [256, 384])


def test_eval_wrapper_checks_its_inputs():
    f = torch.zeros((2, 4, 8), dtype=torch.int32)
    z = torch.zeros((2, 8), dtype=torch.int32)
    roots = torch.zeros((4, 8), dtype=torch.int32)
    with pytest.raises(ValueError):
        D.eval_kernel_call(f.to(torch.int64), z, roots)
    with pytest.raises(ValueError):
        D.eval_kernel_call(f, z[:1], roots)
    with pytest.raises(ValueError):
        D.eval_kernel_call(f[:, :3], z, roots[:3])
    with pytest.raises(ValueError):
        D.eval_kernel_call(f.to("meta"), z.to("meta"), roots.to("meta"))


# -- sidecar inclusion proofs ----------------------------------------------

@pytest.mark.parametrize("preset_name", ["MINIMAL", "MAINNET"])
def test_inclusion_branches_equal_the_reference(preset_name):
    import importlib
    branches, verdicts = [], []
    for pkg in ("lighthouse_tpu", "lighthouse_tpu_torch"):
        presets = importlib.import_module(f"{pkg}.types.presets")
        factory = importlib.import_module(f"{pkg}.types.factory")
        inc = importlib.import_module(f"{pkg}.kzg.inclusion")
        preset = getattr(presets, preset_name)
        T = factory.spec_types(preset)
        body = T.BeaconBlockBodyDeneb()
        body.blob_kzg_commitments = [bytes([i + 1]) * 48 for i in range(3)]
        body.graffiti = b"\x07" * 32
        hdr = T.BeaconBlockHeader(slot=9, proposer_index=1,
                                  body_root=body.tree_hash_root())
        got, ok = [], []
        for i in range(3):
            branch = inc.blob_sidecar_inclusion_proof(body, i, preset)
            got.append([bytes(x) for x in branch])
            sc = T.BlobSidecar(
                index=i, kzg_commitment=body.blob_kzg_commitments[i],
                signed_block_header=T.SignedBeaconBlockHeader(message=hdr),
                kzg_commitment_inclusion_proof=branch)
            ok.append(inc.verify_blob_sidecar_inclusion_proof(sc, preset))
            sc.kzg_commitment_inclusion_proof[2] = b"\x99" * 32
            ok.append(inc.verify_blob_sidecar_inclusion_proof(sc, preset))
        assert len(got[0]) == preset.KZG_COMMITMENT_INCLUSION_PROOF_DEPTH
        branches.append(got)
        verdicts.append(ok)
    assert branches[0] == branches[1]
    assert verdicts[0] == verdicts[1] == [True, False] * 3
