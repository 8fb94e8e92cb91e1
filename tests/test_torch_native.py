"""The port's native host library (``crypto/native.py``) and the routes that
use it, on the CPU.

The library is the repository's ``native/bls381.cpp``, built by g++ into
``build/native/`` once per worker.  Its calls must equal, exactly, the
port's pure-Python group law and pairing (run with
``LIGHTHOUSE_TPU_NO_NATIVE=1`` where a route is compared with itself), the
RFC 9380 vectors, and the JAX package's own native calls on the same
points.  ``TpuBackend`` sends batches of up to
``LIGHTHOUSE_TPU_HOST_FASTPATH_MAX`` sets to the host and gives the JAX
package's ``PythonBackend`` verdicts; above the knob (or at 0) the batch
goes to the device path, which a stand-in ``_dispatch`` records.
"""

import numpy as np
import pytest

from lighthouse_tpu.crypto import bls as JB
from lighthouse_tpu.crypto import native as JN
from lighthouse_tpu_torch import device
from lighthouse_tpu_torch.crypto import bls
from lighthouse_tpu_torch.crypto import curve as C
from lighthouse_tpu_torch.crypto import fields as F
from lighthouse_tpu_torch.crypto import hash_to_curve as H2C
from lighthouse_tpu_torch.crypto import native
from lighthouse_tpu_torch.crypto import pairing as PR
from lighthouse_tpu_torch.crypto import tpu_backend as TB

RFC_DST = b"QUUX-V01-CS02-with-BLS12381G2_XMD:SHA-256_SSWU_RO_"
# RFC 9380 J.10.1 (the vectors of tests/test_external_vectors.py): message
# → affine ((x_c0, x_c1), (y_c0, y_c1)).
RFC_H2C = {
    b"": (
        ("0141ebfbdca40eb85b87142e130ab689c673cf60f1a3e98d69335266f30d9b8d"
         "4ac44c1038e9dcdd5393faf5c41fb78a",
         "05cb8437535e20ecffaef7752baddf98034139c38452458baeefab379ba13dff"
         "5bf5dd71b72418717047f5b0f37da03d"),
        ("0503921d7f6a12805e72940b963c0cf3471c7b2a524950ca195d11062ee75ec0"
         "76daf2d4bc358c4b190c0c98064fdd92",
         "12424ac32561493f3fe3c260708a12b7c620e7be00099a974e259ddc7d1f6395"
         "c3c811cdd19f1e8dbf3e9ecfdcbab8d6")),
    b"abc": (
        ("02c2d18e033b960562aae3cab37a27ce00d80ccd5ba4b7fe0e7a210245129dbe"
         "c7780ccc7954725f4168aff2787776e6",
         "139cddbccdc5e91b9623efd38c49f81a6f83f175e80b06fc374de9eb4b41dfe4"
         "ca3a230ed250fbe3a2acf73a41177fd8"),
        ("1787327b68159716a37440985269cf584bcb1e621d3a7202be6ea05c4cfe244a"
         "eb197642555a0645fb87bf7466b2ba48",
         "00aa65dae3c8d732d10ecd2c50f8a1baf3001578f71c694e03866e9f3d49ac1e"
         "1ce70dd94a733534f106d4cec0eddd16")),
    b"abcdef0123456789": (
        ("121982811d2491fde9ba7ed31ef9ca474f0e1501297f68c298e9f4c0028add35"
         "aea8bb83d53c08cfc007c1e005723cd0",
         "190d119345b94fbd15497bcba94ecf7db2cbfd1e1fe7da034d26cbba169fb396"
         "8288b3fafb265f9ebd380512a71c3f2c"),
        ("05571a0f8d3c08d094576981f4a3b8eda0a8e771fcdcc8ecceaf1356a6acf175"
         "74518acb506e435b639353c2e14827c8",
         "0bb5e7572275c567462d91807de765611490205a941a5a6af3b1691bfe596c31"
         "225d3aabdf15faff860cb4ef17c7c3be")),
}


@pytest.fixture(scope="module", autouse=True)
def built():
    """The port's library, built (or loaded) once per worker; the JAX
    package's for the cross-checks."""
    assert native.available(block=True)
    assert JN.available()


@pytest.fixture
def pure(monkeypatch):
    """The pure-Python host path (the independent oracle)."""
    monkeypatch.setenv("LIGHTHOUSE_TPU_NO_NATIVE", "1")


def _scalars(seed: int, n: int, bits: int = 255) -> list:
    rng = np.random.default_rng(seed)
    return [int.from_bytes(rng.bytes(32), "big") % (1 << bits) % F.R or 1
            for _ in range(n)]


def _g1_chain(seed: int, n: int) -> list:
    """n G1 points P, P + Q, P + 2Q, ... (one affine add each)."""
    p, q = (C.g1_mul(C.G1_GEN, s) for s in _scalars(seed, 2))
    out = [p]
    for _ in range(n - 1):
        out.append(C.g1_add(out[-1], q))
    return out


def _fold(points):
    acc = None
    for p in points:
        acc = C.g1_add(acc, p)
    return acc


@pytest.mark.parametrize("n", [1, 16, 17, 512])
def test_g1_aggregate_equals_python_fold_and_jax_native(n):
    pts = _g1_chain(n, n)
    want = _fold(pts)
    assert native.g1_aggregate(pts) == want
    assert JN.g1_aggregate(pts) == want


def test_g1_aggregate_of_p_and_minus_p_is_none():
    p, q = _g1_chain(3, 2)
    assert native.g1_aggregate([p, C.g1_neg(p)]) is None
    assert JN.g1_aggregate([p, C.g1_neg(p)]) is None
    assert native.g1_aggregate([p, q, C.g1_neg(p)]) == q


@pytest.mark.parametrize("n", [16, 40])
def test_aggregate_points_native_and_pure_agree(n, monkeypatch):
    pts = _g1_chain(100 + n, n)
    calls = []
    real = native.g1_aggregate
    monkeypatch.setattr(native, "g1_aggregate",
                        lambda p: calls.append(len(p)) or real(p))
    got = bls.aggregate_points(pts)
    assert calls == [n]                  # 16 points or more: native
    monkeypatch.setenv("LIGHTHOUSE_TPU_NO_NATIVE", "1")
    assert bls.aggregate_points(pts) == got == _fold(pts)
    assert calls == [n]                  # the knob keeps it in Python
    assert bls.aggregate_points(pts[:15]) == _fold(pts[:15])


def _pairs(seed: int, n: int) -> list:
    a, b = _scalars(seed, 2 * n)[:n], _scalars(seed + 1, n)
    return [(C.g1_mul(C.G1_GEN, x), C.g2_mul(C.G2_GEN, y))
            for x, y in zip(a, b)]


@pytest.mark.parametrize("n", [1, 2, 3])
def test_multi_pairing_gt_equals_python_cubed(n):
    pairs = _pairs(10 + n, n)
    acc = F.FQ12_ONE
    for p, q in pairs:
        acc = F.fq12_mul(acc, PR.miller_loop(p, q))
    want = PR.final_exponentiation_cubed(acc)
    assert native.multi_pairing_gt(pairs) == want
    assert JN.multi_pairing_gt(pairs) == want


def test_multi_pairing_is_one_valid_and_tampered():
    sk = bls.SecretKey(987654321)
    sig = sk.sign(b"native check")
    pk = sk.public_key().point
    good = [(C.g1_neg(C.G1_GEN), sig.point),
            (pk, H2C.hash_to_g2_python(b"native check"))]
    bad = [good[0], (pk, H2C.hash_to_g2_python(b"tampered"))]
    assert native.multi_pairing_is_one(good)
    assert not native.multi_pairing_is_one(bad)
    # the route: identity pairs dropped, the rest native
    assert PR.multi_pairing_is_one(good + [(None, good[0][1])])
    assert not PR.multi_pairing_is_one(bad)


@pytest.mark.parametrize("msg", list(RFC_H2C), ids=["empty", "abc", "abcdef"])
def test_hash_to_g2_u_rfc_vectors_and_python_curve_half(msg, monkeypatch):
    u0, u1 = H2C.hash_to_field_fq2(msg, 2, RFC_DST)
    (x0, x1), (y0, y1) = native.hash_to_g2_u(u0, u1)
    ex, ey = RFC_H2C[msg]
    assert (format(x0, "096x"), format(x1, "096x")) == ex
    assert (format(y0, "096x"), format(y1, "096x")) == ey
    assert H2C.hash_to_g2(msg, RFC_DST) == ((x0, x1), (y0, y1))
    monkeypatch.setenv("LIGHTHOUSE_TPU_NO_NATIVE", "1")
    assert H2C.hash_to_g2(msg, RFC_DST) == ((x0, x1), (y0, y1))
    assert H2C.hash_to_g2_python(msg, RFC_DST) == ((x0, x1), (y0, y1))


@pytest.mark.parametrize("scalar", [1, 2, (1 << 64) - 1, F.R - 1, 0])
def test_g2_mul_equals_curve_g2_mul(scalar):
    q = C.g2_mul(C.G2_GEN, 0xC0FFEE)
    assert native.g2_mul(q, scalar) == C.g2_mul(q, scalar)


def test_signing_native_equals_python(pure, monkeypatch):
    sk = bls.SecretKey(_scalars(7, 1)[0])
    want = sk.sign(b"slot 7")          # NO_NATIVE: the curve oracle
    monkeypatch.delenv("LIGHTHOUSE_TPU_NO_NATIVE")
    assert native.ready()
    assert sk.sign(b"slot 7") == want


def test_ready_honours_the_knob(monkeypatch):
    assert native.ready()
    monkeypatch.setenv("LIGHTHOUSE_TPU_NO_NATIVE", "1")
    assert not native.ready()
    monkeypatch.setenv("LIGHTHOUSE_TPU_NO_NATIVE", "0")
    assert native.ready()


def test_failed_build_raises_with_compiler_output(tmp_path, monkeypatch):
    """A source g++ refuses: ``available(block=True)`` and then ``ready()``
    raise with the compiler's message instead of answering False."""
    bad = tmp_path / "bls381.cpp"
    bad.write_text("this is not C++\n")
    (tmp_path / "bls381_consts.h").write_text("")
    monkeypatch.setattr(native, "_SRC", str(bad))
    monkeypatch.setattr(native, "_HDR", str(tmp_path / "bls381_consts.h"))
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_error", None)
    monkeypatch.setattr(native, "_building", None)
    with pytest.raises(native.NativeBuildError, match="not C"):
        native.available(block=True)
    with pytest.raises(native.NativeBuildError, match="failed"):
        native.ready()
    assert not list((tmp_path / "build").glob("*.so*"))


def test_library_builds_outside_native_dir():
    path = native.library_path()
    assert path.startswith(native.BUILD_DIR)
    assert "/build/native/libbls381-" in path


# ---------------------------------------------------------------------------
# The host fast path of TpuBackend
# ---------------------------------------------------------------------------

@pytest.fixture
def on_cpu():
    prev = device.default_device()
    device.set_default_device("cpu")
    yield
    device.set_default_device(prev)


@pytest.fixture
def routes(monkeypatch, on_cpu):
    """Every batch that reaches the device path is recorded (and answered
    with a marker verdict) instead of run."""
    seen = []

    def fake_dispatch(entries, rand_fn):
        seen.append(len(entries))
        return "device"

    monkeypatch.setattr(TB, "_dispatch", fake_dispatch)
    return seen


def _sets(seed: int, n: int, tamper: bool):
    """n single-message sets, each under its own 2 keys; ``tamper`` alters
    the last set's message.  Port and JAX package objects of the same
    sets."""
    sks = _scalars(seed, 2 * n)
    out, jout = [], []
    for i in range(n):
        msg = b"set %d of %d" % (i, seed)
        a, b = bls.SecretKey(sks[2 * i]), bls.SecretKey(sks[2 * i + 1])
        sig = bls.Signature(C.g2_add(a.sign(msg).point, b.sign(msg).point))
        keys = [a.public_key(), b.public_key()]
        if tamper and i == n - 1:
            msg = msg + b"!"
        out.append(bls.SignatureSet(sig, keys, msg))
        jout.append(JB.SignatureSet(JB.Signature(sig.point),
                                    [JB.PublicKey(k.point) for k in keys],
                                    msg))
    return out, jout


@pytest.mark.parametrize("tamper", [False, True], ids=["valid", "tampered"])
@pytest.mark.parametrize("n", [1, 2, 3, 4])
def test_host_fast_path_gives_python_backend_verdicts(n, tamper, routes):
    sets, jsets = _sets(20 + n, n, tamper)
    want = JB.PythonBackend().verify_signature_sets(jsets)
    assert want is (not tamper)
    assert TB.TpuBackend().verify_signature_sets(sets) is want
    assert routes == []                 # never reached the device path


def test_host_fast_path_verify_and_aggregate_verify(routes):
    sets, jsets = _sets(31, 2, False)
    s, js = sets[0], jsets[0]
    backend = TB.TpuBackend()
    assert backend.verify(s.signature, s.signing_keys, s.message) is True
    assert backend.verify(s.signature, s.signing_keys, b"other") is False
    sks = _scalars(32, 3)
    msgs = [b"m%d" % i for i in range(3)]
    pks = [bls.SecretKey(k).public_key() for k in sks]
    agg = None
    for k, m in zip(sks, msgs):
        agg = C.g2_add(agg, bls.SecretKey(k).sign(m).point)
    sig = bls.Signature(agg)
    jwant = JB.PythonBackend().aggregate_verify(
        JB.Signature(agg), [JB.PublicKey(p.point) for p in pks], msgs)
    assert jwant is True
    assert backend.aggregate_verify(sig, pks, msgs) is True
    assert backend.aggregate_verify(sig, pks, msgs[::-1]) is False
    assert routes == []


@pytest.mark.parametrize("knob,n,device_calls", [
    ("0", 1, 1), ("0", 4, 1), ("4", 5, 1), ("8", 5, 0), (None, 4, 0)])
def test_fast_path_knob_routes(knob, n, device_calls, routes, monkeypatch):
    if knob is None:
        monkeypatch.delenv("LIGHTHOUSE_TPU_HOST_FASTPATH_MAX", raising=False)
    else:
        monkeypatch.setenv("LIGHTHOUSE_TPU_HOST_FASTPATH_MAX", knob)
    sets, _ = _sets(40 + n, n, False)
    got = TB.TpuBackend().verify_signature_sets(sets)
    assert len(routes) == device_calls
    assert got == ("device" if device_calls else True)


def test_no_native_keeps_small_batches_on_the_device_path(routes, pure):
    sets, _ = _sets(50, 2, False)
    assert TB.TpuBackend().verify_signature_sets(sets) == "device"
    assert routes == [2]


def test_entry_points_raise_without_a_gpu_before_the_host_path(
        monkeypatch):
    """The default device is cuda: with no GPU even a batch the host would
    take raises (the first statement of each entry is ``get_device``)."""
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    prev = device.default_device()
    device.set_default_device("cuda")
    try:
        sets, _ = _sets(60, 1, False)
        s = sets[0]
        backend = TB.TpuBackend()
        for call in (lambda: backend.verify_signature_sets(sets),
                     lambda: backend.verify(s.signature, s.signing_keys,
                                            s.message),
                     lambda: backend.aggregate_verify(
                         s.signature, s.signing_keys[:1], [s.message])):
            with pytest.raises(RuntimeError, match="no CUDA device"):
                call()
    finally:
        device.set_default_device(prev)
