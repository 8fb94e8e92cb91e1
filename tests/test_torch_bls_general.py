"""The port's general BLS batch verify against the JAX package, on the CPU.

- The plain versions of the four kernels the general path adds (prepare,
  product_chunks, miller, product) and the widened finalize against the
  host oracles of the JAX package (the curve law, Fq12 arithmetic, the
  pairing and its cubed final exponentiation), with the edge lanes: a set
  whose keys are P and −P, masked key slots, dead lanes.  (The JAX
  package's own kernels are Pallas programs; driven eagerly their ladders
  take minutes here, so the host oracles hold both packages.)
- ``_marshal_group``, ``_split_batches`` and the device pubkey table
  byte for byte against the JAX package's.
- Whole batches through ``TpuBackend`` (the plain versions, on the CPU)
  against the JAX package's ``PythonBackend`` verdict: valid and each
  tamper class, a mixed-K batch whose finalize takes 256 lanes, and
  ``verify`` / ``aggregate_verify``.
"""

import numpy as np
import pytest
import torch

from lighthouse_tpu.crypto import bls as JB
from lighthouse_tpu.crypto import curve as JC
from lighthouse_tpu.crypto import fields as JF
from lighthouse_tpu.crypto import pairing as JPAIR
from lighthouse_tpu.crypto import tpu_backend as JTB
from lighthouse_tpu_torch import device
from lighthouse_tpu_torch.crypto import bls
from lighthouse_tpu_torch.crypto import fields as F
from lighthouse_tpu_torch.crypto import limb_field as LF
from lighthouse_tpu_torch.crypto import pairing_kernel as PK
from lighthouse_tpu_torch.crypto import tpu_backend as TB

# The tests here are about the device path: keep small batches off the
# native host fast path.
pytestmark = pytest.mark.usefixtures("pin_device_path")

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


def _i32(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a).view(np.int32).copy())


def _canon(planes: torch.Tensor, k: int, lane: int) -> list:
    arr = planes.numpy()
    return [LF.from_mont(arr[32 * b:32 * b + 26, lane].astype(np.uint64))
            for b in range(k)]


def _fq12_of(planes: torch.Tensor, lane: int):
    c = _canon(planes, 12, lane)
    return tuple(tuple((c[(i * 3 + j) * 2], c[(i * 3 + j) * 2 + 1])
                       for j in range(3)) for i in range(2))


def _fq12_col(v) -> np.ndarray:
    """Host Fq12 → (384,) Montgomery block column."""
    col = np.zeros(384, np.uint32)
    flat = [c for c6 in v for c2 in c6 for c in c2]
    for b, c in enumerate(flat):
        col[32 * b:32 * b + 26] = LF.to_mont(c % F.P)
    return col


def _rand_fq12(rng):
    return tuple(tuple((int(rng.integers(0, 2 ** 62)) ** 6 % F.P,
                        int(rng.integers(0, 2 ** 62)) ** 6 % F.P)
                       for _ in range(3)) for _ in range(2))


# ---------------------------------------------------------------------------
# The kernels' plain versions against the host oracles
# ---------------------------------------------------------------------------

def test_prepare_plain_matches_host_curve():
    """K = 4, two chunks: live sets with masked slots (garbage under the
    mask), a set whose keys are P and −P (flag 1, (0, 0)), a dead lane
    with a nonzero scalar and plain dead lanes (flag 1, (0, 0))."""
    K, chunks = 4, 2
    rng = np.random.default_rng(31)
    pts = [JC.g1_mul(JC.G1_GEN, int(rng.integers(1, 2 ** 62)))
           for _ in range(6)]
    pk = np.zeros((64, chunks * K * S), np.uint32)
    kmask = np.zeros((1, chunks * K * S), np.int32)
    lo = np.zeros((1, chunks * S), np.uint32)
    hi = np.zeros((1, chunks * S), np.uint32)

    def put(lane, k, p):
        col = (lane // S) * K * S + k * S + lane % S
        pk[:, col] = np.frombuffer(TB._g1_aff_col(p), np.uint32)
        kmask[0, col] = 1

    sets = {0: [(0, pts[0]), (1, pts[1])],             # keys 2, 3 masked
            9: [(0, pts[2]), (3, pts[3])],             # slots 1, 2 masked
            S + 5: [(1, pts[4]), (2, pts[5]), (3, pts[0])],
            S + 40: [(0, pts[1]), (2, JC.g1_neg(pts[1]))]}   # P + (−P)
    scalars = {0: 2 ** 64 - 1, 9: 12345678901, S + 5: 2 ** 63 + 7,
               S + 40: 99, 17: 5}                      # 17: dead, scalar
    for lane, keys in sets.items():
        for k, p in keys:
            put(lane, k, p)
    for lane, c in scalars.items():
        lo[0, lane], hi[0, lane] = c & 0xFFFFFFFF, c >> 32
    pk[:, 2 * S + 0] = 0xBEEF               # set 0, key slot 2: masked
    g1, flags = PK.prepare_kernel_call(_i32(pk), _i32(kmask), _i32(lo),
                                       _i32(hi), K)
    assert g1.shape == (64, chunks * S) and flags.shape == (1, chunks * S)
    for lane in (0, 9, S + 5):
        agg = None
        for _k, p in sets[lane]:
            agg = JC.g1_add(agg, p)
        assert tuple(_canon(g1, 2, lane)) == JC.g1_mul(agg, scalars[lane])
        assert int(flags[0, lane]) == 0
    for lane in (S + 40, 17, 1, S + 127):
        assert int(flags[0, lane]) == 1
        assert _canon(g1, 2, lane) == [0, 0]
    assert int(flags.sum()) == chunks * S - 3


def test_product_chunks_and_product_plain_match_host_fq12():
    rng = np.random.default_rng(32)
    m = 512
    f = np.zeros((384, m), np.uint32)
    vals = {}
    for lane in (0, 128, 256, 384, 5, 133, 261, 389, 77):
        vals[lane] = _rand_fq12(rng)
        f[:, lane] = _fq12_col(vals[lane])
    mask = np.ones((1, m), np.int32)
    mask[0, 389] = 0                                   # masked → 1
    fp, mp = _i32(f), _i32(mask)

    def val(lane):
        return vals.get(lane, (JF.FQ6_ZERO, JF.FQ6_ZERO)) if mask[0, lane] else JF.FQ12_ONE

    chunks = PK.product_chunks_kernel_call(fp, mp)
    assert chunks.shape == (384, m // 2)
    for c, j in ((0, 0), (1, 0), (0, 5), (1, 5), (0, 77), (1, 9)):
        want = JF.fq12_mul(val(c * 256 + j), val(c * 256 + 128 + j))
        assert _fq12_of(chunks, c * 128 + j) == want
    prod = PK.product_kernel_call(fp, mp)
    assert prod.shape == (384, m)
    for j in (0, 5):
        want = JF.FQ12_ONE
        for r in range(4):
            want = JF.fq12_mul(want, val(r * 128 + j))
        for r in range(4):          # every lane of the class holds it
            assert _fq12_of(prod, r * 128 + j) == want
    with pytest.raises(ValueError):
        PK.product_kernel_call(fp[:, :384], mp[:, :384])
    with pytest.raises(ValueError):
        PK.product_chunks_kernel_call(fp[:, :384], mp[:, :384])


@pytest.fixture(scope="module")
def miller_lanes():
    """128 lanes: (P, Q) at lane 0, (−P, Q) at lane 1, (P2, Q2) at lane 2;
    the rest zero inputs."""
    rng = np.random.default_rng(33)
    P = JC.g1_mul(JC.G1_GEN, int(rng.integers(1, 2 ** 62)))
    Q = JC.g2_mul(JC.G2_GEN, int(rng.integers(1, 2 ** 62)))
    P2 = JC.g1_mul(JC.G1_GEN, int(rng.integers(1, 2 ** 62)))
    Q2 = JC.g2_mul(JC.G2_GEN, int(rng.integers(1, 2 ** 62)))
    g1 = np.zeros((64, S), np.uint32)
    g2 = np.zeros((128, S), np.uint32)
    for lane, (p, q) in enumerate(((P, Q), (JC.g1_neg(P), Q), (P2, Q2))):
        g1[:, lane] = np.frombuffer(TB._g1_aff_col(p), np.uint32)
        g2[:, lane] = np.frombuffer(TB._g2_aff_col(q), np.uint32)
    f = PK.miller_kernel_call(_i32(g1), _i32(g2))
    return f, (P2, Q2)


def test_miller_plain_matches_host_pairing(miller_lanes):
    f, (P2, Q2) = miller_lanes
    assert f.shape == (384, S)
    fe3 = JPAIR.final_exponentiation_cubed
    assert fe3(JF.fq12_mul(_fq12_of(f, 0), _fq12_of(f, 1))) == JF.FQ12_ONE
    assert fe3(_fq12_of(f, 2)) == fe3(JPAIR.miller_loop(P2, Q2))
    assert torch.equal(f[:, 3], f[:, 100])           # equal inputs


def test_finalize_takes_any_power_of_two_lanes(miller_lanes, monkeypatch):
    """256 lanes: product_chunks folds them to 128 first.  Lanes 0 and
    128 hold e(P, Q) and e(−P, Q), the rest 1: the product is 1; with
    e(P2, Q2) in place of one lane it is not, and the value is the host's
    cubed final exponentiation."""
    f, _ = miller_lanes
    one = torch.from_numpy(TB._ONE_BLOCK.view(np.int32))
    wide = torch.cat([one, one], 1)
    wide[:, 0], wide[:, 128] = f[:, 0], f[:, 1]
    widths = []
    real = PK.product_chunks_kernel_call
    monkeypatch.setattr(PK, "product_chunks_kernel_call",
                        lambda x, m: widths.append(x.shape[1]) or real(x, m))
    assert int(PK.finalize_kernel_call(wide)) == 1
    assert widths == [256]
    wide[:, 128] = f[:, 2]
    ok, g = PK.finalize_kernel_call(wide, with_value=True)
    assert int(ok) == 0
    want = JPAIR.final_exponentiation_cubed(
        JF.fq12_mul(_fq12_of(f, 0), _fq12_of(f, 2)))
    assert _fq12_of(g, 0) == want
    with pytest.raises(ValueError):
        PK.finalize_kernel_call(torch.cat([one, one, one], 1))


# ---------------------------------------------------------------------------
# Marshalling, the work split and the pubkey table against the JAX package
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def keys():
    rng = np.random.default_rng(34)
    sks = [int(rng.integers(1, 2 ** 62)) for _ in range(12)]
    return sks, [bls.SecretKey(k).public_key() for k in sks]


def _rand(seed: int):
    rng = np.random.default_rng(seed)
    return lambda: int(rng.integers(1, 2 ** 64, dtype=np.uint64))


def _entries(sets):
    return [(None if s.signature is None else s.signature.point,
             [k.point for k in s.signing_keys], bytes(s.message))
            for s in sets]


def _signed(sks, pks, members, msg):
    agg = bls.SecretKey(sum(sks[i] for i in members) % F.R)
    return bls.SignatureSet(agg.sign(msg), [pks[i] for i in members], msg)


def test_marshal_group_and_split_match_jax(keys, monkeypatch):
    sks, pks = keys
    sets = [_signed(sks, pks, [(3 * i + j) % 12 for j in range(1 + i % 3)],
                    b"m-%d" % (i % 4)) for i in range(7)]
    entries = _entries(sets)
    entries[4] = (None, entries[4][1], entries[4][2])   # no signature
    monkeypatch.setattr(TB, "_PK_TABLE", TB._DevicePubkeyTable())
    monkeypatch.setattr(JTB, "_PK_TABLE", JTB._DevicePubkeyTable())
    for group in (entries, entries[:3], [entries[5]]):
        ours = TB._marshal_group(group, _rand(6))
        theirs = JTB._marshal_group(group, _rand(6))
        assert ours[-1] == theirs[-1]                   # K
        for a, b in zip(ours[:-1], theirs[:-1]):
            assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
    assert TB._PK_TABLE._index == JTB._PK_TABLE._index
    signed = _entries(sets)
    for knob in ("2", "0", ""):
        monkeypatch.setenv("LIGHTHOUSE_TPU_PIPELINE_SETS", knob)
        for batch in (signed, entries):
            assert TB._split_batches(batch) == JTB._split_batches(batch)
    monkeypatch.setenv("LIGHTHOUSE_TPU_PIPELINE_SETS", "2")
    assert [len(w) for w in TB._split_batches(signed)] == [2, 1, 2, 2]
    assert [len(w) for w in TB._split_batches(entries)] == [3, 2, 2]


def test_pubkey_table_matches_jax(keys):
    """The same index_of / maybe_reset / device() sequence at initial = 4
    and max_keys = 8: growth while the device copy exists, eviction of
    the least-recently-used half, re-registration after it."""
    _sks, pks = keys
    ours = TB._DevicePubkeyTable(initial=4, max_keys=8)
    theirs = JTB._DevicePubkeyTable(initial=4, max_keys=8)
    script = [[0, 1], "dev", [2, 3, 1], "dev", [4, 5, 6], "reset", [0, 7],
              "reset", [8, 9, 0], "dev", "reset", [10, 3, 11], "dev"]
    for step in script:
        if step == "reset":
            ours.maybe_reset()
            theirs.maybe_reset()
        elif step == "dev":
            assert np.array_equal(ours.device().numpy().view(np.uint32),
                                  np.asarray(theirs.device()))
        else:
            got = [ours.index_of(pks[i].point) for i in step]
            assert got == [theirs.index_of(pks[i].point) for i in step]
        assert ours._n == theirs._n and ours._index == theirs._index
        assert np.array_equal(ours._host, theirs._host)
    assert ours._host.shape[1] == 8 and ours.device().shape[1] == 8


# ---------------------------------------------------------------------------
# Whole batches on the general path against PythonBackend
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def batch(keys):
    """6 sets of 3 or 4 keys (one K = 4 work item), 3 messages."""
    sks, pks = keys
    return [_signed(sks, pks, [(2 * i + j) % 12 for j in range(3 + i % 2)],
                    b"att-%d" % (i % 3)) for i in range(6)]


def _python_verdict(sets) -> bool:
    return JB.PythonBackend().verify_signature_sets(sets)


def _tampered(batch, keys, tamper):
    sks, pks = keys
    bad = list(batch)
    if tamper == "wrong_signature":
        bad[2] = bls.SignatureSet(batch[3].signature, batch[2].signing_keys,
                                  batch[2].message)
    elif tamper == "altered_message":
        bad[4] = bls.SignatureSet(batch[4].signature, batch[4].signing_keys,
                                  batch[4].message + b"!")
    elif tamper == "swapped_key":       # bench.py's tamper
        bad[1] = bls.SignatureSet(batch[1].signature, batch[2].signing_keys,
                                  batch[1].message)
    elif tamper == "identity_aggregate_key":
        negs = [bls.PublicKey(JC.g1_neg(pks[i].point)) for i in (5, 7)]
        bad[3] = bls.SignatureSet(batch[3].signature,
                                  [pks[5], pks[7]] + negs, batch[3].message)
    elif tamper == "empty":
        bad = []
    return bad


@pytest.mark.parametrize("tamper", [
    "valid", "wrong_signature", "altered_message", "swapped_key",
    "identity_aggregate_key", "empty"])
def test_general_batch_verdict_equals_python_backend(batch, keys, tamper,
                                                     monkeypatch):
    sets = _tampered(batch, keys, tamper)
    bads = []
    real = TB.fused_pipeline_body

    def spy(*a, **kw):
        out = real(*a, **kw)
        bads.append(bool(out[1]))
        return out

    monkeypatch.setattr(TB, "fused_pipeline_body", spy)
    got = TB.TpuBackend().verify_signature_sets(sets, rand_fn=_rand(9))
    assert got is _python_verdict(sets) is (tamper == "valid")
    if tamper == "empty":
        assert bads == []
        return
    assert TB.LAST_PIPELINE_STATS["path"] == "cuda_general"
    assert TB.LAST_PIPELINE_STATS["dispatches"] == 1
    assert bads == [tamper == "identity_aggregate_key"]


def test_mixed_k_batch_finalizes_256_lanes(batch, keys, monkeypatch):
    """Two K groups (1 and 4) are two work items: their two (384, 128)
    products make the finalize's 256 lanes."""
    sks, pks = keys
    sets = batch[:3] + [_signed(sks, pks, [i], b"proposer-%d" % i)
                        for i in (9, 10)]
    widths = []
    real = PK.finalize_kernel_call
    monkeypatch.setattr(PK, "finalize_kernel_call",
                        lambda f: widths.append(f.shape[1]) or real(f))
    assert TB.TpuBackend().verify_signature_sets(sets, rand_fn=_rand(10))
    assert _python_verdict(sets) is True
    assert widths == [256]
    assert TB.LAST_PIPELINE_STATS["dispatches"] == 2


def test_verify_and_aggregate_verify_match_python_backend(keys):
    sks, pks = keys
    backend, oracle = TB.TpuBackend(), JB.PythonBackend()
    msg = b"single"
    sig = bls.SecretKey((sks[0] + sks[1]) % F.R).sign(msg)
    assert backend.verify(sig, [pks[0], pks[1]], msg) is True
    assert oracle.verify(sig, [pks[0], pks[1]], msg) is True
    assert TB.LAST_PIPELINE_STATS["sets"] == 1
    msgs = [b"agg-%d" % i for i in range(3)]
    agg = None
    for i, m in zip((2, 3, 4), msgs):
        agg = JC.g2_add(agg, bls.SecretKey(sks[i]).sign(m).point)
    agg = bls.Signature(agg)
    trio = [pks[2], pks[3], pks[4]]
    assert backend.aggregate_verify(agg, trio, msgs) is True
    assert oracle.aggregate_verify(agg, trio, msgs) is True
    assert TB.LAST_PIPELINE_STATS["dispatches"] == 1
    assert backend.aggregate_verify(agg, trio, msgs[:2]) is False
    assert backend.verify(bls.Signature(None), trio, msg) is False
