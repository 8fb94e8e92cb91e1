"""The port's shared-key batch verify against the JAX package, on the CPU.

Marshalling is byte for byte the JAX package's; the whole slice (8 sets
under the same 5 keys, ``fast_aggregate_verify``'s shape) gives the JAX
package's ``PythonBackend`` verdict for the valid batch and for each
tamper class; batches off the shared path (distinct keys, fewer than
``LIGHTHOUSE_TPU_SHARED_MIN`` sets) verify on the general path, and the
default entry raises without a GPU.
"""

import numpy as np
import pytest
import torch

from lighthouse_tpu.crypto import bls as JB
from lighthouse_tpu.crypto import htc_kernel as JHK
from lighthouse_tpu.crypto import tpu_backend as JTB
from lighthouse_tpu_torch import device
from lighthouse_tpu_torch.crypto import bls, fields as F
from lighthouse_tpu_torch.crypto import htc_kernel as HK
from lighthouse_tpu_torch.crypto import tpu_backend as TB

# The tests here are about the device path: keep small batches off the
# native host fast path.
pytestmark = pytest.mark.usefixtures("pin_device_path")

N_SETS, N_KEYS = 8, 5


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
def batch():
    """8 sets, each signed by the sum of the same 5 secret keys (the
    bench.py construction, at a small size)."""
    rng = np.random.default_rng(12)
    sks = [int(rng.integers(1, 2 ** 63)) for _ in range(N_KEYS)]
    pks = [bls.SecretKey(k).public_key() for k in sks]
    signer = bls.SecretKey(sum(sks) % F.R)
    msgs = [b"sync-comm-%03d" % i for i in range(N_SETS)]
    return [bls.SignatureSet(signer.sign(m), list(pks), m) for m in msgs]


def _rand(seed: int):
    rng = np.random.default_rng(seed)
    return lambda: int(rng.integers(1, 2 ** 64, dtype=np.uint64))


def _entries(sets):
    return [(None if s.signature is None else s.signature.point,
             [k.point for k in s.signing_keys], bytes(s.message))
            for s in sets]


def test_marshalling_matches_jax_byte_for_byte(batch):
    entries = _entries(batch)
    entries[2] = (None, entries[2][1], entries[2][2])    # a missing signature
    ours = TB._rlc_message_sig_columns(entries, 2, _rand(5))
    theirs = JTB._rlc_message_sig_columns(entries, 2, _rand(5))
    assert len(ours) == len(theirs) == 7
    for a, b in zip(ours, theirs):
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
    for s in batch[:3]:
        assert TB._g2_aff_col(s.signature.point) == \
            JTB._g2_aff_col(s.signature.point)
        assert TB._g1_aff_col(s.signing_keys[0].point) == \
            JTB._g1_aff_col(s.signing_keys[0].point)
        assert HK._u_cols(s.message) == JHK._u_cols(s.message)
    msgs = [(0, 3, b"a"), (1, 0, b"b")]
    assert np.array_equal(HK.u_planes_for_messages(msgs, 2),
                          JHK.u_planes_for_messages(msgs, 2))


def _python_verdict(sets) -> bool:
    return JB.PythonBackend().verify_signature_sets(sets)


def test_valid_batch_verifies_on_the_jax_packages_bytes(batch, monkeypatch):
    """The valid batch verifies, like PythonBackend; the columns the
    device tail ran on equal the JAX package's marshalling of the batch."""
    seen = {}
    real = TB.verify_shared_columns

    def spy(*cols, **kw):
        seen["cols"] = cols
        return real(*cols, **kw)

    monkeypatch.setattr(TB, "verify_shared_columns", spy)
    assert TB.TpuBackend().verify_signature_sets(batch, rand_fn=_rand(7))
    assert _python_verdict(batch) is True
    entries, ok = JTB._dedup_shared_keygroups(_entries(batch))
    assert ok
    (_c, lo, hi, u, sig, sigmask, setlive) = JTB._rlc_message_sig_columns(
        entries, 1, _rand(7))
    pk_col = np.zeros((64, 256), np.uint32)
    pk_col[:, 0] = np.frombuffer(JTB._g1_aff_col(entries[0][1][0]), np.uint32)
    pk_col[:, 1] = np.frombuffer(TB._g1_aff_col(TB.C.g1_neg(TB.C.G1_GEN)),
                                 np.uint32)
    for ours, theirs in zip(seen["cols"],
                            (pk_col, u, sig, sigmask, setlive, lo, hi)):
        assert ours.tobytes() == theirs.tobytes()
    assert TB.LAST_FAST_AGG_TIMINGS["path"] == "cuda_shared"


@pytest.mark.parametrize("tamper", ["swapped_signature", "altered_message"])
def test_tampered_batch_fails_like_python_backend(batch, tamper):
    bad = list(batch)
    if tamper == "swapped_signature":   # a key swap is a no-op here
        bad[3] = bls.SignatureSet(batch[4].signature, batch[3].signing_keys,
                                  batch[3].message)
    else:
        bad[5] = bls.SignatureSet(batch[5].signature, batch[5].signing_keys,
                                  batch[5].message + b"!")
    assert TB.TpuBackend().verify_signature_sets(bad, rand_fn=_rand(8)) \
        is False
    assert _python_verdict(bad) is False


def test_missing_signature_and_empty_batch_fail(batch):
    bad = list(batch)
    bad[1] = bls.SignatureSet(bls.Signature(None), batch[1].signing_keys,
                              batch[1].message)
    backend = TB.TpuBackend()
    assert backend.verify_signature_sets(bad) is False
    assert _python_verdict(bad) is False
    assert backend.verify_signature_sets([]) is False
    assert _python_verdict([]) is False


def test_batches_off_the_shared_path_raise(batch):
    """Batches off the shared path no longer raise: each verifies on the
    general path with ``PythonBackend``'s verdict — 8 sets under distinct
    single keys (the signatures belong to the 5-key sum, so False), and 4
    sets under the shared 5 keys, fewer than SHARED_MIN (True)."""
    distinct = [bls.SignatureSet(s.signature, [s.signing_keys[i % N_KEYS]],
                                 s.message) for i, s in enumerate(batch)]
    backend = TB.TpuBackend()
    assert backend.verify_signature_sets(distinct, rand_fn=_rand(3)) \
        is _python_verdict(distinct) is False
    assert TB.LAST_PIPELINE_STATS["path"] == "cuda_general"
    assert backend.verify_signature_sets(batch[:4], rand_fn=_rand(4)) \
        is _python_verdict(batch[:4]) is True              # < SHARED_MIN
    assert TB.LAST_PIPELINE_STATS["sets"] == 4
    assert bls._BACKENDS["tpu"].name == "tpu"


def test_default_entry_is_the_device_backend(batch, monkeypatch):
    """``bls.verify_signature_sets`` runs on the ``tpu`` backend unless a
    caller selects another: off the shared path it takes the general
    path, and without a GPU (the default device ``cuda``) it raises
    before any verifying."""
    monkeypatch.setattr(bls, "_active", None)
    assert bls.get_backend() is bls._BACKENDS["tpu"]
    distinct = [bls.SignatureSet(s.signature, [s.signing_keys[i % N_KEYS]],
                                 s.message) for i, s in enumerate(batch)]
    routed = []
    monkeypatch.setattr(TB, "_dispatch_general",
                        lambda entries, rand_fn: routed.append(entries) or True)
    assert bls.verify_signature_sets(distinct) is True
    assert [e[2] for e in routed[0]] == [s.message for s in distinct]
    device.set_default_device("cuda")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    called = []
    monkeypatch.setattr(TB, "_dispatch", lambda *a, **k: called.append(a))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bls.verify_signature_sets(batch)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bls.verify_signature_sets([])
    assert not called
