"""The PyTorch port imports without JAX or the JAX package (its BLS
modules included), and its device defaults to cuda: with no GPU a device
call raises instead of running on the CPU.

Each check runs in a fresh interpreter with ``jax`` and ``lighthouse_tpu``
blocked in ``sys.modules`` (the mirror of ``tests/test_imports.py``).
"""

import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_BLOCK = ('import sys\n'
          'sys.modules["jax"] = None\n'
          'sys.modules["lighthouse_tpu"] = None\n')


def _run(code: str) -> subprocess.CompletedProcess:
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    return subprocess.run([sys.executable, "-c", _BLOCK + code], cwd=REPO,
                          env=env, capture_output=True, text=True,
                          timeout=120)


def test_every_port_module_imports_without_jax():
    proc = _run(
        "import importlib, pkgutil\n"
        "import lighthouse_tpu_torch as pkg\n"
        "names = [m.name for m in pkgutil.walk_packages(\n"
        "    pkg.__path__, 'lighthouse_tpu_torch.')]\n"
        "for name in names:\n"
        "    importlib.import_module(name)\n"
        "assert 'jax' not in {k.split('.')[0] for k, v in sys.modules.items()\n"
        "                      if v is not None}\n"
        "print(len(names))\n")
    assert proc.returncode == 0, proc.stderr
    assert int(proc.stdout.strip()) >= 30


def test_chip_smoke_imports_nothing_of_jax():
    """chip_smoke.py's imports resolve with JAX blocked; without a GPU
    it exits non-zero before printing a result line."""
    assert os.path.exists(os.path.join(REPO, "chip_smoke.py"))
    proc = subprocess.run(
        [sys.executable, "-c",
         _BLOCK + "import runpy\n"
                  "runpy.run_path('chip_smoke.py', run_name='__main__')\n"],
        cwd=REPO, env=dict(os.environ, CUDA_VISIBLE_DEVICES=""),
        capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout
    assert "ModuleNotFoundError" not in proc.stderr, proc.stderr
    assert "ImportError" not in proc.stderr, proc.stderr


_DEVICE_CALLS = [
    "device.get_device()",
    "merkle_kernel.merkle_root_chunked(np.zeros((1024, 8), np.uint32), 10)",
    "merkle.merkleize(np.zeros((8192, 8), np.uint32), 13)",
    "device_tree.DeviceTree.from_host_leaves(np.zeros((8, 8), np.uint32))",
    "tpu_backend.verify_shared_columns(*[np.zeros((64, 256), np.uint32)] * 7)",
    "tpu_backend.TpuBackend().verify_signature_sets([])",
    "compile_cache.warmup()",
    "pipeline.ChunkStager([np.zeros(8, np.uint32)])",
    "device_proto_array.DeviceProtoArrayForkChoice().compute_deltas("
    "np.zeros(4, np.uint64))",
    "device_pack.greedy_pack_device(np.array([1]), np.array([32]), "
    "np.array([0, 1]), 64, 4)",
    "kzg_device.eval_blobs([bytes(128)], [0], kzg_ts.embedded_setup(4))",
    "kzg_kzg.verify_blob_kzg_proof_batch([bytes(128)], [b'\\xc0' + "
    "bytes(47)], [b'\\xc0' + bytes(47)], kzg_ts.embedded_setup(4))",
]


@pytest.fixture(scope="module")
def device_call_outcomes() -> dict:
    """Each of ``_DEVICE_CALLS`` on the default device, in one fresh
    interpreter with no GPU visible: call → "raised" or what went wrong."""
    proc = _run(
        "import numpy as np\n"
        "from lighthouse_tpu_torch import device\n"
        "from lighthouse_tpu_torch.ops import device_tree, merkle, "
        "merkle_kernel\n"
        "from lighthouse_tpu_torch.crypto import tpu_backend\n"
        "from lighthouse_tpu_torch.common import compile_cache\n"
        "from lighthouse_tpu_torch.parallel import pipeline\n"
        "from lighthouse_tpu_torch.fork_choice import device_proto_array\n"
        "from lighthouse_tpu_torch.op_pool import device_pack\n"
        "from lighthouse_tpu_torch.kzg import device as kzg_device, "
        "kzg as kzg_kzg, trusted_setup as kzg_ts\n"
        "assert device.default_device().type == 'cuda'\n"
        f"for call in {_DEVICE_CALLS!r}:\n"
        "    try:\n"
        "        eval(call)\n"
        "        print('ran')\n"
        "    except RuntimeError as e:\n"
        "        print('raised' if 'no CUDA device' in str(e) else repr(e))\n")
    assert proc.returncode == 0, proc.stderr
    return dict(zip(_DEVICE_CALLS, proc.stdout.splitlines()))


@pytest.mark.parametrize("call", _DEVICE_CALLS)
def test_default_device_is_cuda_and_raises_without_gpu(call,
                                                      device_call_outcomes):
    assert device_call_outcomes.get(call) == "raised"


# The modules the native library, device ledger, chunk stager and proof
# engine slice added, then those of the block-import slice, then those of
# the beacon-chain slice, then those of the block-production slice, then
# those of the data-availability slice.
_NEW_MODULES = [
    "lighthouse_tpu_torch.crypto.native",
    "lighthouse_tpu_torch.common.device_ledger",
    "lighthouse_tpu_torch.common.metrics",
    "lighthouse_tpu_torch.common.compile_cache",
    "lighthouse_tpu_torch.ops.merkle_proof",
    "lighthouse_tpu_torch.ops.proof_engine",
    "lighthouse_tpu_torch.parallel.pipeline",
    "lighthouse_tpu_torch.common.safe_arith",
    "lighthouse_tpu_torch.common.tracing",
    "lighthouse_tpu_torch.state_transition",
    "lighthouse_tpu_torch.state_transition.helpers",
    "lighthouse_tpu_torch.state_transition.shuffle",
    "lighthouse_tpu_torch.state_transition.committees",
    "lighthouse_tpu_torch.state_transition.mutations",
    "lighthouse_tpu_torch.state_transition.signature_sets",
    "lighthouse_tpu_torch.state_transition.per_epoch",
    "lighthouse_tpu_torch.state_transition.per_epoch_device",
    "lighthouse_tpu_torch.state_transition.upgrade",
    "lighthouse_tpu_torch.state_transition.per_block",
    "lighthouse_tpu_torch.state_transition.sig_dispatch",
    "lighthouse_tpu_torch.state_transition.per_slot",
    "lighthouse_tpu_torch.state_transition.genesis",
    "lighthouse_tpu_torch.beacon_chain",
    "lighthouse_tpu_torch.beacon_chain.errors",
    "lighthouse_tpu_torch.beacon_chain.observed",
    "lighthouse_tpu_torch.beacon_chain.block_verification",
    "lighthouse_tpu_torch.testing",
    "lighthouse_tpu_torch.testing.harness",
    "lighthouse_tpu_torch.fork_choice",
    "lighthouse_tpu_torch.fork_choice.proto_array",
    "lighthouse_tpu_torch.fork_choice.columnar",
    "lighthouse_tpu_torch.fork_choice.device_proto_array",
    "lighthouse_tpu_torch.fork_choice.fork_choice",
    "lighthouse_tpu_torch.fork_choice.persistence",
    "lighthouse_tpu_torch.store",
    "lighthouse_tpu_torch.store.kv",
    "lighthouse_tpu_torch.store.migrations",
    "lighthouse_tpu_torch.store.hot_cold",
    "lighthouse_tpu_torch.store.recovery",
    "lighthouse_tpu_torch.state_transition.block_replayer",
    "lighthouse_tpu_torch.state_transition.batch_replay",
    "lighthouse_tpu_torch.op_pool",
    "lighthouse_tpu_torch.op_pool.max_cover",
    "lighthouse_tpu_torch.op_pool.persistence",
    "lighthouse_tpu_torch.beacon_chain.events",
    "lighthouse_tpu_torch.beacon_chain.attester_cache",
    "lighthouse_tpu_torch.beacon_chain.attestation_verification",
    "lighthouse_tpu_torch.beacon_chain.data_availability",
    "lighthouse_tpu_torch.beacon_chain.chain",
    "lighthouse_tpu_torch.common.slo",
    "lighthouse_tpu_torch.op_pool.device_pack",
    "lighthouse_tpu_torch.common.logging",
    "lighthouse_tpu_torch.validator_client",
    "lighthouse_tpu_torch.validator_client.slashing_protection",
    "lighthouse_tpu_torch.validator_client.signing",
    "lighthouse_tpu_torch.validator_client.store",
    "lighthouse_tpu_torch.validator_client.beacon_node",
    "lighthouse_tpu_torch.validator_client.services",
    "lighthouse_tpu_torch.kzg",
    "lighthouse_tpu_torch.kzg.fr",
    "lighthouse_tpu_torch.kzg.fr_limb",
    "lighthouse_tpu_torch.kzg.trusted_setup",
    "lighthouse_tpu_torch.kzg.kzg",
    "lighthouse_tpu_torch.kzg.inclusion",
    "lighthouse_tpu_torch.kzg.device",
]


@pytest.fixture(scope="module")
def new_module_imports() -> dict:
    """Each of ``_NEW_MODULES`` imported in one fresh interpreter with
    JAX blocked: module → "ok" when it imported, pulled in no JAX, and
    built or started building nothing (no native library loaded or
    building, no CUDA library loaded)."""
    proc = _run(
        "import importlib\n"
        f"for name in {_NEW_MODULES!r}:\n"
        "    try:\n"
        "        importlib.import_module(name)\n"
        "        print('ok')\n"
        "    except Exception as e:\n"
        "        print(repr(e))\n"
        "from lighthouse_tpu_torch.crypto import native\n"
        "from lighthouse_tpu_torch.ops import cuda_build\n"
        "assert native._lib is None and native._building is None\n"
        "assert not cuda_build._LOADED\n"
        "assert 'jax' not in {k.split('.')[0] for k, v in sys.modules.items()\n"
        "                      if v is not None}\n")
    assert proc.returncode == 0, proc.stderr
    return dict(zip(_NEW_MODULES, proc.stdout.splitlines()))


@pytest.mark.parametrize("module", _NEW_MODULES)
def test_new_modules_import_without_jax_and_build_nothing(
        module, new_module_imports):
    assert new_module_imports.get(module) == "ok"
