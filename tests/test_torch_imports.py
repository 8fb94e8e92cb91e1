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
