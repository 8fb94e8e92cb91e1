"""Build and load the port's CUDA kernels (nvcc → plain-C ``.so`` → ctypes).

The kernels compile from the sources under ``lighthouse_tpu_torch/csrc``
at their first use, into ``build/kernels/`` at the repository root (git
ignores it), with

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -Xptxas -v -o lib<name>-<hash>.so <name>.cu

The file name carries a hash of the source and of the headers it
includes, so an edited kernel never loads a stale build, and an edited
header rebuilds only the sources that include it.
:func:`build_all` starts one ``nvcc`` per source at once and waits for
all of them.  Each build that runs is a ``compiles`` event of the device
ledger, each finished build that loads a ``compile_hits`` event.  Nothing here runs at import time: this module is imported
on machines with no ``nvcc`` and no GPU, where only the plain versions of
the kernels run.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import time

from ..common.device_ledger import LEDGER

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "kernels")

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

# name → (loaded CDLL, .so path, seconds the build took, ptxas report)
_LOADED: dict[str, tuple] = {}

# The ledger subsystem each library's builds are charged to.
_SUBSYSTEM = {"sha256_merkle": "device_tree", "bls381": "bls",
              "bls381_phases": "bls", "kzg_fr": "kzg"}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(cuda_home, "bin", "nvcc")
    if os.path.exists(path):
        return path
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin, "
                       "/usr/local/cuda/bin): the CUDA kernels cannot be "
                       "built on this machine")


_INCLUDE = re.compile(r'^\s*#\s*include\s+"([^"]+)"', re.M)


def _sources(name: str) -> list[str]:
    """``<name>.cu`` and the ``csrc`` headers it includes, directly or
    through another header (``#include "..."``)."""
    todo, seen = [name + ".cu"], []
    while todo:
        src = todo.pop()
        if src in seen:
            continue
        seen.append(src)
        with open(os.path.join(CSRC, src)) as fh:
            todo += _INCLUDE.findall(fh.read())
    return seen


def library_path(name: str) -> str:
    """Where the build of ``csrc/<name>.cu`` lives for its current source
    and the headers it includes."""
    h = hashlib.sha256()
    for src in _sources(name):
        with open(os.path.join(CSRC, src), "rb") as fh:
            h.update(fh.read())
    return os.path.join(BUILD_DIR, f"lib{name}-{h.hexdigest()[:16]}.so")


def build_all(names) -> dict[str, tuple[float, str]]:
    """Compile every ``csrc/<name>.cu`` whose build is missing, one nvcc
    process per source, all started together.  Returns name → (build
    seconds, ptxas report) for each source it compiled."""
    running = []
    for name in names:
        out = library_path(name)
        if os.path.exists(out):
            continue
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{out}.tmp{os.getpid()}"
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp,
               os.path.join(CSRC, name + ".cu")]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.PIPE, text=True)
        running.append((name, proc, time.perf_counter(), tmp, out))
    built, failed = {}, []
    for name, proc, t0, tmp, out in running:
        stdout, stderr = proc.communicate()
        took = time.perf_counter() - t0
        if proc.returncode != 0:
            if os.path.exists(tmp):
                os.unlink(tmp)
            failed.append(f"nvcc failed on {name}.cu (rc {proc.returncode})"
                          f":\n{stdout}\n{stderr}")
            continue
        os.replace(tmp, out)
        built[name] = (took, stdout + stderr)
        LEDGER.note_compile(_SUBSYSTEM.get(name))
    if failed:
        raise RuntimeError("\n".join(failed))
    return built


def build(name: str) -> tuple[str, float, str]:
    """Compile ``csrc/<name>.cu`` if its build is missing.  Returns
    ``(so path, build seconds, ptxas report)`` (0 s and "" when reused)."""
    took, report = build_all([name]).get(name, (0.0, ""))
    return library_path(name), took, report


def load(name: str, signatures: dict) -> ctypes.CDLL:
    """Build (if needed) and load ``csrc/<name>.cu``, binding each C entry
    of ``signatures`` (entry → argtypes; every entry returns a CUDA error
    code as ``int``)."""
    got = _LOADED.get(name)
    if got is not None:
        return got[0]
    path, took, report = build(name)
    if not took:
        LEDGER.note_compile(_SUBSYSTEM.get(name), key="compile_hits")
    lib = ctypes.CDLL(path)
    for entry, argtypes in signatures.items():
        fn = getattr(lib, entry)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    _LOADED[name] = (lib, path, took, report)
    return lib


def build_info(name: str) -> dict:
    """Path, build seconds and ptxas report of a loaded library."""
    _lib, path, took, report = _LOADED[name]
    return {"path": path, "build_s": took, "ptxas": report}
