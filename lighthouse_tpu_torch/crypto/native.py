"""ctypes bindings for the native BLS12-381 host library (``native/bls381.cpp``).

Port of ``lighthouse_tpu/crypto/native.py``, with the same API.  The
library is the host fast path of BLS verification: single sets and small
batches, where launching the device pipeline costs more than a few native
pairings, and the key sums of the shared path.  Large batches stay on the
GPU (:mod:`.tpu_backend`).  It is portable C++ (no assembly), compiled on
demand with

    g++ -O3 -march=native -shared -fPIC -o libbls381-<tag>.so bls381.cpp

from the repository's ``native/`` sources into ``build/native/`` at the
repository root (git ignores it).  The tag hashes the source, its header
and the CPU's feature flags, so an edited source or another CPU rebuilds.
The build writes a temporary file and renames it into place, under a file
lock, so concurrent processes build once and never load a partial file.
Nothing is written into ``native/``, and nothing builds at import time.

Unlike the JAX package, a failed build is not a quiet fallback: the
compiler's stderr is kept and :func:`available` with ``block=True`` (and
every later :func:`ready`) raises with it.  ``LIGHTHOUSE_TPU_NO_NATIVE=1``
is the only switch to the pure-Python host path.  So a failed build also
fails every key sum of 16 keys or more, the device-only shared verify
path's included.

:func:`ready` starts the build in the background and answers False until
it is done, so the routes change once, mid-process: before, key sums run
in pure Python and small batches go to the device; after, both run here.
A process that is measured or serves traffic calls
``available(block=True)`` (or ``common.compile_cache.warmup()``) during
set-up, so one route serves its whole run.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
import time
from typing import Optional, Sequence, Tuple

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_REPO = os.path.dirname(_PKG)
_SRC = os.path.join(_REPO, "native", "bls381.cpp")
_HDR = os.path.join(_REPO, "native", "bls381_consts.h")
BUILD_DIR = os.path.join(_REPO, "build", "native")
GXX_FLAGS = ["-O3", "-march=native", "-shared", "-fPIC"]

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_error: Optional[str] = None     # the failed build's compiler output
_building: Optional[threading.Thread] = None
# Seconds the g++ build of this process took (0.0 when it loaded a
# finished build), for the smoke script's report.
BUILD_INFO: dict = {}


class NativeBuildError(RuntimeError):
    """g++ could not build (or the loader could not load) the library."""


def _source_tag() -> str:
    h = hashlib.sha256()
    for path in (_SRC, _HDR):
        with open(path, "rb") as f:
            h.update(f.read())
    # -march=native binaries are host-specific: fingerprint the CPU's
    # feature flags so a build from another machine is rebuilt rather
    # than dying of an illegal instruction.
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith("flags"):
                    h.update(line.encode())
                    break
    except OSError:
        import platform
        h.update(platform.processor().encode())
    return h.hexdigest()[:16]


def library_path() -> str:
    return os.path.join(BUILD_DIR, f"libbls381-{_source_tag()}.so")


def _build() -> str:
    """Compile the library unless a finished build exists; returns its
    path.  Raises :class:`NativeBuildError` with g++'s output."""
    import fcntl

    from ..common.device_ledger import LEDGER

    so = library_path()
    if os.path.exists(so):
        LEDGER.note_compile("bls", key="compile_hits")
        BUILD_INFO.update(path=so, build_s=0.0)
        return so
    os.makedirs(BUILD_DIR, exist_ok=True)
    with open(os.path.join(BUILD_DIR, ".lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)     # one builder at a time
        if os.path.exists(so):               # another process built it
            LEDGER.note_compile("bls", key="compile_hits")
            BUILD_INFO.update(path=so, build_s=0.0)
            return so
        tmp = f"{so}.tmp{os.getpid()}"
        cmd = ["g++", *GXX_FLAGS, "-o", tmp, _SRC]
        t0 = time.perf_counter()
        try:
            proc = subprocess.run(cmd, capture_output=True, text=True,
                                  timeout=300)
        except (OSError, subprocess.SubprocessError) as e:
            raise NativeBuildError(f"{' '.join(cmd)}: {e!r}") from e
        if proc.returncode != 0:
            if os.path.exists(tmp):
                os.unlink(tmp)
            raise NativeBuildError(
                f"{' '.join(cmd)} failed (rc {proc.returncode}):\n"
                f"{proc.stdout}{proc.stderr}")
        os.replace(tmp, so)
    LEDGER.note_compile("bls")
    BUILD_INFO.update(path=so, build_s=time.perf_counter() - t0)
    return so


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    u64p = ctypes.POINTER(ctypes.c_uint64)
    lib.bls381_multi_pairing_is_one.restype = ctypes.c_int
    lib.bls381_multi_pairing_is_one.argtypes = [u64p, u64p, ctypes.c_uint64]
    lib.bls381_multi_pairing_gt.restype = None
    lib.bls381_multi_pairing_gt.argtypes = [u64p, u64p, ctypes.c_uint64,
                                            u64p]
    lib.bls381_g1_aggregate.restype = ctypes.c_int
    lib.bls381_g1_aggregate.argtypes = [u64p, ctypes.c_uint64, u64p]
    lib.bls381_hash_to_g2_u.restype = ctypes.c_int
    lib.bls381_hash_to_g2_u.argtypes = [u64p, u64p]
    lib.bls381_g2_mul.restype = ctypes.c_int
    lib.bls381_g2_mul.argtypes = [u64p, u64p, u64p]
    return lib


def _load() -> ctypes.CDLL:
    """Build (once per process) and load the library; raises the build's
    error, now and on every later call."""
    global _lib, _error
    with _lock:
        if _lib is not None:
            return _lib
        if _error is None:
            try:
                _lib = _bind(ctypes.CDLL(_build()))
                return _lib
            except (NativeBuildError, OSError) as e:
                _error = str(e)
        raise NativeBuildError(
            f"the native BLS library is unavailable:\n{_error}")


def _background_load() -> None:
    try:
        _load()
    except NativeBuildError:
        pass    # kept in _error; ready() and available() raise it


def ready() -> bool:
    """The hot-path gate: False under ``LIGHTHOUSE_TPU_NO_NATIVE`` or while
    the background build (started here) is still running; True once the
    library is loaded.  Never blocks.  Raises when the build failed."""
    from ..common.knobs import knob_bool
    if knob_bool("LIGHTHOUSE_TPU_NO_NATIVE"):
        return False
    if _lib is not None:
        return True
    prebuild_async()
    return available(block=False)


def available(block: bool = True) -> bool:
    """Whether the library is loaded.  ``block=True`` builds and loads it
    now (raising with g++'s output when that fails); ``block=False``
    answers from the current state without waiting (False while a build
    runs, raising when one failed)."""
    if _lib is not None:
        return True
    if block:
        return _load() is not None
    if _error is not None:
        raise NativeBuildError(
            f"the native BLS library is unavailable:\n{_error}")
    return False


def prebuild_async() -> None:
    """Start the g++ build and load on a daemon thread, so the first verify
    never waits for the compiler."""
    global _building
    with _lock:
        if _lib is not None or _error is not None or _building is not None:
            return
        _building = threading.Thread(target=_background_load,
                                     name="bls381-native-build", daemon=True)
        _building.start()


def _limbs(x: int) -> Tuple[int, ...]:
    return tuple((x >> (64 * i)) & 0xFFFFFFFFFFFFFFFF for i in range(6))


def _pack(pairs: Sequence[Tuple[tuple, tuple]]):
    n = len(pairs)
    g1 = (ctypes.c_uint64 * (12 * n))()
    g2 = (ctypes.c_uint64 * (24 * n))()
    for i, (p, q) in enumerate(pairs):
        g1[i * 12:(i + 1) * 12] = _limbs(p[0]) + _limbs(p[1])
        g2[i * 24:(i + 1) * 24] = (_limbs(q[0][0]) + _limbs(q[0][1]) +
                                   _limbs(q[1][0]) + _limbs(q[1][1]))
    return g1, g2


def multi_pairing_is_one(pairs: Sequence[Tuple[tuple, tuple]]) -> bool:
    """prod_i e(P_i, Q_i) == 1 for AFFINE non-infinity pairs (the caller
    drops identity pairs)."""
    lib = _load()
    g1, g2 = _pack(pairs)
    return bool(lib.bls381_multi_pairing_is_one(g1, g2, len(pairs)))


def g1_aggregate(points: Sequence[tuple]) -> Optional[tuple]:
    """Affine sum of non-infinity G1 points (None = the identity): the
    Jacobian accumulation behind ``bls.aggregate_points``."""
    lib = _load()
    n = len(points)
    buf = (ctypes.c_uint64 * (12 * n))()
    for i, (x, y) in enumerate(points):
        buf[i * 12:(i + 1) * 12] = _limbs(x) + _limbs(y)
    out = (ctypes.c_uint64 * 12)()
    if not lib.bls381_g1_aggregate(buf, n, out):
        return None
    x = sum(int(out[j]) << (64 * j) for j in range(6))
    y = sum(int(out[6 + j]) << (64 * j) for j in range(6))
    return (x, y)


def _pack_g2_affine(point: tuple):
    buf = (ctypes.c_uint64 * 24)()
    buf[0:6] = _limbs(point[0][0])
    buf[6:12] = _limbs(point[0][1])
    buf[12:18] = _limbs(point[1][0])
    buf[18:24] = _limbs(point[1][1])
    return buf


def _unpack_g2_affine(out) -> tuple:
    v = [sum(int(out[o * 6 + j]) << (64 * j) for j in range(6))
         for o in range(4)]
    return ((v[0], v[1]), (v[2], v[3]))


def hash_to_g2_u(u0: tuple, u1: tuple) -> Optional[tuple]:
    """SSWU → 3-isogeny → cofactor clearing of two Fq2 elements (the curve
    half of RFC 9380 hash_to_curve).  Returns the affine ((x0, x1),
    (y0, y1)) G2 point, None for the (pathological) infinity."""
    lib = _load()
    u = _pack_g2_affine((u0, u1))    # same 4 × Fq layout as a G2 point
    out = (ctypes.c_uint64 * 24)()
    if not lib.bls381_hash_to_g2_u(u, out):
        return None
    return _unpack_g2_affine(out)


def g2_mul(point: tuple, scalar: int) -> Optional[tuple]:
    """[scalar]P for an affine G2 point and a scalar below 2^256."""
    lib = _load()
    p = _pack_g2_affine(point)
    s = (ctypes.c_uint64 * 4)(
        *((scalar >> (64 * i)) & 0xFFFFFFFFFFFFFFFF for i in range(4)))
    out = (ctypes.c_uint64 * 24)()
    if not lib.bls381_g2_mul(p, s, out):
        return None
    return _unpack_g2_affine(out)


def multi_pairing_gt(pairs: Sequence[Tuple[tuple, tuple]]) -> tuple:
    """The CUBED GT value of the pairs (equal to ``pairing.
    final_exponentiation_cubed`` of their Miller product)."""
    lib = _load()
    g1, g2 = _pack(pairs)
    out = (ctypes.c_uint64 * 144)()
    lib.bls381_multi_pairing_gt(g1, g2, len(pairs), out)
    f = [sum(int(out[i * 6 + j]) << (64 * j) for j in range(6))
         for i in range(12)]
    return (((f[0], f[1]), (f[2], f[3]), (f[4], f[5])),
            ((f[6], f[7]), (f[8], f[9]), (f[10], f[11])))
