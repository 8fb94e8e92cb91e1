"""The CUDA build cache and an explicit warm-up of the kernel libraries.

Port of the warm-up API of ``lighthouse_tpu/common/compile_cache.py``
(``enable``, ``cache_dir``, ``is_enabled``, ``warmup``,
``DEFAULT_BUCKETS``).  In the JAX package the first batch of a fresh
process paid the XLA/Mosaic compile of each bucketed shape, so the
persistent compilation cache and a per-bucket ``lower().compile()`` warm-up
kept it out of the slot path.  The port's kernels are hand-written CUDA
built by ``nvcc`` into shape-independent libraries
(:mod:`..ops.cuda_build`), which are cached on disk by a hash of their
sources: here the cache is that build directory, and the warm-up builds
and loads every library under ``lighthouse_tpu_torch/csrc`` once, so the
first verify or root of a process never waits for ``nvcc``.  It also
builds the native host library and waits for it
(:func:`..crypto.native.available`), so the host routes that library
opens (small batches, key sums) are fixed before the first request and
do not change when a background build finishes mid-run.  Nothing is
built at import.
"""

from __future__ import annotations

import os
from typing import Dict, Optional, Sequence, Tuple

_state = {"dir": None}

# The (sets, keys) shapes a mainnet node verifies in the slot path (the
# JAX package's buckets).  The CUDA libraries serve every shape, so the
# warm-up reports them as served by the one build.
DEFAULT_BUCKETS: Tuple[Tuple[int, int], ...] = (
    (256, 16), (256, 1), (8, 16), (8, 1),
)


def enable(cache_dir: Optional[str] = None) -> str:
    """Build the kernel libraries into ``cache_dir`` (default: the
    repository's ``build/kernels``); returns the directory."""
    from ..ops import cuda_build
    cache = os.path.abspath(cache_dir or cuda_build.BUILD_DIR)
    cuda_build.BUILD_DIR = cache
    _state["dir"] = cache
    return cache


def is_enabled() -> bool:
    return _state["dir"] is not None


def cache_dir() -> Optional[str]:
    return _state["dir"]


def library_names() -> list:
    """Every kernel library of the port: one per ``csrc/*.cu``."""
    from ..ops import cuda_build
    return sorted(f[:-3] for f in os.listdir(cuda_build.CSRC)
                  if f.endswith(".cu"))


def warmup(buckets: Sequence[Tuple[int, int]] = DEFAULT_BUCKETS
           ) -> Dict[str, object]:
    """Build (one ``nvcc`` per source, all started together) and load
    every kernel library, then the native host library (unless
    ``LIGHTHOUSE_TPU_NO_NATIVE``).  Returns ``{"cache_dir": ...,
    "compiled": [{"library", "build_s"}, ...], "native": {"path",
    "build_s"} or None, "buckets": [...]}`` — ``build_s`` is 0 for a
    library loaded from an earlier build; ``{"skipped": "cpu",
    "compiled": []}`` when the port's device is the CPU, where only the
    plain versions run.  Raises without a GPU on the default device, and
    with g++'s output when the native build fails."""
    from .. import device as D
    if D.get_device().type != "cuda":
        return {"skipped": "cpu", "compiled": []}

    from ..crypto import native
    from ..crypto import pairing_kernel as PK
    from ..ops import cuda_build
    from .knobs import knob_bool
    from ..ops import merkle_kernel as MK

    names = library_names()
    built = cuda_build.build_all(names)
    MK.kernel_library()
    PK.kernel_library()
    for name in names:      # libraries no path binds (the tuning probe's)
        cuda_build.load(name, {})
    native_info = None
    if not knob_bool("LIGHTHOUSE_TPU_NO_NATIVE"):
        native.available(block=True)
        native_info = dict(native.BUILD_INFO)
    return {"cache_dir": cuda_build.BUILD_DIR,
            "compiled": [{"library": name,
                          "build_s": built.get(name, (0.0, ""))[0]}
                         for name in names],
            "native": native_info,
            "buckets": [list(b) for b in buckets]}
