"""The port's one device choice, and its transfer byte counters.

Every entry point of :mod:`lighthouse_tpu_torch` places its tensors on
:func:`get_device`.  The default is ``cuda``; the CPU runs only when a
caller asks for it with :func:`set_default_device` (the tests do).  With
the default ``cuda`` and no GPU present, the first device call raises: the
port never carries on quietly on the CPU.

The size thresholds that send small trees to host hashlib
(``ops.merkle.HOST_DISPATCH_THRESHOLD``, ``ops.tree_cache.
DEVICE_BUILD_THRESHOLD``, ``types.state_cache.DEVICE_COLD_MIN``) are part
of the design, not a fallback; :func:`on_cuda` is what they consult.

Host↔device copies go through :func:`to_device` / :func:`to_host`, which
add the bytes moved to a per-module counter from
:func:`transfer_counter`.  The bytes are counted on the CPU device too,
where the copy stays in host memory, so tests can hold the warm-root
traffic to its dirty-row bound.
"""

from __future__ import annotations

import numpy as np
import torch

_default = torch.device("cuda")

# name → {"h2d": bytes, "d2h": bytes}; one entry per module that copies.
_COUNTERS: dict[str, dict] = {}

# Host dtypes whose device form is a same-width signed view: torch keeps
# u32 words in int32 and u64 values in int64 (bit patterns unchanged).
_SIGNED_VIEW = {np.dtype(np.uint32): np.int32, np.dtype(np.uint64): np.int64,
                np.dtype(np.bool_): np.uint8}
_UNSIGNED_VIEW = {np.dtype(np.int32): np.uint32,
                  np.dtype(np.int64): np.uint64}


def set_default_device(dev) -> None:
    """Route every later device call to ``dev`` (``"cuda"`` or ``"cpu"``)."""
    global _default
    dev = torch.device(dev)
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    _default = dev


def default_device() -> torch.device:
    """The configured device, without checking that it exists."""
    return _default


def on_cuda() -> bool:
    """True when the configured device is a GPU (the size thresholds that
    route big trees to the device consult this)."""
    return _default.type == "cuda"


def get_device() -> torch.device:
    """The device every entry point computes on; raises when it is
    ``cuda`` and no GPU is present."""
    if _default.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "lighthouse_tpu_torch runs on cuda by default and no CUDA "
            "device is available; call lighthouse_tpu_torch.device."
            "set_default_device('cpu') to run on the CPU")
    return _default


def transfer_counter(name: str) -> dict:
    """The byte counter of one module (created on first use)."""
    return _COUNTERS.setdefault(name, {"h2d": 0, "d2h": 0})


def transfer_totals() -> dict:
    """Bytes copied host→device and device→host, summed over modules."""
    return {k: sum(c[k] for c in _COUNTERS.values()) for k in ("h2d", "d2h")}


def reset_transfer_counters() -> None:
    for c in _COUNTERS.values():
        c["h2d"] = c["d2h"] = 0


def to_device(arr, counter: dict) -> torch.Tensor:
    """Copy a host array to :func:`get_device` (always a copy: the port
    updates device buffers in place, which must never reach the caller's
    array).  u32/u64 arrays arrive as int32/int64 bit patterns."""
    arr = np.ascontiguousarray(arr)
    view = _SIGNED_VIEW.get(arr.dtype)
    if view is not None:
        arr = arr.view(view)
    counter["h2d"] += arr.nbytes
    return torch.from_numpy(arr).to(get_device(), copy=True)


def to_device_async(arr, counter: dict) -> torch.Tensor:
    """Like :func:`to_device`, without waiting on a GPU: the array is
    copied into pinned host memory and from there to the device with
    ``non_blocking=True`` on the current stream (PyTorch's pinned-memory
    allocator keeps the pinned buffer until that copy has run).  On the
    CPU device it is :func:`to_device`."""
    dev = get_device()
    if dev.type != "cuda":
        return to_device(arr, counter)
    arr = np.ascontiguousarray(arr)
    view = _SIGNED_VIEW.get(arr.dtype)
    if view is not None:
        arr = arr.view(view)
    counter["h2d"] += arr.nbytes
    return torch.from_numpy(arr).pin_memory().to(dev, non_blocking=True)


def to_host(t: torch.Tensor, counter: dict) -> np.ndarray:
    """Copy a device tensor to a fresh host array; int32/int64 come back
    as the u32/u64 bit patterns they hold."""
    out = t.detach().to("cpu", copy=True).numpy()
    counter["d2h"] += out.nbytes
    view = _UNSIGNED_VIEW.get(out.dtype)
    return out.view(view) if view is not None else out
