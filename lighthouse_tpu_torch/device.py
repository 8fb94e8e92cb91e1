"""The port's one device choice, and its host↔device copies.

Every entry point of :mod:`lighthouse_tpu_torch` places its tensors on
:func:`get_device`.  The default is ``cuda``; the CPU runs only when a
caller asks for it with :func:`set_default_device` (the tests do).  With
the default ``cuda`` and no GPU present, the first device call raises: the
port never carries on quietly on the CPU.

The size thresholds that send small trees to host hashlib
(``ops.merkle.HOST_DISPATCH_THRESHOLD``, ``ops.tree_cache.
DEVICE_BUILD_THRESHOLD``, ``types.state_cache.DEVICE_COLD_MIN``) are part
of the design, not a fallback; :func:`on_cuda` is what they consult.

Host↔device copies go through :func:`to_device`, :func:`to_device_async`
and :func:`to_host`, which report the bytes moved to the device ledger
(:data:`..common.device_ledger.LEDGER`) under the caller's subsystem: the
one named, else the ambient attribution of the calling thread, else
``device_tree``.  The ledger is the only store of these bytes;
:func:`transfer_totals` is a view of it.  The bytes are counted on the
CPU device too, where the copy stays in host memory, so tests can hold
the warm-root traffic to its dirty-row bound.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .common.device_ledger import LEDGER, SUBSYSTEMS

_default = torch.device("cuda")

# The ledger's mark at the last reset_transfer_counters() (the view
# re-bases; the ledger itself only grows).
_MARK: Optional[tuple] = None

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


def transfer_totals() -> dict:
    """Bytes copied host→device and device→host over every subsystem since
    the last :func:`reset_transfer_counters`, or since the last
    ``LEDGER.reset()`` where that came later (a view of the ledger)."""
    t = LEDGER.since(_MARK, SUBSYSTEMS)
    return {"h2d": int(t["h2d_bytes"]), "d2h": int(t["d2h_bytes"])}


def reset_transfer_counters() -> None:
    """Re-base :func:`transfer_totals` at the ledger's current totals."""
    global _MARK
    _MARK = LEDGER.mark(SUBSYSTEMS)


def to_device(arr, subsystem: Optional[str] = None) -> torch.Tensor:
    """Copy a host array to :func:`get_device` (always a copy: the port
    updates device buffers in place, which must never reach the caller's
    array).  u32/u64 arrays arrive as int32/int64 bit patterns; the bytes
    are noted to the ledger under ``subsystem``."""
    dev = get_device()
    arr = np.ascontiguousarray(arr)
    view = _SIGNED_VIEW.get(arr.dtype)
    if view is not None:
        arr = arr.view(view)
    LEDGER.note_transfer("h2d", arr.nbytes, subsystem)
    return torch.from_numpy(arr).to(dev, copy=True)


def to_device_async(arr, subsystem: Optional[str] = None) -> torch.Tensor:
    """Like :func:`to_device`, without waiting on a GPU: the array is
    copied into pinned host memory and from there to the device with
    ``non_blocking=True`` on the current stream (PyTorch's pinned-memory
    allocator keeps the pinned buffer until that copy has run).  On the
    CPU device it is :func:`to_device`."""
    dev = get_device()
    if dev.type != "cuda":
        return to_device(arr, subsystem)
    arr = np.ascontiguousarray(arr)
    view = _SIGNED_VIEW.get(arr.dtype)
    if view is not None:
        arr = arr.view(view)
    LEDGER.note_transfer("h2d", arr.nbytes, subsystem)
    return torch.from_numpy(arr).pin_memory().to(dev, non_blocking=True)


def to_host(t: torch.Tensor, subsystem: Optional[str] = None) -> np.ndarray:
    """Copy a device tensor to a fresh host array; int32/int64 come back
    as the u32/u64 bit patterns they hold."""
    out = t.detach().to("cpu", copy=True).numpy()
    LEDGER.note_transfer("d2h", out.nbytes, subsystem)
    view = _UNSIGNED_VIEW.get(out.dtype)
    return out.view(view) if view is not None else out
