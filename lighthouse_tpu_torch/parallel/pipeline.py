"""Staged device executor — host marshalling overlapped with device work.

Port of ``StagedExecutor`` from ``lighthouse_tpu/parallel/pipeline.py``.
For each work item it runs ``prep`` (host marshalling into numpy arrays),
``stage`` (the copy to the device) and ``dispatch`` (queueing the device
work) without waiting for the device between items, so the host
marshals item i+1 while the GPU computes item i; the caller syncs once at
the end.  Staging copies each array into pinned host memory and from
there to the device with ``non_blocking=True`` on the current stream
(:func:`..device.to_device_async`), so the dispatch that follows on the
same stream reads the copied bytes.  The bytes staged are added to the
executor's :mod:`..device` transfer counter.
"""

from __future__ import annotations

import time
from typing import Any, Callable, List, Optional, Sequence

import numpy as np
import torch

from .. import device as D


def _map_arrays(fn, host):
    """Apply ``fn`` to an array, or to each array of a tuple; other
    items (a static K bucket) pass through."""
    if isinstance(host, tuple):
        return tuple(_map_arrays(fn, x) for x in host)
    return fn(host) if isinstance(host, np.ndarray) else host


def stage_arrays(host, counter: dict):
    """The asynchronous staging: every array leaf copied to the device
    without waiting."""
    return _map_arrays(lambda a: D.to_device_async(a, counter), host)


def sync_stage_arrays(host, counter: dict):
    """The retry's staging: the same copies to the device, then waiting
    for them, so a transfer fault shows here and not in the dispatch."""
    out = _map_arrays(lambda a: D.to_device(a, counter), host)
    if D.get_device().type == "cuda":
        torch.cuda.synchronize()
    return out


class StagedExecutor:
    """Double-buffered ``prep → stage → dispatch`` pipeline.

    ``map(items, prep, dispatch)`` runs, for each item::

        host   = prep(item)          # host marshalling (numpy)
        staged = stage(host)         # asynchronous copy to the device
        out    = dispatch(staged)    # device work queued, not waited for

    and returns the list of ``dispatch`` results (device tensors: the
    caller syncs once at the end).  A failure raised by the staging
    copies re-stages that item synchronously on the device and dispatches
    it (``fallbacks`` counts these); a second staging failure, and any
    failure of ``dispatch`` itself, propagates.
    """

    def __init__(self, name: str = "pipeline",
                 counter: Optional[dict] = None):
        self.name = name
        self.counter = (counter if counter is not None
                        else D.transfer_counter(f"parallel.{name}"))
        self.stats = {
            "items": 0,
            "fallbacks": 0,
            "host_prep_s": 0.0,     # total host marshalling time
            "overlap_prep_s": 0.0,  # marshalling done while the device ran
            "stage_s": 0.0,         # host time spent issuing the copies
        }

    def map(self, items: Sequence[Any], prep: Callable[[Any], Any],
            dispatch: Callable[[Any], Any]) -> List[Any]:
        out: List[Any] = []
        in_flight = False  # a dispatch was queued and nothing waited for it
        for item in items:
            t0 = time.perf_counter()
            host = prep(item)
            dt = time.perf_counter() - t0
            self.stats["host_prep_s"] += dt
            if in_flight:
                self.stats["overlap_prep_s"] += dt
            t0 = time.perf_counter()
            try:
                staged = stage_arrays(host, self.counter)
            except Exception:   # the transfer failed: stage again, waiting
                self.stats["fallbacks"] += 1
                staged = sync_stage_arrays(host, self.counter)
            self.stats["stage_s"] += time.perf_counter() - t0
            out.append(dispatch(staged))
            in_flight = True
            self.stats["items"] += 1
            del host, staged
        return out

    def overlap_efficiency(self) -> Optional[float]:
        """Fraction of host marshalling that ran while the device had
        queued work (1.0 = everything after the first dispatch; None until
        something ran)."""
        total = self.stats["host_prep_s"]
        if not self.stats["items"] or total <= 0:
            return None
        return self.stats["overlap_prep_s"] / total
