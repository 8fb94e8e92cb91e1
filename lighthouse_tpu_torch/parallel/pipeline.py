"""Staged device executors — host work and copies overlapped with device work.

Port of ``lighthouse_tpu/parallel/pipeline.py``:

- :class:`StagedExecutor` — for each work item it runs ``prep`` (host
  marshalling into numpy arrays), ``stage`` (the copy to the device) and
  ``dispatch`` (queueing the device work) without waiting for the device
  between items, so the host marshals item i+1 while the GPU computes
  item i; the caller syncs once at the end.  Staging copies each array
  into pinned host memory and from there to the device with
  ``non_blocking=True`` on the current stream
  (:func:`..device.to_device_async`), so the dispatch that follows on the
  same stream reads the copied bytes.
- :class:`ChunkStager` — a background thread that copies an ordered list
  of host chunks to the device while the consumer queues device work on
  the chunks already there (the cold builds of big trees and of the
  registry).  On a GPU each chunk goes from pinned memory on a side
  CUDA stream; the consumer's stream waits on the copy's event.

The bytes staged are reported to the device ledger under the executor's
subsystem; stage times go to :mod:`..common.metrics`.
"""

from __future__ import annotations

import queue
import threading
import time
from functools import lru_cache
from typing import Any, Callable, List, Optional, Sequence

import numpy as np
import torch

from .. import device as D
from ..common.metrics import observe


def _map_arrays(fn, host):
    """Apply ``fn`` to an array, or to each array of a tuple or dict;
    other items (a static K bucket) pass through."""
    if isinstance(host, tuple):
        return tuple(_map_arrays(fn, x) for x in host)
    if isinstance(host, dict):
        return {k: _map_arrays(fn, v) for k, v in host.items()}
    return fn(host) if isinstance(host, np.ndarray) else host


def stage_arrays(host, subsystem: Optional[str] = None):
    """The asynchronous staging: every array leaf copied to the device
    without waiting."""
    return _map_arrays(lambda a: D.to_device_async(a, subsystem), host)


def sync_stage_arrays(host, subsystem: Optional[str] = None):
    """The retry's staging: the same copies to the device, then waiting
    for them, so a transfer fault shows here and not in the dispatch."""
    out = _map_arrays(lambda a: D.to_device(a, subsystem), host)
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
                 subsystem: Optional[str] = "staging"):
        self.name = name
        # Ledger attribution of the staged bytes ("bls" for the verify
        # pipeline, "staging" for cold builds).
        self.subsystem = subsystem
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
            observe(f"{self.name}_host_prep_seconds", dt)
            self.stats["host_prep_s"] += dt
            if in_flight:
                self.stats["overlap_prep_s"] += dt
            t0 = time.perf_counter()
            try:
                staged = stage_arrays(host, self.subsystem)
            except Exception:   # the transfer failed: stage again, waiting
                self.stats["fallbacks"] += 1
                staged = sync_stage_arrays(host, self.subsystem)
            dt = time.perf_counter() - t0
            observe(f"{self.name}_h2d_seconds", dt)
            self.stats["stage_s"] += dt
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


@lru_cache(maxsize=None)
def _side_stream(index: int) -> "torch.cuda.Stream":
    """The chunk stagers' copy stream of one GPU: one for the process, so
    the caching allocator serves each cold build from the memory the last
    one returned (its pools are per stream)."""
    return torch.cuda.Stream(index)


class _Staged:
    """One chunk on the device, and on a GPU the event its copy recorded
    on the stager's side stream."""

    __slots__ = ("value", "event")

    def __init__(self, value, event=None):
        self.value = value
        self.event = event


def _tensor_leaves(x) -> list:
    if isinstance(x, (tuple, list)):
        return [t for v in x for t in _tensor_leaves(v)]
    if isinstance(x, dict):
        return [t for v in x.values() for t in _tensor_leaves(v)]
    return [x] if isinstance(x, torch.Tensor) else []


class ChunkStager:
    """Background host→device staging of an ordered chunk list.

    A non-daemon thread copies ``host_chunks[i]`` (an array, or a tuple or
    dict of arrays) to the device and waits for the copy to finish — off
    the critical path — then hands the device chunk to a bounded queue;
    iterating the stager yields the chunks in order while the consumer's
    device work on earlier chunks runs.  The queue depth (default 2) is
    the double buffer: at most ``depth`` chunks wait on the device ahead
    of the one being consumed.

    On a GPU each copy goes from pinned memory on a side CUDA stream and
    records an event there; the consumer's current stream waits on that
    event before the chunk is yielded, and every yielded tensor is marked
    with ``record_stream`` for the consumer's stream, so the caching
    allocator never reuses its memory while work queued there may still
    read it.  On the CPU device a stage is the synchronous copy of
    :func:`..device.to_device`.

    A chunk whose staging raised is staged again, synchronously, by the
    consumer (``fallbacks`` counts these).  Stats: ``wait_s`` — time the
    consumer waited for a staged chunk (the only copy time left on the
    critical path); ``transfer_s`` — total time of the background copies
    (``transfer_s − wait_s`` is the copy time the overlap hid).
    """

    def __init__(self, host_chunks: Sequence[Any],
                 stage: Optional[Callable] = None, depth: int = 2,
                 subsystem: str = "staging"):
        self._chunks = list(host_chunks)
        self.subsystem = subsystem
        self._stage = stage or self._default_stage
        self._device = D.get_device()
        self._side = None
        if self._device.type == "cuda":
            self._side = _side_stream(self._device.index
                                      if self._device.index is not None
                                      else torch.cuda.current_device())
        self._q: queue.Queue = queue.Queue(maxsize=max(1, depth))
        self._abort = threading.Event()
        self.wait_s = 0.0
        self.transfer_s = 0.0
        self.fallbacks = 0
        # Non-daemon: a daemon thread inside a CUDA copy at interpreter
        # shutdown can abort the process.
        self._thread = threading.Thread(target=self._run, daemon=False,
                                        name="chunk-stager")
        self._thread.start()

    def _default_stage(self, chunk) -> _Staged:
        if self._side is None:
            return _Staged(_map_arrays(
                lambda a: D.to_device(a, self.subsystem), chunk))
        with torch.cuda.stream(self._side):
            value = _map_arrays(
                lambda a: D.to_device_async(a, self.subsystem), chunk)
            event = torch.cuda.Event()
            event.record(self._side)
        event.synchronize()      # the stager thread waits, not the consumer
        return _Staged(value, event)

    def _put(self, item) -> bool:
        """Bounded put that gives up when the consumer aborted (a consumer
        leaving mid-iteration must not strand the thread on a full
        queue)."""
        while not self._abort.is_set():
            try:
                self._q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def _run(self) -> None:
        try:
            if self._side is not None:
                torch.cuda.set_device(self._side.device)
            for i, chunk in enumerate(self._chunks):
                if self._abort.is_set():
                    return
                t0 = time.perf_counter()
                try:
                    got = self._stage(chunk)
                except Exception as e:  # the consumer stages it again
                    if not self._put((i, e)):
                        return
                    continue
                self.transfer_s += time.perf_counter() - t0
                if not self._put((i, got)):
                    return
        except BaseException as e:      # the consumer raises it
            self._put((None, e))

    def _get(self):
        """The next staged item; raises if the thread ended without one
        (it never leaves the consumer waiting)."""
        while True:
            try:
                return self._q.get(timeout=0.1)
            except queue.Empty:
                if not self._thread.is_alive() and self._q.empty():
                    raise RuntimeError("chunk stager thread ended early")

    def _take(self, staged):
        """The consumer's side of a chunk: its stream waits on the copy,
        and the caching allocator learns that stream uses the memory."""
        if not isinstance(staged, _Staged):
            return staged
        if staged.event is not None:
            stream = torch.cuda.current_stream(self._device)
            stream.wait_event(staged.event)
            for t in _tensor_leaves(staged.value):
                t.record_stream(stream)
        return staged.value

    def __iter__(self):
        try:
            for i in range(len(self._chunks)):
                t0 = time.perf_counter()
                j, got = self._get()
                dt = time.perf_counter() - t0
                self.wait_s += dt
                observe("pipeline_h2d_wait_seconds", dt)
                if j is None:
                    raise RuntimeError("chunk stager failed") from got
                if j != i:
                    raise RuntimeError(f"chunk stager out of order: got "
                                       f"{j}, want {i}")
                if isinstance(got, Exception):
                    self.fallbacks += 1
                    got = sync_stage_arrays(self._chunks[i], self.subsystem)
                self._chunks[i] = None  # release the host copy
                yield self._take(got)
        finally:
            self._abort.set()
            self._thread.join()

    def join(self) -> None:
        self._abort.set()
        self._thread.join()
