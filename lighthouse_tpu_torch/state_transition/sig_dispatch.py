"""Overlapped block-signature dispatch: the block's device batch runs
under the host transition instead of trailing it.

Port of ``lighthouse_tpu/state_transition/sig_dispatch.py``.

- :meth:`BlockSigDispatcher.submit` takes the block's signature sets as
  soon as the op-accumulation phase has built them, drops exact-duplicate
  sets (:func:`..crypto.bls.dedup_signature_sets`) and verifies them on a
  worker thread;
- on the ``tpu`` backend the worker calls the port's
  ``TpuBackend.verify_signature_sets`` directly, on the CUDA device the
  importing thread uses (set by index: a thread starts on device 0) and
  on one side stream per device, created once.  The post-state root's
  kernels, queued on the importing thread's stream, therefore never wait
  behind the pairing kernels;
- :meth:`BlockSigBatch.join` delivers the verdict after the post-state
  root (``block_verification.ExecutedBlock``), so only the rest of the
  verify (``join_wait_ms``) lands on the import's critical path.  An
  exception on the worker re-raises at ``join()``: no verdict ever comes
  from the host in its place.

The JAX package wraps the device leg in the verification service's
``ResilienceEnvelope``, whose breaker can degrade a batch to the host
oracle; that service is not ported yet, so the port has no envelope and
no host fallback.  The mesh-sharded route is not ported either: a block
batch verifies on one device.

The python and fake backends ARE host paths: they run directly on the
worker thread.  Stats of the most recent verdict land in
:data:`LAST_SIG_DISPATCH` (stage source ``"block_sigs"``): ``sets`` /
``deduped`` / ``path`` / ``device_verify_ms`` / ``join_wait_ms`` /
``overlap_efficiency`` (= 1 − join_wait / device_verify) /
``overlapped``.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, List, Optional, Tuple

from ..common.tracing import TRACER

# Stats of the most recent block-signature verdict (overlapped OR the
# synchronous oracle path), read through tracing.stage_split("block_sigs").
LAST_SIG_DISPATCH: dict = {}

# One verify stream per CUDA device index, created on first use.
_STREAMS: dict = {}
_STREAMS_LOCK = threading.Lock()


def overlap_enabled() -> bool:
    """Overlapped dispatch knob: on unless
    ``LIGHTHOUSE_TPU_OVERLAP_BLOCK_SIGS=0`` (the trailing synchronous
    verify is the differential oracle)."""
    from ..common.knobs import knob_bool
    return knob_bool("LIGHTHOUSE_TPU_OVERLAP_BLOCK_SIGS")


def _verify_stream(index: int):
    """The side stream block batches verify on, one per device index."""
    import torch
    with _STREAMS_LOCK:
        s = _STREAMS.get(index)
        if s is None:
            s = _STREAMS[index] = torch.cuda.Stream(device=index)
        return s


def _device_verify(sets, device_index: Optional[int], ready=None) -> bool:
    """The device leg: the port's TPU backend, on the importing thread's
    CUDA device and this device's verify stream (the CPU device runs the
    plain versions inline).  ``ready`` is an event the importing thread
    recorded at submit: the verify stream waits for the work queued
    before it (the pubkey table's earlier pushes), never for the
    post-state root queued after it."""
    from ..crypto import bls
    backend = bls._BACKENDS["tpu"]
    if device_index is None:
        return bool(backend.verify_signature_sets(sets))
    import torch
    torch.cuda.set_device(device_index)
    stream = _verify_stream(device_index)
    if ready is not None:
        stream.wait_event(ready)
    with torch.cuda.stream(stream):
        ok = bool(backend.verify_signature_sets(sets))
    stream.synchronize()
    return ok


class BlockSigBatch:
    """The in-flight verdict of one block's signature batch."""

    __slots__ = ("_done", "_verdict", "_error", "stats", "slot")

    def __init__(self, stats: dict, slot: Optional[int] = None):
        self._done = threading.Event()
        self._verdict = False
        self._error: Optional[BaseException] = None
        self.stats = stats
        self.slot = slot

    def _complete(self, verdict: bool = False,
                  error: Optional[BaseException] = None) -> None:
        self._verdict = bool(verdict)
        self._error = error
        self._done.set()

    def join(self) -> bool:
        """Block until the verdict is in; publish the join-wait / overlap
        stats.  An exception raised on the worker re-raises here, on the
        importing thread."""
        t0 = time.perf_counter()
        with TRACER.span("sig_join", cat="state_transition",
                         slot=self.slot) as sp:
            self._done.wait()
            wait_ms = (time.perf_counter() - t0) * 1e3
            self.stats["join_wait_ms"] = round(wait_ms, 3)
            dv = self.stats.get("device_verify_ms") or 0.0
            self.stats["overlap_efficiency"] = (
                None if dv <= 0.0
                else round(max(0.0, 1.0 - wait_ms / dv), 4))
            LAST_SIG_DISPATCH.clear()
            LAST_SIG_DISPATCH.update(self.stats)
            sp.set(join_wait_ms=self.stats["join_wait_ms"],
                   path=self.stats.get("path"),
                   verdict=self._error is None and self._verdict)
        if self._error is not None:
            raise self._error
        return self._verdict


class BlockSigDispatcher:
    """Asynchronous verifier for one block's accumulated signature sets.

    The default (module-singleton) instance routes by backend: tpu → the
    device verify on the side stream, python/fake → a direct host verify
    on the worker thread.  Tests inject ``device_fn(sets) -> bool`` to
    drive the real submit/join machinery with a verifier of their own."""

    def __init__(self, device_fn: Optional[Callable] = None):
        self._device_fn = device_fn

    def submit(self, sets: List[object],
               slot: Optional[int] = None) -> BlockSigBatch:
        """Dedup and launch verification of ``sets`` on a worker thread;
        returns at once with the joinable batch."""
        from ..crypto import bls
        from ..device import default_device
        with TRACER.span("sig_dispatch", cat="state_transition",
                         slot=slot) as sp:
            deduped, dropped = bls.dedup_signature_sets(sets)
            stats = {"sets": len(sets), "deduped": dropped,
                     "overlapped": True}
            sp.set(sets=len(sets), deduped=dropped)
            batch = BlockSigBatch(stats, slot=slot)
            ctx = TRACER.ctx() if TRACER.enabled else None
            device_index = ready = None
            if default_device().type == "cuda":
                import torch
                device_index = torch.cuda.current_device()
                ready = torch.cuda.Event()
                ready.record()
            threading.Thread(
                target=self._run,
                args=(deduped, batch, ctx, device_index, ready),
                name="block-sig-verify", daemon=True).start()
        return batch

    # -- worker side ---------------------------------------------------------

    def _run(self, sets, batch: BlockSigBatch, ctx,
             device_index: Optional[int], ready) -> None:
        t0 = time.perf_counter()
        try:
            with TRACER.span("sig_device_verify", cat="state_transition",
                             parent=ctx, sets=len(sets)) as sp:
                ok, path = self._verify(sets, device_index, ready)
                sp.set(path=path, verdict=bool(ok))
        except BaseException as e:  # noqa: BLE001 — re-raised at join
            batch.stats["device_verify_ms"] = round(
                (time.perf_counter() - t0) * 1e3, 3)
            batch.stats["path"] = "error"
            batch._complete(False, e)
            return
        batch.stats["device_verify_ms"] = round(
            (time.perf_counter() - t0) * 1e3, 3)
        batch.stats["path"] = path
        batch._complete(ok)

    def _verify(self, sets, device_index: Optional[int],
                ready) -> Tuple[bool, str]:
        from ..crypto import bls
        if self._device_fn is not None:
            return bool(self._device_fn(sets)), "device"
        backend = bls.get_backend()
        name = getattr(backend, "name", "host")
        if name != "tpu":
            return bool(backend.verify_signature_sets(sets)), name
        return _device_verify(sets, device_index, ready), "device"


_DEFAULT = BlockSigDispatcher()


def get_dispatcher() -> BlockSigDispatcher:
    return _DEFAULT


def record_sync_verify(n_sets: int, deduped: int,
                       verify_ms: float) -> None:
    """Publish the SYNCHRONOUS (non-overlapped) verify's stats so the
    ``block_sigs`` stage source always reflects the most recent block: a
    synchronous verify is its own join wait (overlap efficiency 0).  It
    verifies the sets un-deduped (the differential oracle for dedup too),
    so ``deduped`` is 0 there."""
    LAST_SIG_DISPATCH.clear()
    LAST_SIG_DISPATCH.update(
        sets=n_sets, deduped=deduped, path="sync",
        device_verify_ms=round(verify_ms, 3),
        join_wait_ms=round(verify_ms, 3),
        overlap_efficiency=0.0, overlapped=False)
