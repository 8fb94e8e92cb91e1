"""Slot-scope tracing: the part of the JAX package's tracer the block
import path calls.

Port of ``lighthouse_tpu/common/tracing.py``, cut to the surface the
state transition and the three block-import stages use:

- :meth:`Tracer.span` / :meth:`Tracer.ctx` — nested spans on a
  thread-local stack; a :class:`SpanContext` captured on one thread
  parents a span on another (the signature worker adopts the importing
  thread's span).  A **disabled** tracer returns one shared no-op span
  after a single attribute check.
- :meth:`Tracer.stage_split` / :meth:`Tracer.record_stages` — the one
  read surface of the stage dicts (``LAST_BLOCK_TIMINGS``,
  ``LAST_EPOCH_TIMINGS``, ``LAST_SIG_DISPATCH``, …) and their conversion
  into child spans of the current span.
- :meth:`Tracer.residency_mark` / :meth:`Tracer.record_residency` — the
  device ledger's per-subsystem transfer bytes attached to a span.

Tracing is off until :meth:`Tracer.enable`; completed spans then land in
a ring of the last 64 slots.  The JAX package's ``LIGHTHOUSE_TPU_TRACE``
knob, Chrome trace export, slot statistics and metrics histogram are
not ported yet.
"""

from __future__ import annotations

import itertools
import threading
import time
from collections import OrderedDict
from typing import Callable, Dict, List, Optional

MAX_SLOTS = 64
MAX_SPANS_PER_SLOT = 8192


class SpanContext:
    """Cross-thread propagation token: the capturing span's id and slot."""

    __slots__ = ("span_id", "slot")

    def __init__(self, span_id: int, slot: int):
        self.span_id = span_id
        self.slot = slot


class _NoopSpan:
    """Shared no-op returned by a disabled tracer."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, **attrs) -> None:
        pass

    def ctx(self) -> Optional[SpanContext]:
        return None


_NOOP = _NoopSpan()


class Span:
    """A live span: entering pushes it on the thread's stack, exiting
    records it into its slot's trace."""

    __slots__ = ("_tracer", "name", "cat", "slot", "attrs", "span_id",
                 "parent_id", "t0")

    def __init__(self, tracer: "Tracer", name: str, cat: str, slot: int,
                 parent_id: int, attrs: dict):
        self._tracer = tracer
        self.name = name
        self.cat = cat
        self.slot = slot
        self.parent_id = parent_id
        self.attrs = attrs
        self.span_id = next(tracer._ids)
        self.t0 = 0.0

    def set(self, **attrs) -> None:
        self.attrs.update(attrs)

    def ctx(self) -> SpanContext:
        return SpanContext(self.span_id, self.slot)

    def __enter__(self) -> "Span":
        self.t0 = time.perf_counter()
        self._tracer._stack().append(self)
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        dur = time.perf_counter() - self.t0
        stack = self._tracer._stack()
        if self in stack:
            stack.remove(self)
        if exc_type is not None:
            self.attrs["error"] = exc_type.__name__
        self._tracer._record(self.slot, {
            "id": self.span_id, "parent": self.parent_id,
            "name": self.name, "cat": self.cat,
            "ts_us": round(self.t0 * 1e6, 1),
            "dur_us": round(dur * 1e6, 1),
            "thread": threading.current_thread().name,
            "attrs": self.attrs})
        return False


class Tracer:
    """The process tracer (:data:`TRACER`); safe under concurrent span
    completion from the importing thread and the signature worker."""

    def __init__(self):
        self.enabled = False
        self._lock = threading.Lock()
        self._tls = threading.local()
        self._ids = itertools.count(1)
        self._slots: "OrderedDict[int, list]" = OrderedDict()
        self._ambient_slot = 0

    def enable(self) -> None:
        self.enabled = True

    def disable(self) -> None:
        self.enabled = False

    def reset(self) -> None:
        with self._lock:
            self._slots.clear()

    def set_slot(self, slot: int) -> None:
        self._ambient_slot = int(slot)

    def _stack(self) -> list:
        st = getattr(self._tls, "stack", None)
        if st is None:
            st = self._tls.stack = []
        return st

    def span(self, name: str, cat: str = "", slot: Optional[int] = None,
             parent: Optional[SpanContext] = None, **attrs):
        """Open a span; ``parent`` adopts a span captured on another
        thread, else the parent is the thread's innermost open span."""
        if not self.enabled:
            return _NOOP
        stack = self._stack()
        top = stack[-1] if stack else None
        if parent is not None:
            parent_id, inherited = parent.span_id, parent.slot
            attrs = {"adopted": True, **attrs}
        elif top is not None:
            parent_id, inherited = top.span_id, top.slot
        else:
            parent_id, inherited = 0, self._ambient_slot
        return Span(self, name, cat,
                    inherited if slot is None else int(slot),
                    parent_id, attrs)

    def instant(self, name: str, cat: str = "",
                slot: Optional[int] = None, **attrs) -> None:
        """Zero-duration marker (health transitions)."""
        if not self.enabled:
            return
        stack = self._stack()
        top = stack[-1] if stack else None
        self._record(
            (top.slot if top is not None else self._ambient_slot)
            if slot is None else int(slot),
            {"id": next(self._ids),
             "parent": top.span_id if top is not None else 0,
             "name": name, "cat": cat,
             "ts_us": round(time.perf_counter() * 1e6, 1),
             "dur_us": 0.0, "inst": True,
             "tid": threading.get_ident(),
             "thread": threading.current_thread().name,
             "attrs": attrs})

    def ctx(self) -> SpanContext:
        stack = self._stack()
        if stack:
            return stack[-1].ctx()
        return SpanContext(0, self._ambient_slot)

    def _record(self, slot: int, rec: dict) -> None:
        with self._lock:
            spans = self._slots.get(slot)
            if spans is None:
                spans = self._slots[slot] = []
                while len(self._slots) > MAX_SLOTS:
                    self._slots.pop(min(self._slots))
            if len(spans) < MAX_SPANS_PER_SLOT:
                spans.append(rec)

    def slot_spans(self, slot: int) -> List[dict]:
        """The spans recorded for ``slot``, by start time."""
        with self._lock:
            spans = list(self._slots.get(int(slot), ()))
        return sorted(spans, key=lambda s: s["ts_us"])

    def slot_stats(self) -> List[dict]:
        """Per-slot per-category duration aggregates of the recorded
        spans: ``[{"slot", "stats": {cat: {"count", "total_ms",
        "max_ms"}}}]`` (the SLO engine's worst-offender attribution)."""
        with self._lock:
            buckets = [(s, list(v)) for s, v in self._slots.items()]
        out = []
        for slot, spans in sorted(buckets):
            stats: dict = {}
            for rec in spans:
                if not rec["cat"] or rec.get("inst"):
                    continue
                st = stats.setdefault(rec["cat"], [0, 0.0, 0.0])
                st[0] += 1
                st[1] += rec["dur_us"]
                st[2] = max(st[2], rec["dur_us"])
            out.append({"slot": slot, "stats": {
                cat: {"count": st[0], "total_ms": round(st[1] / 1e3, 3),
                      "max_ms": round(st[2] / 1e3, 3)}
                for cat, st in stats.items()}})
        return out

    # -- stage-dict adapter --------------------------------------------------

    def stage_split(self, source: str) -> dict:
        """Snapshot one of the stage dicts by name (:data:`_STAGE_SOURCES`)."""
        return dict(_STAGE_SOURCES[source]())

    def record_stages(self, source: str, cat: Optional[str] = None) -> None:
        """``source``'s ``*_ms`` entries as child spans of the current
        span, back to back and ending now; other keys become attributes
        of the current span."""
        if not self.enabled:
            return
        snap = self.stage_split(source)
        if not snap:
            return
        stack = self._stack()
        top = stack[-1] if stack else None
        parent_id = top.span_id if top is not None else 0
        slot = top.slot if top is not None else self._ambient_slot
        if cat is None:
            cat = top.cat if top is not None and top.cat else "stage"
        ms = [(k, float(v)) for k, v in snap.items()
              if k.endswith("_ms") and k != "total_ms"
              and isinstance(v, (int, float))]
        other = {k: v for k, v in snap.items() if not k.endswith("_ms")}
        t = time.perf_counter() - sum(v for _, v in ms) / 1e3
        tname = threading.current_thread().name
        for k, v in ms:
            self._record(slot, {
                "id": next(self._ids), "parent": parent_id,
                "name": f"{source}:{k[:-3]}", "cat": cat,
                "ts_us": round(t * 1e6, 1), "dur_us": round(v * 1e3, 1),
                "thread": tname, "attrs": {"source": source}})
            t += v / 1e3
        if other and top is not None:
            top.set(**{f"{source}_{k}": v for k, v in other.items()})

    # -- device residency attribution ---------------------------------------

    def residency_mark(self) -> Optional[dict]:
        """The device ledger's per-subsystem transfer totals, for
        :meth:`record_residency`."""
        if not self.enabled:
            return None
        from .device_ledger import LEDGER
        return dict(LEDGER.transfer_totals())

    def record_residency(self, span, mark: Optional[dict]) -> None:
        """Attach ``dev_<subsystem>_{h2d,d2h}_bytes`` moved since
        ``mark`` to ``span``."""
        if mark is None or not self.enabled:
            return
        from .device_ledger import LEDGER
        delta = {}
        for s, (h2d, d2h) in LEDGER.transfer_totals().items():
            b_h2d, b_d2h = mark.get(s, (0, 0))
            if h2d != b_h2d:
                delta[f"dev_{s}_h2d_bytes"] = h2d - b_h2d
            if d2h != b_d2h:
                delta[f"dev_{s}_d2h_bytes"] = d2h - b_d2h
        if delta:
            span.set(**delta)


def _src_block() -> dict:
    from ..state_transition.per_block import LAST_BLOCK_TIMINGS
    return LAST_BLOCK_TIMINGS


def _src_epoch() -> dict:
    from ..state_transition.per_epoch import LAST_EPOCH_TIMINGS
    return LAST_EPOCH_TIMINGS


def _src_block_sigs() -> dict:
    from ..state_transition.sig_dispatch import LAST_SIG_DISPATCH
    return LAST_SIG_DISPATCH


def _src_replay() -> dict:
    from ..state_transition.batch_replay import LAST_REPLAY_TIMINGS
    return LAST_REPLAY_TIMINGS


def _src_op_pool() -> dict:
    from ..op_pool.device_pack import LAST_PACK_STATS
    return LAST_PACK_STATS


def _src_kzg() -> dict:
    from ..kzg.device import LAST_KZG_TIMINGS
    return LAST_KZG_TIMINGS


_STAGE_SOURCES: Dict[str, Callable[[], dict]] = {
    "block": _src_block,
    "epoch": _src_epoch,
    "block_sigs": _src_block_sigs,
    "replay": _src_replay,
    "op_pool": _src_op_pool,
    "kzg": _src_kzg,
}


def register_stage_source(name: str, getter: Callable[[], dict]) -> None:
    """Add a named stage dict to the adapter (the store registers its
    own)."""
    _STAGE_SOURCES[name] = getter


TRACER = Tracer()

span = TRACER.span
record_stages = TRACER.record_stages
stage_split = TRACER.stage_split
