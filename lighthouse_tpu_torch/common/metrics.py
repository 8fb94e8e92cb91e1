"""Process-global metrics registry — the port's copy of the part of
``lighthouse_tpu/common/metrics.py`` that the device ledger, the chunk
stager and the proof server use: counters, gauges and histograms created
lazily by name, ``start_timer`` / ``stop_timer`` guards, one-shot
:func:`observe`, and Prometheus text encoding.  The JAX package's
process gauges (RSS, threads, fds, GC) are not ported.

Labeled families: pass ``labelnames=("kind", ...)`` at creation and call
``.labels("subnet_att")`` (or ``.labels(kind="subnet_att")``) for the
per-label-set child metric.  Exposition follows the Prometheus text
format: one ``# HELP``/``# TYPE`` header per family, label values
escaped (backslash, newline, double quote) and help text escaped
(backslash, newline) per the spec.
"""

from __future__ import annotations

import bisect
import threading
import time
from typing import Dict, List, Optional, Tuple

_DEFAULT_BUCKETS = (0.001, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
                    1.0, 2.5, 5.0, 10.0)


def _escape_label_value(v: str) -> str:
    """Prometheus text-format label-value escaping: backslash, newline,
    double quote (in that order — escaping the escape char first)."""
    return (str(v).replace("\\", "\\\\").replace("\n", "\\n")
            .replace('"', '\\"'))


def _escape_help(h: str) -> str:
    """HELP lines escape backslash and newline only."""
    return h.replace("\\", "\\\\").replace("\n", "\\n")


def _pairs_str(pairs: Tuple[Tuple[str, str], ...]) -> str:
    if not pairs:
        return ""
    inner = ",".join(f'{k}="{_escape_label_value(v)}"' for k, v in pairs)
    return "{" + inner + "}"


class _LabeledFamily:
    """Shared ``labels()`` machinery: a metric created with
    ``labelnames`` acts as a family whose children carry the values."""

    def _init_family(self, labelnames) -> None:
        self.labelnames = tuple(labelnames)
        self._label_pairs: Tuple[Tuple[str, str], ...] = ()
        self._children: Dict[tuple, object] = {}

    def _resolve_values(self, values, kw) -> tuple:
        if kw:
            if values:
                raise ValueError("pass label values positionally OR by "
                                 "keyword, not both")
            if set(kw) != set(self.labelnames):
                raise ValueError(f"labels {sorted(kw)} != declared "
                                 f"{list(self.labelnames)}")
            return tuple(str(kw[k]) for k in self.labelnames)
        if len(values) != len(self.labelnames):
            raise ValueError(f"expected {len(self.labelnames)} label "
                             f"values, got {len(values)}")
        return tuple(str(v) for v in values)

    def labels(self, *values, **kw):
        if not self.labelnames:
            raise ValueError(f"metric {self.name} has no labels")
        vals = self._resolve_values(values, kw)
        with self._lock:
            child = self._children.get(vals)
            if child is None:
                child = self._make_child()
                child._label_pairs = tuple(zip(self.labelnames, vals))
                self._children[vals] = child
            return child

    def _sorted_children(self) -> list:
        with self._lock:
            return [c for _k, c in sorted(self._children.items())]

    def clear_children(self) -> None:
        """Drop every labeled child series (the family stays
        registered).  For callers that stop emitting per-label series —
        leaving the old children in place would export frozen stale
        values forever."""
        with self._lock:
            self._children.clear()


class Counter(_LabeledFamily):
    def __init__(self, name: str, help_: str, labelnames=()):
        self.name, self.help = name, help_
        self.value = 0.0
        self._lock = threading.Lock()
        self._init_family(labelnames)

    _TYPE = "counter"

    def _make_child(self) -> "Counter":
        return type(self)(self.name, self.help)

    def inc(self, by: float = 1.0) -> None:
        if self.labelnames:
            raise ValueError(f"labeled metric {self.name}: call "
                             ".labels(...) first")
        with self._lock:
            self.value += by

    def _header(self) -> str:
        return (f"# HELP {self.name} {_escape_help(self.help)}\n"
                f"# TYPE {self.name} {self._TYPE}\n")

    def _sample_lines(self) -> str:
        return f"{self.name}{_pairs_str(self._label_pairs)} {self.value}\n"

    def encode(self) -> str:
        if self.labelnames:
            return self._header() + "".join(
                c._sample_lines() for c in self._sorted_children())
        return self._header() + self._sample_lines()


class Gauge(Counter):
    _TYPE = "gauge"

    def set(self, v: float) -> None:
        if self.labelnames:
            raise ValueError(f"labeled metric {self.name}: call "
                             ".labels(...) first")
        with self._lock:
            self.value = v


class Histogram(_LabeledFamily):
    def __init__(self, name: str, help_: str,
                 buckets: Tuple[float, ...] = _DEFAULT_BUCKETS,
                 labelnames=()):
        self.name, self.help = name, help_
        self.buckets = tuple(buckets)
        self.counts = [0] * (len(self.buckets) + 1)
        self.sum = 0.0
        self.total = 0
        self._lock = threading.Lock()
        self._init_family(labelnames)

    def _make_child(self) -> "Histogram":
        return type(self)(self.name, self.help, buckets=self.buckets)

    def observe(self, v: float) -> None:
        if self.labelnames:
            raise ValueError(f"labeled metric {self.name}: call "
                             ".labels(...) first")
        # bisect_left finds the first bucket with bound >= v — identical
        # to the linear `v <= b` scan, O(log n) instead of O(n) per
        # observation on the hot verify/import paths; index len(buckets)
        # IS the +Inf overflow slot.
        i = bisect.bisect_left(self.buckets, v)
        with self._lock:
            self.sum += v
            self.total += 1
            self.counts[i] += 1

    def start_timer(self) -> "HistogramTimer":
        return HistogramTimer(self)

    def snapshot(self) -> Tuple[Tuple[float, ...], Tuple[int, ...],
                                int, float]:
        """Consistent ``(buckets, per-bucket counts, total, sum)`` copy —
        the record-time aggregate the SLO engine diffs between window
        snapshots (never a per-observation list)."""
        with self._lock:
            return (self.buckets, tuple(self.counts), self.total,
                    self.sum)

    def _header(self) -> str:
        return (f"# HELP {self.name} {_escape_help(self.help)}\n"
                f"# TYPE {self.name} histogram\n")

    def _sample_lines(self) -> str:
        out = []
        cum = 0
        for b, c in zip(self.buckets, self.counts):
            cum += c
            out.append(f"{self.name}_bucket"
                       f"{_pairs_str(self._label_pairs + (('le', str(b)),))}"
                       f" {cum}")
        cum += self.counts[-1]
        out.append(f"{self.name}_bucket"
                   f"{_pairs_str(self._label_pairs + (('le', '+Inf'),))}"
                   f" {cum}")
        base = _pairs_str(self._label_pairs)
        out.append(f"{self.name}_sum{base} {self.sum}")
        out.append(f"{self.name}_count{base} {self.total}")
        return "\n".join(out) + "\n"

    def encode(self) -> str:
        if self.labelnames:
            return self._header() + "".join(
                c._sample_lines() for c in self._sorted_children())
        return self._header() + self._sample_lines()


class HistogramTimer:
    """`start_timer`/`stop_timer` guard; also a context manager."""

    def __init__(self, hist: Histogram):
        self.hist = hist
        self.t0 = time.perf_counter()
        self.stopped = False

    def stop(self) -> float:
        if not self.stopped:
            dt = time.perf_counter() - self.t0
            self.hist.observe(dt)
            self.stopped = True
            return dt
        return 0.0

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.stop()


class Registry:
    def __init__(self):
        self._metrics: Dict[str, object] = {}
        self._collectors: List = []
        self._lock = threading.Lock()

    def register_collector(self, fn) -> None:
        """Scrape-time refresher: ``fn()`` runs before every
        :meth:`encode` so pull-model values (process RSS, fd count, GC
        stats) are current at scrape without a background thread."""
        with self._lock:
            if fn not in self._collectors:
                self._collectors.append(fn)

    def _get(self, cls, name: str, help_: str, **kw):
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = cls(name, help_, **kw)
                self._metrics[name] = m
            elif not isinstance(m, cls):
                raise TypeError(f"metric {name} already registered as "
                                f"{type(m).__name__}")
            elif tuple(kw.get("labelnames", ())) != \
                    getattr(m, "labelnames", ()):
                raise TypeError(
                    f"metric {name} already registered with labels "
                    f"{list(getattr(m, 'labelnames', ()))}")
            return m

    def counter(self, name: str, help_: str = "", **kw) -> Counter:
        return self._get(Counter, name, help_, **kw)

    def gauge(self, name: str, help_: str = "", **kw) -> Gauge:
        return self._get(Gauge, name, help_, **kw)

    def histogram(self, name: str, help_: str = "", **kw) -> Histogram:
        return self._get(Histogram, name, help_, **kw)

    def encode(self) -> str:
        """Prometheus text exposition (the `/metrics` body)."""
        with self._lock:
            collectors = list(self._collectors)
        for fn in collectors:
            try:
                fn()
            except Exception:  # noqa: BLE001 — a broken collector must
                pass           # never take the whole scrape down
        with self._lock:
            metrics = sorted(self._metrics.items())
        return "".join(m.encode() for _, m in metrics)


# The process-global registry (`lighthouse_metrics` lazy_static).
REGISTRY = Registry()

counter = REGISTRY.counter
gauge = REGISTRY.gauge
histogram = REGISTRY.histogram


def start_timer(name: str, help_: str = "") -> HistogramTimer:
    return REGISTRY.histogram(name, help_).start_timer()


def observe(name: str, value: float, help_: str = "") -> None:
    """One-shot histogram observation — the stage-boundary hook the
    device pipeline uses (host-prep / transfer / compute / pull), where
    the section being timed spans threads and a timer guard can't."""
    REGISTRY.histogram(name, help_).observe(value)
