"""SLO engine & node-health scoreboard — objectives over the pipeline's
record-time aggregates.

Per-slot traces and labeled metric families alone do not answer the
*objective* questions — "is the node healthy?  is the block
budget being met?  are we shedding?".  This module is that layer, the
observability counterpart of SRE burn-rate alerting:

- **Declarative registry** — an :class:`Objective` is a feed + a budget:
  ``gossip_to_verified p99 < slot/3``, ``block_import p99 < 150 ms``,
  ``shed_rate < 0.1%``, ``host_fallback_rate < 1%`` (the module's
  constants; registry extensible via :meth:`SloEngine.add_objective`).
- **Record-time aggregates only** — feeds return cumulative histogram
  or counter states maintained where events happen (the verification
  service's per-message latency histogram, the chain's block-import
  histogram, shed/fallback counters).  Evaluation diffs those states
  between window snapshots: it never scans span lists or latency
  deques, so the evaluator costs nothing on the hot path.
- **Multi-window rolling attainment** — every objective is evaluated
  over a fast-burn and a slow-burn window (SRE multi-window/multi-burn
  alerting): attainment = fraction of in-budget events in the window,
  error-budget burn = error_rate / error_budget.  An objective is
  *burning* only when BOTH windows burn ≥ the threshold — a transient
  spike (fast only) or an already-recovered incident (slow only) does
  not flip health.
- **Node health with hysteresis** — ``healthy | degraded(reasons) |
  unhealthy(reasons)`` from the burning objectives' severities; a new
  state must hold for N consecutive evaluations before the node
  transitions.  Transitions land in the slot trace
  (``health_transition`` instants, cat ``slo``), the transition log,
  and the ``node_health_state`` gauge.
- **Surfaces** — labeled Prometheus families (``slo_attainment``,
  ``slo_budget_burn`` keyed by objective × window), HTTP routes
  ``/lighthouse/slo`` (full per-objective detail + the worst offending
  slots' trace links) and ``/lighthouse/health`` (the operator's
  one-look answer; 503 when unhealthy).

The windows, budgets and hysteresis are the constants below; the engine
has no off switch.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from dataclasses import dataclass, replace
from typing import Callable, Deque, Dict, List, Optional, Tuple

from .metrics import REGISTRY
from .tracing import TRACER

HEALTHY = "healthy"
DEGRADED = "degraded"
UNHEALTHY = "unhealthy"
_STATE_LEVEL = {HEALTHY: 0, DEGRADED: 1, UNHEALTHY: 2}

FAST_WINDOW_S = 60.0        # fast-burn rolling window (SRE short window)
SLOW_WINDOW_S = 360.0       # slow-burn rolling window (SRE long window)
HYSTERESIS = 2              # evaluations a new health state must hold
BLOCK_IMPORT_MS = 150.0     # block_import: p99 wall budget per import
SHED_PCT = 0.1              # shed_rate: max percent of messages shed
FALLBACK_PCT = 1.0          # host_fallback_rate: max percent of dispatches
PROOF_SERVE_MS = 50.0       # proof_serve: p99 wall budget per request
BURN_THRESHOLD = 1.0        # burn both windows must reach to count
# A single out-of-budget event can never flip health: with p99-style
# targets over small windows, one scheduler stall would otherwise read
# as burn >> 1 (1 bad of 24 events = 4x budget).  Windows must hold at
# least this much bad mass.
MIN_BAD_EVENTS = 2.0


@dataclass(frozen=True)
class Objective:
    """One service-level objective.

    ``kind="latency"``: ``percentile`` of the feed's events must fall
    at or under ``budget`` seconds (attainment target = percentile).
    ``kind="ratio"``: the feed's bad/total rate must stay under
    ``budget`` (attainment target = 1 - budget).
    ``severity`` is the health state a sustained violation drives.
    ``trace_cat`` names the slot-trace category whose record-time
    per-slot stats attribute the worst offending slots."""
    name: str
    feed: str
    kind: str                       # "latency" | "ratio"
    budget: float                   # seconds (latency) | fraction (ratio)
    percentile: float = 0.99
    severity: str = DEGRADED
    trace_cat: Optional[str] = None
    description: str = ""


def default_objectives(slot_seconds: float = 12.0) -> Tuple[Objective, ...]:
    """The standing node objectives."""
    return (
        Objective(
            "gossip_to_verified", feed="gossip_to_verified",
            kind="latency", budget=float(slot_seconds) / 3.0,
            percentile=0.99, severity=DEGRADED,
            trace_cat="verification_service",
            description="p99 gossip-arrival → verified latency within "
                        "a third of the slot"),
        Objective(
            "block_import", feed="block_import", kind="latency",
            budget=BLOCK_IMPORT_MS / 1e3,
            percentile=0.99, severity=DEGRADED, trace_cat="block_import",
            description="p99 block-import wall within the per-block "
                        "budget"),
        Objective(
            "shed_rate", feed="shed_rate", kind="ratio",
            budget=SHED_PCT / 100.0,
            severity=UNHEALTHY,
            description="messages shed under overload / messages "
                        "submitted"),
        Objective(
            "import_failure_rate", feed="import_failure_rate",
            kind="ratio", budget=0.05, severity=UNHEALTHY,
            description="block imports dying on INFRASTRUCTURE errors "
                        "(store/device) over successes + such failures "
                        "— peer-protocol rejections excluded from both "
                        "sides, so junk gossip can neither burn nor "
                        "dilute it; a latency-only objective would "
                        "read an import-dead node as healthy (empty "
                        "window)"),
        Objective(
            "host_fallback_rate", feed="host_fallback_rate", kind="ratio",
            budget=FALLBACK_PCT / 100.0,
            severity=DEGRADED,
            description="dispatches served by the host oracle / total "
                        "dispatches"),
        Objective(
            "block_production_ms", feed="block_production",
            kind="latency", budget=float(slot_seconds) / 3.0,
            percentile=0.99, severity=DEGRADED,
            description="p99 end-to-end block production (adopt "
                        "pre-advanced state → device pack → assemble) "
                        "within a third of the slot — a proposer that "
                        "misses this window forfeits the proposal"),
        Objective(
            "proof_serve_ms", feed="proof_serve", kind="latency",
            budget=PROOF_SERVE_MS / 1e3,
            percentile=0.99, severity=DEGRADED,
            description="p99 proof-request wall (light-client branches + "
                        "state proofs off the device proof engine) — the "
                        "serving plane must not stall behind imports"),
    )


# ---------------------------------------------------------------------------
# Histogram window math (pure functions — pinned against a hand-computed
# oracle in tests/test_slo.py).
# ---------------------------------------------------------------------------

def events_within(buckets: Tuple[float, ...], counts, budget: float
                  ) -> float:
    """Events with value ≤ ``budget`` from per-bucket ``counts``
    (``len(buckets) + 1`` entries, last = +Inf overflow), linearly
    interpolated within the straddling bucket.  Budgets beyond the last
    finite bound count the overflow bucket as OUT of budget
    (conservative: overflow values are unbounded)."""
    total = 0.0
    lo = 0.0
    for i, b in enumerate(buckets):
        if budget >= b:
            total += counts[i]
        else:
            if budget > lo:
                total += counts[i] * (budget - lo) / (b - lo)
            return total
        lo = b
    return total


def hist_quantile(buckets: Tuple[float, ...], counts, q: float
                  ) -> Optional[float]:
    """Interpolated quantile of a per-bucket histogram; ``None`` on an
    empty window.  A rank landing in the overflow bucket reports the
    last finite bound (a lower bound on the true quantile)."""
    total = sum(counts)
    if total <= 0:
        return None
    rank = q * total
    cum = 0.0
    lo = 0.0
    for i, b in enumerate(buckets):
        c = counts[i]
        if c > 0 and cum + c >= rank:
            return lo + (b - lo) * max(rank - cum, 0.0) / c
        cum += c
        lo = b
    return lo


def _diff_state(cur, base):
    """Window delta of two cumulative feed states (clamped ≥ 0 so a
    counter reset degrades to an empty window, never negatives)."""
    if cur is None:
        return None
    if cur[0] == "hist":
        _tag, buckets, counts, total = cur
        if base is None or base[0] != "hist":
            return ("hist", buckets, counts, total)
        b_counts, b_total = base[2], base[3]
        d = tuple(max(0, c - b) for c, b in zip(counts, b_counts))
        return ("hist", buckets, d, max(0, total - b_total))
    if cur[0] == "ratio":
        _tag, bad, total = cur
        if base is None or base[0] != "ratio":
            return ("ratio", max(0, bad), max(0, total))
        return ("ratio", max(0, bad - base[1]), max(0, total - base[2]))
    return None


# ---------------------------------------------------------------------------
# The engine
# ---------------------------------------------------------------------------

class SloEngine:
    """Continuous SLO evaluation + node health for one chain.

    Feeds are zero-argument callables returning a cumulative state —
    ``("hist", buckets, per_bucket_counts, total)`` or
    ``("ratio", bad, total)`` — or ``None`` when the source does not
    exist yet.  :meth:`evaluate` snapshots every feed, diffs against
    the snapshot at each window's edge, and derives attainment /
    burn / health.  Thread-safe; gauges are process-global families
    (one evaluating node per process owns them — the simulator's extra
    nodes overwrite labels, same contract as the validator monitor)."""

    MAX_SNAPS = 512  # hard bound independent of evaluation cadence

    def __init__(self, objectives: Optional[Tuple[Objective, ...]] = None,
                 *, clock=time.monotonic,
                 min_eval_interval_s: float = 1.0):
        self.fast_window_s = FAST_WINDOW_S
        self.slow_window_s = SLOW_WINDOW_S
        self.hysteresis = HYSTERESIS
        self.min_eval_interval_s = float(min_eval_interval_s)
        self._clock = clock
        self._objectives: Dict[str, Objective] = {
            o.name: o for o in (objectives if objectives is not None
                                else default_objectives())}
        self._feeds: Dict[str, Callable[[], object]] = {}
        self._lock = threading.Lock()
        # Whole-evaluation serialization: the timer tick and an HTTP
        # refresh can evaluate concurrently; the health state machine
        # (pending counts, transition log) assumes one stepper.
        self._eval_lock = threading.Lock()
        self._snaps: Deque[Tuple[float, dict]] = deque()  # guarded-by: _lock
        self.state = HEALTHY
        self.state_since = self._clock()
        self.transitions: Deque[dict] = deque(maxlen=64)
        self._pending_state: Optional[str] = None
        self._pending_n = 0
        self._current_reasons: List[str] = []
        self._last_report: Optional[dict] = None
        self._last_eval_t: Optional[float] = None
        self._g_att = REGISTRY.gauge(
            "slo_attainment", "windowed SLO attainment per objective",
            labelnames=("objective", "window"))
        self._g_burn = REGISTRY.gauge(
            "slo_budget_burn", "error-budget burn rate per objective",
            labelnames=("objective", "window"))
        self._g_health = REGISTRY.gauge(
            "node_health_state",
            "node health (0 healthy, 1 degraded, 2 unhealthy)")

    # -- registry ------------------------------------------------------------

    def register_feed(self, name: str, fn: Callable[[], object]) -> None:
        self._feeds[name] = fn

    def add_objective(self, objective: Objective) -> None:
        self._objectives[objective.name] = objective

    def set_budget(self, name: str, budget: float) -> None:
        """Override one objective's budget (a sustained-load harness
        scales gossip_to_verified to its compressed slot)."""
        self._objectives[name] = replace(self._objectives[name],
                                         budget=float(budget))

    def objectives(self) -> List[Objective]:
        return list(self._objectives.values())

    # -- evaluation ----------------------------------------------------------

    def tick(self, now: Optional[float] = None) -> Optional[dict]:
        """Rate-limited :meth:`evaluate` — the per-slot-task hook (a
        harness looping per_slot_task hundreds of times per second must
        not snapshot every call).  The interval check-and-set runs
        under the evaluation lock: two concurrent tickers (timer thread
        + an HTTP scrape) must not both pass it, or the hysteresis
        counter steps faster than the configured cadence."""
        with self._eval_lock:
            now = self._clock() if now is None else now
            if self._last_eval_t is not None and \
                    now - self._last_eval_t < self.min_eval_interval_s:
                return None
            return self._evaluate_locked(now)

    def evaluate(self, now: Optional[float] = None) -> dict:
        """One evaluation: snapshot feeds, window-diff, health step.
        Returns (and stores) the full report dict."""
        with self._eval_lock:
            return self._evaluate_locked(now)

    def _evaluate_locked(self, now: Optional[float]) -> dict:
        now = self._clock() if now is None else now
        self._last_eval_t = now
        cur: dict = {}
        # list() snapshots: register_feed/add_objective are legal on a
        # live engine from another thread — iterating the dicts raw
        # would RuntimeError mid-tick on a concurrent registration.
        for name, fn in list(self._feeds.items()):
            try:
                cur[name] = fn()
            except Exception:  # noqa: BLE001 — a broken feed reads as
                cur[name] = None  # "no data", never kills the evaluator
        with self._lock:
            self._snaps.append((now, cur))
            horizon = now - self.slow_window_s
            # Keep ONE snapshot at/behind the slow edge as its baseline.
            while len(self._snaps) > 2 and self._snaps[1][0] <= horizon:
                self._snaps.popleft()
            while len(self._snaps) > self.MAX_SNAPS:
                self._snaps.popleft()
            snaps = list(self._snaps)
        # A capped deque whose oldest snapshot is younger than the slow
        # window means the cap — not startup — bounds the window: say
        # so instead of silently burning over a shorter span than
        # SLOW_WINDOW_S (span_s on each window row carries the
        # actual coverage).
        slow_truncated = (len(snaps) >= self.MAX_SNAPS
                          and now - snaps[0][0] < self.slow_window_s)
        slot_stats = TRACER.slot_stats() if TRACER.enabled else []
        rows = []
        burning: List[Objective] = []
        for obj in list(self._objectives.values()):
            row = self._eval_objective(obj, cur.get(obj.feed), snaps, now,
                                       slot_stats)
            rows.append(row)
            if row["burning"]:
                burning.append(obj)
        reasons = [o.name for o in burning]
        candidate = HEALTHY
        for o in burning:
            if _STATE_LEVEL.get(o.severity, 1) > _STATE_LEVEL[candidate]:
                candidate = o.severity
        self._health_step(candidate, reasons, now)
        report = {
            "state": self.state,
            "since": round(self.state_since, 3),
            "reasons": (list(self._current_reasons)
                        if self.state != HEALTHY else []),
            "burning": reasons,
            "windows": {"fast_s": self.fast_window_s,
                        "slow_s": self.slow_window_s,
                        "slow_truncated_by_snapshot_cap": slow_truncated},
            "hysteresis": self.hysteresis,
            "objectives": rows,
            "transitions": list(self.transitions),
            "evaluated_at": round(now, 3),
        }
        self._last_report = report
        return report

    def _baseline(self, snaps, now: float, window_s: float):
        """Newest snapshot at/behind the window edge (else the oldest —
        a short-lived process measures since start)."""
        edge = now - window_s
        base = snaps[0]
        for snap in snaps:
            if snap[0] <= edge:
                base = snap
            else:
                break
        return base

    def _eval_window(self, obj: Objective, cur_state, snaps, now,
                     window_s: float) -> dict:
        base_t, base = self._baseline(snaps, now, window_s)
        d = _diff_state(cur_state, base.get(obj.feed))
        out: dict = {"window_s": window_s,
                     "span_s": round(max(now - base_t, 0.0), 3),
                     "events": 0, "attainment": None, "burn": None}
        if d is None:
            return out
        if obj.kind == "latency" and d[0] == "hist":
            _tag, buckets, counts, total = d
            out["events"] = int(total)
            if buckets and obj.budget > buckets[-1]:
                # The feed cannot resolve a budget above its top finite
                # bound: overflow events are indistinguishable from
                # in-budget ones there, and counting them out-of-budget
                # (the normal conservative rule) would FALSELY burn an
                # objective whose every event meets the raised budget.
                out["note"] = (f"budget {obj.budget}s beyond histogram "
                               f"resolution ({buckets[-1]}s) — not "
                               f"measurable")
                return out
            # The overflow bucket is part of the event count even though
            # interpolation never credits it as in-budget.
            n = sum(counts)
            if n > 0:
                good = events_within(buckets, counts, obj.budget)
                att = min(good / n, 1.0)
                out["bad"] = round(n - good, 3)
                out["attainment"] = round(att, 6)
                err_budget = 1.0 - obj.percentile
                # 1e9 caps stand in for infinity: the JSON surfaces
                # must stay strict-parseable (Infinity is not JSON).
                out["burn"] = round((1.0 - att) / err_budget, 3) \
                    if err_budget > 0 else (0.0 if att >= 1.0 else 1e9)
                p50 = hist_quantile(buckets, counts, 0.50)
                p99 = hist_quantile(buckets, counts, 0.99)
                out["p50_ms"] = None if p50 is None else round(p50 * 1e3, 2)
                out["p99_ms"] = None if p99 is None else round(p99 * 1e3, 2)
        elif obj.kind == "ratio" and d[0] == "ratio":
            _tag, bad, total = d
            out["events"] = int(total)
            if total > 0:
                rate = bad / total
                out["bad"] = int(bad)
                out["rate"] = round(rate, 6)
                out["attainment"] = round(1.0 - rate, 6)
                if obj.budget > 0:
                    out["burn"] = round(rate / obj.budget, 3)
                else:
                    out["burn"] = 0.0 if rate == 0 else 1e9
        return out

    def _eval_objective(self, obj: Objective, cur_state, snaps, now,
                        slot_stats) -> dict:
        fast = self._eval_window(obj, cur_state, snaps, now,
                                 self.fast_window_s)
        slow = self._eval_window(obj, cur_state, snaps, now,
                                 self.slow_window_s)
        # SRE multi-window rule: page only when BOTH windows burn — the
        # fast window confirms it is happening NOW, the slow window that
        # it is material against the budget — and both hold at least
        # MIN_BAD_EVENTS of bad mass (a lone straggler never pages).
        burning = (fast["burn"] is not None and slow["burn"] is not None
                   and fast["burn"] >= BURN_THRESHOLD
                   and slow["burn"] >= BURN_THRESHOLD
                   and fast.get("bad", 0.0) >= MIN_BAD_EVENTS
                   and slow.get("bad", 0.0) >= MIN_BAD_EVENTS)
        for label, win in (("fast", fast), ("slow", slow)):
            # An empty window exports the NEUTRAL values (no events =
            # no errors): skipping the write would leave an incident's
            # last burn value frozen on /metrics forever after traffic
            # stops, paging on an incident that ended.
            att = win["attainment"]
            burn = win["burn"]
            self._g_att.labels(obj.name, label).set(
                1.0 if att is None else att)
            self._g_burn.labels(obj.name, label).set(
                0.0 if burn is None else min(burn, 1e9))
        row = {
            "name": obj.name, "kind": obj.kind, "feed": obj.feed,
            "severity": obj.severity, "description": obj.description,
            "budget": obj.budget, "burning": burning,
            "fast": fast, "slow": slow,
        }
        if obj.kind == "latency":
            row["percentile"] = obj.percentile
            row["budget_ms"] = round(obj.budget * 1e3, 2)
        if obj.trace_cat and slot_stats:
            # Top-3 HEAVIEST slots by the category's max span — no
            # budget filter: the spans are stage costs, not the feed's
            # end-to-end latency (a queue-wait burn has ms-scale
            # dispatch spans), so a threshold would return [] exactly
            # when the operator needs somewhere to look.
            worst = []
            for s in slot_stats:
                st = s["stats"].get(obj.trace_cat)
                if st is not None:
                    worst.append({"slot": s["slot"],
                                  "max_ms": st["max_ms"],
                                  "trace": f"/lighthouse/tracing/slot/"
                                           f"{s['slot']}"})
            worst.sort(key=lambda w: -w["max_ms"])
            row["worst_slots"] = worst[:3]
        return row

    # -- health state machine ------------------------------------------------

    def _health_step(self, candidate: str, reasons: List[str],
                     now: float) -> None:
        """Hysteresis: a candidate state must hold ``hysteresis``
        consecutive evaluations before the node transitions (both
        directions — flapping feeds can neither degrade nor clear the
        node on one sample)."""
        if candidate == self.state:
            self._pending_state = None
            self._pending_n = 0
            if candidate != HEALTHY:
                self._current_reasons = reasons
            return
        if candidate == self._pending_state:
            self._pending_n += 1
        else:
            self._pending_state = candidate
            self._pending_n = 1
        if self._pending_n < self.hysteresis:
            return
        old = self.state
        self.state = candidate
        self.state_since = now
        self._current_reasons = reasons if candidate != HEALTHY else []
        self._pending_state = None
        self._pending_n = 0
        self.transitions.append({
            "t": round(now, 3), "from": old, "to": candidate,
            "reasons": list(reasons)})
        self._g_health.set(float(_STATE_LEVEL[candidate]))
        if TRACER.enabled:
            TRACER.instant("health_transition", cat="slo",
                           from_state=old, to_state=candidate,
                           reasons=",".join(reasons))

    # -- surfaces ------------------------------------------------------------

    def report(self, refresh: bool = False) -> dict:
        """Last evaluation (optionally refreshed) — the
        ``/lighthouse/slo`` body."""
        if refresh:
            return self.evaluate()
        if self._last_report is not None:
            return self._last_report
        return {
            "state": self.state, "since": round(self.state_since, 3),
            "reasons": [], "burning": [],
            "windows": {"fast_s": self.fast_window_s,
                        "slow_s": self.slow_window_s},
            "hysteresis": self.hysteresis,
            "objectives": [], "transitions": list(self.transitions),
            "evaluated_at": None,
        }

    def health(self) -> dict:
        """The one-look answer — the ``/lighthouse/health`` body."""
        return {
            "state": self.state,
            "reasons": (list(self._current_reasons)
                        if self.state != HEALTHY else []),
            "since": round(self.state_since, 3),
            "transitions": len(self.transitions),
        }


# ---------------------------------------------------------------------------
# Chain wiring — the default feeds, all record-time aggregates.
# ---------------------------------------------------------------------------

def wire_chain_feeds(engine: SloEngine, chain) -> None:
    """Attach the standard feeds for one chain.  Every feed reads a
    cumulative record-time aggregate owned by the source subsystem —
    the service's local latency histogram, the chain's import
    histogram, the service/envelope counters — never per-event lists.
    Feeds resolve ``chain.verification_service`` at call time (the
    network layer attaches it after chain construction)."""

    def gossip_to_verified():
        svc = chain.verification_service
        if svc is None:
            return None
        buckets, counts, total, _sum = svc.latency_snapshot()
        return ("hist", buckets, counts, total)

    def block_import():
        buckets, counts, total, _sum = chain._slo_import_hist.snapshot()
        return ("hist", buckets, counts, total)

    def shed_rate():
        svc = chain.verification_service
        if svc is None:
            return ("ratio", 0, 0)
        ctr = svc.slo_counters()
        return ("ratio", ctr.get("shed", 0), ctr.get("submitted", 0))

    def import_failure_rate():
        return ("ratio", chain._slo_import_failures,
                chain._slo_import_attempts)

    def host_fallback_rate():
        svc = chain.verification_service
        if svc is None:
            return ("ratio", 0, 0)
        bad = good = 0
        for env in (svc.envelope, svc.kzg_envelope):
            snap = env.snapshot()
            bad += snap.get("host_fallbacks", 0)
            good += snap.get("device_ok", 0)
        return ("ratio", bad, bad + good)

    def proof_serve():
        # Raw attribute, NOT the lazy property — a feed evaluation must
        # never construct the proof server; before the first proof
        # request the objective simply has no window.
        srv = getattr(chain, "_proof_server", None)
        if srv is None:
            return None
        buckets, counts, total, _sum = srv.latency_snapshot()
        return ("hist", buckets, counts, total)

    def block_production():
        buckets, counts, total, _sum = \
            chain._slo_production_hist.snapshot()
        return ("hist", buckets, counts, total)

    engine.register_feed("gossip_to_verified", gossip_to_verified)
    engine.register_feed("block_production", block_production)
    engine.register_feed("block_import", block_import)
    engine.register_feed("shed_rate", shed_rate)
    engine.register_feed("import_failure_rate", import_failure_rate)
    engine.register_feed("host_fallback_rate", host_fallback_rate)
    engine.register_feed("proof_serve", proof_serve)
