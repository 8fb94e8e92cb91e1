"""Device ledger — transfer, dispatch, compile and residency accounting,
per subsystem.

Port of ``lighthouse_tpu/common/device_ledger.py``: ONE process-wide,
thread-safe accounting layer that every device subsystem of the port
reports into, attributed by the fixed :data:`SUBSYSTEMS` enum.

- **transfers** — host→device / device→host bytes and copy counts
  (:meth:`DeviceLedger.note_transfer`).  Every copy of :mod:`..device`
  (``to_device``, ``to_device_async``, ``to_host``) lands here under the
  caller's subsystem: an explicit name, else the *ambient* attribution
  (:meth:`DeviceLedger.attribute`, a thread-local scope the materialize,
  scatter and proof seams set), else ``device_tree``.  This is the one
  store of the port's transfer bytes; ``device.transfer_totals`` and
  ``ops.device_tree.residency_snapshot`` are views of it.
- **dispatches** — device dispatch counts and wall time (the BLS verify,
  the proof gather).
- **compiles** — one ``compiles`` event per nvcc or g++ build that runs
  (``ops/cuda_build.py``, ``crypto/native.py``) and one ``compile_hits``
  event per finished library that loads from the build directory.  (The
  JAX package's jax monitoring listener has no counterpart here.)
- **device-memory residency** — live resident bytes per subsystem with a
  high-water mark, kept by :class:`ResidencyToken` handles that the
  owning objects (DeviceTree, DeviceRegistryMirror, the packed-column
  caches, the proof engine's trees) update at their materialize, scatter
  and drop seams; a dropped owner releases through ``weakref.finalize``.
  :meth:`DeviceLedger.snapshot` adds the caching allocator's own figures
  (``torch.cuda.memory_allocated`` / ``memory_reserved`` /
  ``max_memory_allocated``) when the device is a GPU.
- **the warm-slot budget** (:data:`WARM_SLOT_BUDGET`): per-subsystem
  per-slot byte ceilings on the warm path, checked over the per-slot
  delta ring by :func:`evaluate_budget`.

The ledger is always on: it is the only count of the port's transfer
bytes, so there is no switch that could make a byte check read zeros.
The per-slot delta ring keeps the last :data:`SLOT_RING` closed slots.

This module stays import-cheap (stdlib only at import): ``device.py``
imports it.
"""

from __future__ import annotations

import threading
import weakref
from collections import OrderedDict
from contextlib import contextmanager
from typing import Dict, List, Optional, Tuple

# The fixed attribution enum (the JAX package's).  Every device subsystem
# reports under one of these.
SUBSYSTEMS: Tuple[str, ...] = (
    "bls",              # BLS verify pipeline (sharded + staged + stream)
    "device_tree",      # DeviceTree leaf/level planes (direct use)
    "registry_mirror",  # validator-registry device columns + record tree
    "packed_cache",     # packed-column device caches (balances, …)
    "fork_choice",      # proto-array vote/topology mirrors
    "slasher",          # min/max span planes
    "kzg",              # Deneb blob verification
    "staging",          # ChunkStager / cold-build streaming pushes
    "proof_engine",     # device Merkle-branch extraction / proof serving
    "op_pool",          # block-packing CSR columns + greedy-pack rounds
    "replay",           # epoch-batched replay windows (catch-up sync)
)

# Compile events that fire outside any attribution seam (the smoke
# script's build phase, warm-ups) land here — visible, never miscounted.
UNATTRIBUTED = "unattributed"

_TRANSFER_KEYS = ("h2d_bytes", "h2d_ops", "d2h_bytes", "d2h_ops")
# Per-slot delta keys: transfers + the materialize event count (the
# "cold slot" marker — a slot that materialized is start-up/re-stage
# traffic the HTTP budget view may exclude; the drill never does).
_SLOT_KEYS = _TRANSFER_KEYS + ("materializes",)
# Closed slots the per-slot delta ring keeps (the JAX package's default).
SLOT_RING = 64
_COUNTER_KEYS = _TRANSFER_KEYS + (
    "dispatches", "device_ms", "compiles", "compile_hits",
    "scatters", "rebuilds", "materializes")

# ---------------------------------------------------------------------------
# Warm-slot transfer budget — bytes per subsystem per slot on the WARM
# path.  Semantics (README "Device ledger"): once a subsystem is
# materialized, its per-slot H2D is bounded by dirty fractions and the
# slot's signature/blob batches, and its D2H is bounded by verdict/root
# reads plus the fork-choice weight/bc/bd pulls — a full-column
# round-trip inside a warm slot means residency broke.  The sustained
# drill enforces this (exit 1 on violation); the numbers are deliberate
# ceilings, not targets.
# ---------------------------------------------------------------------------

MiB = 1 << 20

WARM_SLOT_BUDGET: Dict[str, Dict[str, int]] = {
    # Signature batches ARE warm traffic: ~50 KB marshalled per 16-key
    # set, a mainnet slot carries ≲ 2k sets.  Verdicts come back as
    # flags.
    "bls": {"h2d_bytes": 256 * MiB, "d2h_bytes": 1 * MiB},
    # Dirty leaf rows + indices only; a root is a 32-byte pull.
    "device_tree": {"h2d_bytes": 4 * MiB, "d2h_bytes": 1 * MiB},
    # Dirty raw records (121 B each, bucket-padded); 32 B down.
    "registry_mirror": {"h2d_bytes": 8 * MiB, "d2h_bytes": 1 * MiB},
    # Dirty chunk rows of the packed columns; adopted device results
    # push nothing.
    "packed_cache": {"h2d_bytes": 8 * MiB, "d2h_bytes": 1 * MiB},
    # Changed-vote scatters + occasional topology push up; the per-round
    # weight/best-child/best-descendant columns down are the ONE
    # legitimate warm-path pull (≤ ~16 B/node · 100k nodes).
    "fork_choice": {"h2d_bytes": 16 * MiB, "d2h_bytes": 32 * MiB},
    # Bit-packed membership masks (n/8 per group) + per-offence
    # evidence gathers down.
    "slasher": {"h2d_bytes": 64 * MiB, "d2h_bytes": 16 * MiB},
    # Blob polynomials up (128 KB/blob mainnet), verdict down.
    "kzg": {"h2d_bytes": 64 * MiB, "d2h_bytes": 1 * MiB},
    # Cold-build streaming belongs OUTSIDE warm slots: a ChunkStager
    # push mid-slot means a full re-stage leaked onto the hot path.
    "staging": {"h2d_bytes": 0, "d2h_bytes": 0},
    # Proof serving: branches are GATHERED from resident levels, never
    # re-hashed — H2D is one small field-root plane per new head state,
    # D2H is sibling rows (32 B each, bucket-padded).  A budget breach
    # means serving went re-stage-shaped instead of gather-shaped.
    "proof_engine": {"h2d_bytes": 2 * MiB, "d2h_bytes": 2 * MiB},
    # Block packing: the candidate CSR columns (element ids, weights,
    # segment ids, precomputed word/bit planes — ≈ 26 B/entry, a
    # backlogged mainnet pool is a few M entries) go up once per
    # produce; the selection vector coming down is rounds × 4 B.
    "op_pool": {"h2d_bytes": 256 * MiB, "d2h_bytes": 1 * MiB},
    # Catch-up replay belongs OUTSIDE warm slots: a node that is in
    # sync imports via the live pipeline (whose signature traffic is
    # the bls family).  Replay-attributed transfers inside a warm slot
    # mean a backfill/range-sync window leaked onto the hot path.
    "replay": {"h2d_bytes": 0, "d2h_bytes": 0},
}

# Transfer budget of one epoch-batched replay window
# (state_transition/batch_replay.py): the window's signature sets up in
# one dispatch, verdict flags down.  Checked per window by the replayer;
# replay runs at catch-up time, not per slot.
REPLAY_WINDOW_BUDGET: Dict[str, int] = {
    "h2d_bytes": 256 * MiB, "d2h_bytes": 1 * MiB,
}

class ResidencyToken:
    """Live-resident-bytes handle for one device-owning object.

    ``set(nbytes)`` moves this owner's contribution to ``nbytes``
    (delta-applied to the subsystem's live residency + high-water mark);
    ``release()`` drops it.  Owners register a ``weakref.finalize`` so
    garbage collection releases automatically — the drop seam of every
    subsystem that has no explicit close.
    """

    __slots__ = ("_ledger", "subsystem", "_bytes", "_released",
                 "__weakref__")

    def __init__(self, ledger: "DeviceLedger", subsystem: str):
        self._ledger = ledger
        self.subsystem = subsystem
        self._bytes = 0
        self._released = False
        ledger._tokens.add(self)

    def set(self, nbytes: int) -> None:
        if self._released:
            return
        nbytes = max(int(nbytes), 0)
        delta = nbytes - self._bytes
        self._bytes = nbytes
        if delta:
            self._ledger._adjust_resident(self.subsystem, delta)

    @property
    def nbytes(self) -> int:
        return self._bytes

    def release(self) -> None:
        """Idempotent drop (explicit close paths AND the GC finalizer)."""
        if self._released:
            return
        self._released = True
        if self._bytes:
            self._ledger._adjust_resident(self.subsystem, -self._bytes)
            self._bytes = 0


class DeviceLedger:
    """The process-wide accounting layer (singleton :data:`LEDGER`)."""

    def __init__(self):
        # Reentrant: ResidencyToken.release runs as a weakref.finalize
        # GC callback, and a collection can trigger inside any locked
        # section of the SAME thread (an allocation under the lock) —
        # release -> _adjust_resident must then re-enter, not deadlock.
        self._lock = threading.RLock()
        self._tls = threading.local()
        self._sub: Dict[str, Dict[str, float]] = {
            s: dict.fromkeys(_COUNTER_KEYS, 0) for s in SUBSYSTEMS
        }  # guarded-by: _lock
        self._sub[UNATTRIBUTED] = dict.fromkeys(_COUNTER_KEYS, 0)
        self._resident: Dict[str, int] = dict.fromkeys(SUBSYSTEMS, 0)
        self._high: Dict[str, int] = dict.fromkeys(SUBSYSTEMS, 0)
        # Per-slot delta ring: slot → {subsystem: {transfer-key deltas}}.
        self._slot_ring: "OrderedDict[int, dict]" = \
            OrderedDict()  # guarded-by: _lock
        self._last_slot: Optional[int] = None
        self._slot_base: Dict[str, Dict[str, float]] = {}
        self._collector_registered = False
        # Bumped by reset(): a view's re-base mark from before a reset
        # no longer applies (see since()).
        self._generation = 0
        # Live residency tokens (weak): reset() re-seeds resident bytes
        # from these so live device objects never under-report after a
        # test or benchmark reset.
        self._tokens: "weakref.WeakSet[ResidencyToken]" = weakref.WeakSet()

    # -- attribution context -------------------------------------------------

    @contextmanager
    def attribute(self, subsystem: str):
        """Thread-local attribution scope: transfers and events inside the
        ``with`` body that name no subsystem charge ``subsystem``.  Nests
        (innermost wins); crosses no threads — background stagers take an
        explicit ``subsystem=`` instead."""
        assert subsystem in SUBSYSTEMS, subsystem
        stack = getattr(self._tls, "stack", None)
        if stack is None:
            stack = self._tls.stack = []
        stack.append(subsystem)
        try:
            yield
        finally:
            stack.pop()

    def ambient(self) -> Optional[str]:
        stack = getattr(self._tls, "stack", None)
        return stack[-1] if stack else None

    def _resolve(self, subsystem: Optional[str], default: str) -> str:
        if subsystem is not None:
            assert subsystem in SUBSYSTEMS, subsystem
            return subsystem
        return self.ambient() or default

    # -- recording -----------------------------------------------------------

    def note_transfer(self, direction: str, nbytes: int,
                      subsystem: Optional[str] = None,
                      ops: int = 1) -> None:
        """One host→device (``direction="h2d"``) or device→host (``"d2h"``)
        transfer of ``nbytes`` on behalf of ``subsystem`` (default: the
        ambient attribution, else ``device_tree``)."""
        assert direction in ("h2d", "d2h"), direction
        sub = self._resolve(subsystem, "device_tree")
        with self._lock:
            row = self._sub[sub]
            row[f"{direction}_bytes"] += int(nbytes)
            row[f"{direction}_ops"] += int(ops)

    def note_dispatch(self, subsystem: str, wall_ms: float,
                      count: int = 1) -> None:
        """One device dispatch (count) and its wall time."""
        sub = self._resolve(subsystem, "bls")
        with self._lock:
            row = self._sub[sub]
            row["dispatches"] += int(count)
            row["device_ms"] += float(wall_ms)

    def note_compile(self, subsystem: Optional[str] = None,
                     count: int = 1, key: str = "compiles") -> None:
        """One library build that ran (``compiles``) or one finished build
        that loaded (``compile_hits``).  Both are MONOTONIC — net builds
        are derived at read time, never decremented."""
        assert key in ("compiles", "compile_hits"), key
        sub = subsystem if subsystem in SUBSYSTEMS \
            else (self.ambient() or UNATTRIBUTED)
        with self._lock:
            self._sub[sub][key] += int(count)

    def note_event(self, name: str,
                   subsystem: Optional[str] = None) -> None:
        """Residency protocol events (``scatters`` / ``rebuilds`` /
        ``materializes``)."""
        assert name in ("scatters", "rebuilds", "materializes"), name
        sub = self._resolve(subsystem, "device_tree")
        with self._lock:
            self._sub[sub][name] += 1

    # -- residency watermarks ------------------------------------------------

    def residency(self, subsystem: str) -> ResidencyToken:
        assert subsystem in SUBSYSTEMS, subsystem
        return ResidencyToken(self, subsystem)

    def track(self, owner, subsystem: str, nbytes: int) -> ResidencyToken:
        """Token + GC drop seam in one call: ``owner`` going away
        releases the bytes (``weakref.finalize``)."""
        tok = self.residency(subsystem)
        tok.set(nbytes)
        weakref.finalize(owner, ResidencyToken.release, tok)
        return tok

    def _adjust_resident(self, subsystem: str, delta: int) -> None:
        with self._lock:
            cur = self._resident[subsystem] + int(delta)
            self._resident[subsystem] = max(cur, 0)
            if cur > self._high[subsystem]:
                self._high[subsystem] = cur

    # -- per-slot delta ring -------------------------------------------------

    def mark_slot(self, slot: int) -> None:
        """Slot boundary: fold the transfer deltas since the previous
        mark into the ring under the PREVIOUS slot (the interval they
        belong to).  Idempotent per slot value — multiple nodes in one
        process ticking the same wall-clock slot mark once."""
        slot = int(slot)
        with self._lock:
            if slot == self._last_slot:
                return
            if self._last_slot is not None:
                delta = self._delta_locked()
                if any(any(row.values()) for row in delta.values()):
                    self._slot_ring[self._last_slot] = delta
                    while len(self._slot_ring) > SLOT_RING:
                        self._slot_ring.popitem(last=False)
                else:
                    # A quiet interval must also RETIRE a stale entry
                    # under the same key: drills restart slot numbering
                    # within one process, and a previous run's traffic
                    # surviving under this run's slot number would be
                    # evaluated against this run's budget.
                    self._slot_ring.pop(self._last_slot, None)
            self._slot_base = {
                s: {k: self._sub[s][k] for k in _SLOT_KEYS}
                for s in SUBSYSTEMS}
            self._last_slot = slot

    def _delta_locked(self) -> dict:  # lock-held: _lock
        out = {}
        for s in SUBSYSTEMS:
            base = self._slot_base.get(s, {})
            row = {k: int(self._sub[s][k] - base.get(k, 0))
                   for k in _SLOT_KEYS}
            out[s] = row
        return out

    def slot_deltas(self) -> List[dict]:
        """``[{"slot": s, "cold": bool, "subsystems": {name:
        {h2d/d2h bytes+ops, materializes}}}]`` for every closed slot
        still in the ring, oldest first — the /lighthouse/device
        per-slot view and the budget check's input.  ``cold`` marks a
        slot in which a materialization ran (start-up / re-stage
        traffic).  Only subsystems with nonzero activity appear."""
        with self._lock:
            return [{"slot": s,
                     "cold": any(row.get("materializes")
                                 for row in d.values()),
                     "subsystems": {n: dict(row)
                                    for n, row in d.items()
                                    if any(row.values())}}
                    for s, d in self._slot_ring.items()]

    def current_slot_delta(self) -> dict:
        """Transfer deltas of the OPEN slot (since the last mark)."""
        with self._lock:
            return self._delta_locked()

    # -- reads ---------------------------------------------------------------

    def snapshot(self) -> dict:
        """Consistent full-ledger copy: per-subsystem counters and
        residency watermarks, plus the caching allocator's figures
        (``cuda_memory``) when the port's device is a GPU."""
        with self._lock:
            subs = {}
            for s in SUBSYSTEMS:
                row = {k: (round(v, 3) if k == "device_ms" else int(v))
                       for k, v in self._sub[s].items()}
                row["resident_bytes"] = self._resident[s]
                row["high_water_bytes"] = self._high[s]
                row["compiles_net"] = max(
                    row["compiles"] - row["compile_hits"], 0)
                subs[s] = row
            un = self._sub[UNATTRIBUTED]
            out = {
                "subsystems": subs,
                "unattributed_compiles": int(un["compiles"]),
                "unattributed_compile_hits": int(un["compile_hits"]),
            }
        out["cuda_memory"] = _cuda_memory()
        return out

    def subsystem_totals(self, subsystems: Tuple[str, ...]
                         ) -> Dict[str, float]:
        """Counter sums over a subsystem subset (the RESIDENCY_STATS
        view sums only its historical feeders)."""
        with self._lock:
            return self._sums_locked(subsystems)

    def _sums_locked(self, subsystems: Tuple[str, ...]
                     ) -> Dict[str, float]:  # lock-held: _lock
        out = dict.fromkeys(_COUNTER_KEYS, 0.0)
        for s in subsystems:
            for k in _COUNTER_KEYS:
                out[k] += self._sub[s][k]
        return out

    # -- re-basing views -----------------------------------------------------

    def mark(self, subsystems: Tuple[str, ...]) -> tuple:
        """A re-base point for a view over ``subsystems``: the ledger's
        reset generation and its counter sums there."""
        with self._lock:
            return self._generation, self._sums_locked(subsystems)

    def since(self, mark: Optional[tuple], subsystems: Tuple[str, ...]
              ) -> Dict[str, float]:
        """Counter sums over ``subsystems`` since ``mark`` (from
        :meth:`mark`), or since the last :meth:`reset` where that came
        after the mark.  The counters only grow between resets, so a
        negative delta is a fault and raises."""
        with self._lock:
            now = self._sums_locked(subsystems)
            current = mark is not None and mark[0] == self._generation
        base = mark[1] if current else {}
        out = {k: v - base.get(k, 0) for k, v in now.items()}
        behind = {k: v for k, v in out.items() if v < 0}
        if behind:
            raise RuntimeError(f"device ledger counters of {subsystems} "
                               f"ran backwards since the re-base: {behind}")
        return out

    def transfer_totals(self) -> Dict[str, Tuple[int, int]]:
        """Cheap per-subsystem ``(h2d_bytes, d2h_bytes)`` read — the
        hot-path span-attribution snapshot (no rounding, no nested
        dict copies; the full :meth:`snapshot` is the HTTP/report
        surface)."""
        with self._lock:
            return {s: (int(self._sub[s]["h2d_bytes"]),
                        int(self._sub[s]["d2h_bytes"]))
                    for s in SUBSYSTEMS}

    def reset(self) -> None:
        """Zero every counter and the slot ring (bench rows and tests;
        a live node never resets — Prometheus counters must stay
        monotonic).  Residency is RE-SEEDED from the live tokens, not
        zeroed: device objects created before the reset still hold
        their device memory, and zeroing under them would make every later
        token delta land on a stale base (permanent under-report)."""
        with self._lock:
            for row in self._sub.values():
                for k in row:
                    row[k] = 0
            for s in SUBSYSTEMS:
                self._resident[s] = 0
                self._high[s] = 0
            self._slot_ring.clear()
            self._slot_base = {}
            self._last_slot = None
            self._generation += 1
        for tok in list(self._tokens):
            if not tok._released and tok._bytes:
                self._adjust_resident(tok.subsystem, tok._bytes)

    # -- Prometheus ----------------------------------------------------------

    def register_metrics(self) -> None:
        """Register the scrape-time collector exporting the labeled
        families (idempotent; a bare library import never touches the
        registry)."""
        if self._collector_registered:
            return
        self._collector_registered = True
        from .metrics import REGISTRY
        REGISTRY.register_collector(self._collect)

    @staticmethod
    def _set_child(family, labels: tuple, value: float) -> None:
        child = family.labels(*labels)
        with child._lock:
            child.value = float(value)

    def _collect(self) -> None:
        from .metrics import REGISTRY
        snap = self.snapshot()
        f_bytes = REGISTRY.counter(
            "device_transfer_bytes_total",
            "host<->device transfer bytes by subsystem",
            labelnames=("subsystem", "direction"))
        f_ops = REGISTRY.counter(
            "device_transfer_ops_total",
            "host<->device transfer operations by subsystem",
            labelnames=("subsystem", "direction"))
        f_res = REGISTRY.gauge(
            "device_resident_bytes",
            "live device-resident bytes by subsystem",
            labelnames=("subsystem",))
        f_high = REGISTRY.gauge(
            "device_high_water_bytes",
            "high-water device residency by subsystem",
            labelnames=("subsystem",))
        f_disp = REGISTRY.counter(
            "device_dispatches_total",
            "device dispatches by subsystem",
            labelnames=("subsystem",))
        f_verify = REGISTRY.counter(
            "device_verify_seconds_total",
            "device dispatch wall time by subsystem",
            labelnames=("subsystem",))
        f_comp = REGISTRY.counter(
            "device_compiles_total",
            "library builds that ran, by subsystem",
            labelnames=("subsystem",))
        f_hits = REGISTRY.counter(
            "device_compile_cache_hits_total",
            "finished library builds loaded, by subsystem",
            labelnames=("subsystem",))
        with self._lock:
            un_requests = int(self._sub[UNATTRIBUTED]["compiles"])
            un_hits = int(self._sub[UNATTRIBUTED]["compile_hits"])
        for s, row in snap["subsystems"].items():
            self._set_child(f_bytes, (s, "h2d"), row["h2d_bytes"])
            self._set_child(f_bytes, (s, "d2h"), row["d2h_bytes"])
            self._set_child(f_ops, (s, "h2d"), row["h2d_ops"])
            self._set_child(f_ops, (s, "d2h"), row["d2h_ops"])
            self._set_child(f_res, (s,), row["resident_bytes"])
            self._set_child(f_high, (s,), row["high_water_bytes"])
            self._set_child(f_disp, (s,), row["dispatches"])
            self._set_child(f_verify, (s,), row["device_ms"] / 1e3)
            # BOTH monotonic — net recompiles = requests − hits is a
            # query-time derivation, never a decremented counter.
            self._set_child(f_comp, (s,), row["compiles"])
            self._set_child(f_hits, (s,), row["compile_hits"])
        self._set_child(f_comp, (UNATTRIBUTED,), un_requests)
        self._set_child(f_hits, (UNATTRIBUTED,), un_hits)


def _cuda_memory() -> Optional[dict]:
    """The caching allocator's byte figures for the port's device, or None
    when it is not a GPU (imported late: ``device.py`` imports this
    module)."""
    import torch

    from .. import device as D
    dev = D.default_device()
    if dev.type != "cuda" or not torch.cuda.is_available():
        return None
    return {"memory_allocated": int(torch.cuda.memory_allocated(dev)),
            "memory_reserved": int(torch.cuda.memory_reserved(dev)),
            "max_memory_allocated":
                int(torch.cuda.max_memory_allocated(dev))}


# ---------------------------------------------------------------------------
# Warm-slot budget evaluation
# ---------------------------------------------------------------------------

def evaluate_budget(slot_deltas: List[dict],
                    budget: Optional[Dict[str, Dict[str, int]]] = None,
                    include_cold: bool = True) -> dict:
    """Check per-slot transfer deltas against the warm-slot budget.

    ``slot_deltas`` is :meth:`DeviceLedger.slot_deltas` output (possibly
    filtered to the measured slots).  Returns the SLO-style row: one
    entry per (subsystem, direction) with a declared budget —
    worst-slot bytes, violating slots, ok — plus ``attainment`` (the
    fraction of slot×budget cells inside budget) and the overall
    verdict ``ok``.  An empty window attains 1.0 vacuously (a fresh
    node is not in violation).

    ``include_cold=False`` skips slots in which a materialization ran
    (reported in ``cold_slots_skipped``, never silently) — the HTTP
    scoreboard's view, where a fresh node's start-up staging must not
    read as a warm-path violation.  The sustained drill keeps the
    default: its measured slots follow the warm-up, so a mid-run
    re-materialize is exactly the regression it must catch."""
    budget = WARM_SLOT_BUDGET if budget is None else budget
    cold_skipped = []
    if not include_cold:
        cold_skipped = [d["slot"] for d in slot_deltas if d.get("cold")]
        slot_deltas = [d for d in slot_deltas if not d.get("cold")]
    rows = []
    cells = 0
    ok_cells = 0
    for sub in sorted(budget):
        for direction in ("h2d", "d2h"):
            limit = budget[sub].get(f"{direction}_bytes")
            if limit is None:
                continue
            worst = 0
            worst_slot = None
            violations = []
            for entry in slot_deltas:
                used = entry["subsystems"].get(sub, {}).get(
                    f"{direction}_bytes", 0)
                cells += 1
                if used <= limit:
                    ok_cells += 1
                else:
                    violations.append(entry["slot"])
                if used > worst:
                    worst = used
                    worst_slot = entry["slot"]
            rows.append({
                "subsystem": sub, "direction": direction,
                "budget_bytes": limit, "worst_slot_bytes": worst,
                "worst_slot": worst_slot,
                "violations": violations,
                "ok": not violations,
            })
    return {
        "slots_checked": len(slot_deltas),
        "cold_slots_skipped": cold_skipped,
        "attainment": round(ok_cells / cells, 6) if cells else 1.0,
        "ok": all(r["ok"] for r in rows),
        "rows": rows,
    }


# The process ledger + module-level conveniences.
LEDGER = DeviceLedger()

attribute = LEDGER.attribute
note_transfer = LEDGER.note_transfer
note_dispatch = LEDGER.note_dispatch
note_compile = LEDGER.note_compile
note_event = LEDGER.note_event
mark_slot = LEDGER.mark_slot
