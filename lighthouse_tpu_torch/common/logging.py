"""Structured logging — ``common/logging``
(``common/logging/src/lib.rs:28,196,221``; port of
``lighthouse_tpu/common/logging.py``): slog-style
key=value records with the reference's aligned terminal format, a ring
buffer for SSE re-broadcast (the ``/lighthouse/logs`` stream), and a
capture logger for tests."""

from __future__ import annotations

import sys
import threading
import time
from collections import deque
from typing import Deque, List

LEVELS = {"TRCE": 0, "DEBG": 1, "INFO": 2, "WARN": 3, "ERRO": 4, "CRIT": 5}


class Logger:
    """Key-value structured logger with slog-ish aligned output."""

    def __init__(self, name: str = "", level: str = "INFO",
                 stream=None, ring_size: int = 1024):
        self.name = name
        self.level = level
        self.stream = stream if stream is not None else sys.stderr
        self.ring: Deque[dict] = deque(maxlen=ring_size)
        self._lock = threading.Lock()
        self._subscribers: List = []

    def child(self, name: str) -> "Logger":
        out = Logger.__new__(Logger)
        out.__dict__.update(self.__dict__)
        out.name = f"{self.name}/{name}" if self.name else name
        return out

    def _log(self, level: str, msg: str, **kv) -> None:
        if LEVELS[level] < LEVELS[self.level]:
            return
        rec = {"ts": time.time(), "level": level, "module": self.name,
               "msg": msg, **kv}
        line = self.format(rec)
        with self._lock:
            self.ring.append(rec)
            if self.stream is not None:
                print(line, file=self.stream)
            for fn in self._subscribers:
                fn(rec)

    @staticmethod
    def format(rec: dict) -> str:
        ts = time.strftime("%b %d %H:%M:%S", time.localtime(rec["ts"]))
        kv = ", ".join(f"{k}: {v}" for k, v in rec.items()
                       if k not in ("ts", "level", "module", "msg"))
        mod = f" [{rec['module']}]" if rec["module"] else ""
        base = f"{ts} {rec['level']}{mod} {rec['msg']:<40}"
        return f"{base} {kv}" if kv else base

    def subscribe(self, fn) -> None:
        """SSE-rebroadcast hook (`logging/src/lib.rs` SSEDrain role)."""
        self._subscribers.append(fn)

    def trace(self, msg, **kv):
        self._log("TRCE", msg, **kv)

    def debug(self, msg, **kv):
        self._log("DEBG", msg, **kv)

    def info(self, msg, **kv):
        self._log("INFO", msg, **kv)

    def warn(self, msg, **kv):
        self._log("WARN", msg, **kv)

    def error(self, msg, **kv):
        self._log("ERRO", msg, **kv)

    def crit(self, msg, **kv):
        self._log("CRIT", msg, **kv)


def test_logger() -> Logger:
    """Capture-only logger (`test_logger`): records to the ring, no IO
    (``stream=None`` in the constructor means stderr, so it is cleared
    after)."""
    log = Logger(level="TRCE")
    log.stream = None
    return log
