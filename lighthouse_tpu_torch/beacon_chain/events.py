"""Server-sent-event bus — the ``http_api`` ``events.rs`` role.

The chain publishes typed events (head, block, attestation,
finalized_checkpoint); subscribers (the ``/eth/v1/events`` SSE endpoint,
tests) receive them over bounded queues so a slow consumer cannot stall
block import (the reference uses a broadcast channel with lagging-receiver
drops).
"""

from __future__ import annotations

import queue
import threading
from typing import List, Tuple

TOPICS = ("head", "block", "attestation", "finalized_checkpoint")


class EventBus:
    def __init__(self, capacity: int = 256):
        self._subs: List[Tuple[set, "queue.Queue"]] = []
        self._lock = threading.Lock()
        self.capacity = capacity

    def subscribe(self, topics) -> "queue.Queue":
        q: queue.Queue = queue.Queue(maxsize=self.capacity)
        with self._lock:
            self._subs.append((set(topics), q))
        return q

    def unsubscribe(self, q) -> None:
        with self._lock:
            self._subs = [(t, s) for (t, s) in self._subs if s is not q]

    def publish(self, topic: str, data: dict) -> None:
        with self._lock:
            subs = list(self._subs)
        for topics, q in subs:
            if topic in topics:
                try:
                    q.put_nowait((topic, data))
                except queue.Full:
                    pass  # lagging receiver: drop (broadcast semantics)
