"""Admission control + backpressure for a serving cell's stream lanes.

A cell has a fixed lane budget; offered streams beyond it wait in a
BOUNDED queue.  Overload is handled in escalating stages, every decision
surfaced as a ``cell_admission_total{decision=...}`` counter:

1. **admit** — a token bucket (``rate`` admits/s, ``burst`` capacity)
   smooths arrival spikes; within rate and queue bounds, the stream is
   queued for the next free lane.
2. **degrade** — before anything is refused, the CELL degrades: when the
   queue backs up (or queue wait approaches the deadline), admitted
   streams are served at ``degraded_chunk_hops`` hops per engine step.
   A wider chunk amortises the per-step encoder cost over more audio —
   the real-time budget per step scales with ``chunk_hops`` while the
   step cost grows sub-linearly (a stream step costs about the same at
   1, 2 and 5 hops on the card, PERF.md), so the cell trades detection
   latency for throughput instead of shedding.
   The degrade is cell-wide (one batch has one chunk width).
3. **reject** — a full queue, an exhausted token bucket, or a stream
   whose queue wait exceeded ``deadline_ms`` is shed.  Rejection happens
   strictly BEFORE any audio is ingested, so the cell's zero-dropped-hop
   accounting (``cell_hops_total`` vs offered source hops) is unaffected
   by shedding: an admitted stream is always served completely.

Time is injectable (``clock``) so every decision is unit-testable
without sleeping.
"""

from __future__ import annotations

import collections
import dataclasses
import math
import time
from typing import Any, Optional


@dataclasses.dataclass(frozen=True)
class AdmissionConfig:
    max_queue: int = 64             # bounded wait queue (lanes excluded)
    rate: float = math.inf          # token bucket: admissions per second
    burst: int = 16                 # bucket capacity
    deadline_ms: Optional[float] = None   # max queue wait before shedding
    degrade_queue: int = 8          # queue depth that triggers degrade
    degraded_chunk_hops: int = 4    # hops per engine step when degraded


@dataclasses.dataclass
class Decision:
    admitted: bool
    reason: str                     # "admit" | "queue_full" | "rate" | "deadline"


class AdmissionController:
    """Bounded queue + token bucket + deadline shedding + degrade signal."""

    def __init__(self, cfg: AdmissionConfig = AdmissionConfig(),
                 metrics=None, clock=time.monotonic):
        self.cfg = cfg
        self.metrics = metrics
        self._clock = clock
        self._queue: collections.deque = collections.deque()  # (item, t_in)
        self._tokens = float(cfg.burst)
        self._t_last = clock()
        self.degraded = False

    # -- token bucket ------------------------------------------------------

    def _refill(self, now: float) -> None:
        if math.isinf(self.cfg.rate):
            self._tokens = float(self.cfg.burst)
        else:
            self._tokens = min(float(self.cfg.burst),
                               self._tokens
                               + (now - self._t_last) * self.cfg.rate)
        self._t_last = now

    # -- intake ------------------------------------------------------------

    def offer(self, item: Any) -> Decision:
        """Admit ``item`` into the wait queue, or reject with a reason."""
        now = self._clock()
        self._refill(now)
        if len(self._queue) >= self.cfg.max_queue:
            return self._reject("queue_full")
        if self._tokens < 1.0:
            return self._reject("rate")
        self._tokens -= 1.0
        self._queue.append((item, now))
        if self.metrics is not None:
            self.metrics.admitted.inc()
            self.metrics.queue_depth.set(len(self._queue))
        return Decision(True, "admit")

    def _reject(self, reason: str) -> Decision:
        if self.metrics is not None:
            self.metrics.rejected.inc()
        return Decision(False, reason)

    # -- hand-off to lanes -------------------------------------------------

    def pop(self) -> Optional[Any]:
        """Next admitted item for a free lane; sheds items whose queue wait
        blew the deadline (counted as rejections — they never served)."""
        now = self._clock()
        dl = self.cfg.deadline_ms
        while self._queue:
            item, t_in = self._queue.popleft()
            if dl is not None and (now - t_in) * 1e3 > dl:
                self._reject("deadline")
                continue
            if self.metrics is not None:
                self.metrics.queue_depth.set(len(self._queue))
            return item
        if self.metrics is not None:
            self.metrics.queue_depth.set(0)
        return None

    def __len__(self) -> int:
        return len(self._queue)

    # -- degrade signal ----------------------------------------------------

    def chunk_hops(self) -> int:
        """Hops per engine step the cell should run at right now.

        Degrades (cell-wide) when the queue is past ``degrade_queue`` or
        the OLDEST waiter has used half its deadline; recovers hysteresis-
        free once the queue drains (an empty queue serves at chunk 1).
        """
        cfg = self.cfg
        backed_up = len(self._queue) > cfg.degrade_queue
        if not backed_up and cfg.deadline_ms is not None and self._queue:
            wait_ms = (self._clock() - self._queue[0][1]) * 1e3
            backed_up = wait_ms > cfg.deadline_ms / 2
        if backed_up and not self.degraded:
            if self.metrics is not None:
                self.metrics.degraded.inc()
        self.degraded = backed_up
        return cfg.degraded_chunk_hops if backed_up else 1
