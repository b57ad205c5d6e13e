"""Flight recorder: a bounded black box for the serving cell.

A :class:`FlightRecorder` rides along a :class:`repro_torch.cell.ServeCell`
keeping the last ``capacity`` hops in a ring — per-hop wall time,
optional per-stage span durations, and a snapshot of the admission /
swap counters at that hop.  Memory is bounded regardless of uptime
(same discipline as the metric ring reservoirs).

On every recorded hop it evaluates three anomaly triggers over the ring
window and, when one trips, writes a post-mortem JSON artifact and
re-arms only after the condition clears (one dump per incident, not one
per hop):

* **deadline-shed spike** — the admission controller's ``rejected``
  counter grew by ≥ ``shed_spike`` within the window (sheds and queue
  rejections both land there; a spike means lanes are missing their
  deadlines *now*);
* **SLO burn** — ≥ ``slo_burn_frac`` of the window's hops exceeded the
  ``cell_latency_budget_ms`` gauge (live-settable; 0 disables);
* **hot-swap probe failure** — ``swap_failures`` grew: a published
  checkpoint failed the bit-parity gate and was refused.

The dump is the debugging bundle an operator wants *after* the
incident: the hop ring (a trace), admission/swap counter deltas, the
full metric snapshot, and a **stage attribution** of the slow hops —
measured span means when the hops carried spans, otherwise static stage
weights given to the recorder — naming the stage that owns the regression
(``"encode"``, ``"unpack"``, ...).  The reference takes those weights
from its cost model (``perf.stream_hop_cost``); the port's cost model is
ROADMAP queue A item 2, so until then ``StreamLanes`` installs none and
the recorder falls back, as the reference's does when given none, to
charging the whole hop to ``"encode"``.
"""

from __future__ import annotations

import dataclasses
import json
import os
import time
from typing import Callable, Optional

TRIGGERS = ("shed_spike", "slo_burn", "swap_failure")


@dataclasses.dataclass(frozen=True)
class FlightConfig:
    """Ring size, trigger thresholds and dump location."""

    capacity: int = 256          # hops retained in the ring
    shed_spike: int = 8          # rejected-counter growth that trips
    slo_ms: float = 0.0          # seeds cell_latency_budget_ms (0 = unset)
    slo_burn_frac: float = 0.5   # fraction of window hops over budget
    min_hops: int = 16           # hops required before burn is evaluated
    dump_dir: str = "flight_dumps"


@dataclasses.dataclass
class HopRecord:
    """One ring slot: a hop's timing + the counter state right after it."""

    seq: int                     # monotone hop index (never wraps)
    t: float                     # recorder clock at observation
    duration_ms: float
    spans: Optional[dict]        # per-stage ms, when the hop was traced
    rejected: float
    swap_failures: float
    queue_depth: float
    occupancy: float

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        if d["spans"] is None:
            del d["spans"]
        return d


class FlightRecorder:
    """Bounded hop ring + anomaly triggers + post-mortem dumps.

    ``stage_weights`` — ``{stage: fraction}`` summing to 1, or a
    zero-arg callable returning one (resolved lazily at first dump, so
    wiring the recorder costs nothing on the hot path) — is the static
    fallback attribution for hops recorded without spans.
    (The reference's ``StreamLanes`` wires it from its cost model; the
    port's waits for ROADMAP queue A item 2.)
    """

    def __init__(self, metrics, config: Optional[FlightConfig] = None,
                 stage_weights=None,
                 clock: Callable[[], float] = time.monotonic):
        self.metrics = metrics
        self.cfg = config or FlightConfig()
        self.stage_weights = stage_weights
        self._clock = clock
        self._ring: list = [None] * self.cfg.capacity
        self._seq = 0
        self._armed = {k: True for k in TRIGGERS}
        self.dumps: list = []            # paths written, in order
        if self.cfg.slo_ms > 0:
            metrics.latency_budget.set(self.cfg.slo_ms)

    # -- recording ---------------------------------------------------------

    def __len__(self) -> int:
        return min(self._seq, self.cfg.capacity)

    def window(self) -> list:
        """Ring contents in hop order (oldest first)."""
        n = len(self)
        start = self._seq - n
        return [self._ring[i % self.cfg.capacity]
                for i in range(start, self._seq)]

    def record_hop(self, duration_ms: float,
                   spans: Optional[dict] = None) -> Optional[str]:
        """Append one hop; returns a dump path if an anomaly tripped."""
        m = self.metrics
        rec = HopRecord(
            seq=self._seq, t=self._clock(),
            duration_ms=float(duration_ms),
            spans=dict(spans) if spans else None,
            rejected=m.rejected.value,
            swap_failures=m.swap_failures.value,
            queue_depth=m.queue_depth.value,
            occupancy=m.occupancy.value)
        self._ring[self._seq % self.cfg.capacity] = rec
        self._seq += 1
        return self.check()

    # -- triggers ----------------------------------------------------------

    def _trip_state(self) -> dict:
        win = self.window()
        if not win:
            return {k: False for k in TRIGGERS}
        first = win[0]
        m = self.metrics
        budget = m.latency_budget.value
        over = sum(r.duration_ms > budget for r in win) if budget > 0 else 0
        # counter deltas run oldest-snapshot -> LIVE value (not the last
        # snapshot), so check() sees growth between hops — e.g. a probe
        # failure during maybe_swap, before the next hop lands
        return {
            "shed_spike":
                m.rejected.value - first.rejected >= self.cfg.shed_spike,
            "slo_burn":
                budget > 0 and len(win) >= self.cfg.min_hops
                and over >= self.cfg.slo_burn_frac * len(win),
            "swap_failure":
                m.swap_failures.value - first.swap_failures > 0,
        }

    def check(self) -> Optional[str]:
        """Evaluate triggers against the current window; dump on a fresh
        trip (armed -> tripped edge), re-arm once the condition clears.
        Call between hops too (e.g. after a swap attempt) — it reads
        counters, it does not consume a ring slot."""
        state = self._trip_state()
        path = None
        for kind in TRIGGERS:
            if state[kind] and self._armed[kind]:
                self._armed[kind] = False
                path = self.dump(kind)
            elif not state[kind]:
                self._armed[kind] = True
        return path

    # -- attribution & dumping ---------------------------------------------

    def _weights(self) -> Optional[dict]:
        w = self.stage_weights
        if callable(w):
            w = self.stage_weights = w()
        return w

    def attribution(self) -> dict:
        """Name the stage that owns the window's slow hops.

        Slow = over budget when one is set, else above 2× the window
        median.  Attribution prefers measured spans (mean per stage over
        the slow hops); hops recorded without spans fall back to the
        static cost-model stage weights scaled by the mean slow
        duration.  ``slowest_stage`` is the argmax either way.
        """
        win = self.window()
        if not win:
            return {"slow_hops": 0, "stage_ms": {}, "slowest_stage": None}
        budget = self.metrics.latency_budget.value
        if budget > 0:
            slow = [r for r in win if r.duration_ms > budget]
        else:
            med = sorted(r.duration_ms for r in win)[len(win) // 2]
            slow = [r for r in win if r.duration_ms > 2 * med]
        if not slow:
            slow = sorted(win, key=lambda r: -r.duration_ms)[:1]
        mean_ms = sum(r.duration_ms for r in slow) / len(slow)

        spanned = [r for r in slow if r.spans]
        if spanned:
            stage_ms: dict = {}
            for r in spanned:
                for k, v in r.spans.items():
                    stage_ms[k] = stage_ms.get(k, 0.0) + v
            stage_ms = {k: round(v / len(spanned), 4)
                        for k, v in stage_ms.items()}
            method = "measured-spans"
        else:
            w = self._weights() or {"encode": 1.0}
            stage_ms = {k: round(f * mean_ms, 4) for k, f in w.items()}
            method = "cost-model-weights"
        slowest = max(stage_ms, key=stage_ms.get)
        return {"slow_hops": len(slow),
                "slow_mean_ms": round(mean_ms, 4),
                "method": method, "stage_ms": stage_ms,
                "slowest_stage": slowest}

    def dump(self, reason: str) -> str:
        """Write the post-mortem artifact; returns its path."""
        from repro_torch.perf import ledger   # lazy: telemetry must not need perf

        m = self.metrics
        win = self.window()
        os.makedirs(self.cfg.dump_dir, exist_ok=True)
        path = os.path.join(self.cfg.dump_dir,
                            f"flight_{len(self.dumps):03d}_{reason}.json")
        artifact = {
            "reason": reason,
            "provenance": ledger.provenance(),
            "config": dataclasses.asdict(self.cfg),
            "window_hops": len(win),
            "attribution": self.attribution(),
            "admission": {
                "admitted": m.admitted.value,
                "degraded": m.degraded.value,
                "rejected": m.rejected.value,
                "rejected_in_window":
                    win[-1].rejected - win[0].rejected if win else 0,
                "queue_depth": m.queue_depth.value,
            },
            "hotswap": {
                "swaps": m.swaps.value,
                "swap_failures": m.swap_failures.value,
                "engine_generation": m.engine_generation.value,
            },
            "latency_budget_ms": m.latency_budget.value,
            "hop_latency": m.hop_ms.summary(),
            "trace": [r.to_dict() for r in win],
        }
        with open(path, "w") as f:
            json.dump(artifact, f, indent=2)
        self.dumps.append(path)
        return path
