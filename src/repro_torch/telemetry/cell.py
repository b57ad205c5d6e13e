"""The serving cell's metric vocabulary (``cell_*``).

One place defines every instrument a :class:`repro_torch.cell.ServeCell`
exports, so dashboards, tests and the CI soak read a stable schema
instead of grepping call sites.  All instruments live on an ordinary
:class:`~repro_torch.telemetry.metrics.Registry` (get-or-create semantics —
building the bundle twice on one registry returns the same instruments)
and export through the registry's usual Prometheus/JSON paths.

Counters end in ``_total``; admission decisions carry a ``decision``
label so one metric name covers admitted / degraded / rejected lanes.
"""

from __future__ import annotations

import dataclasses

from repro_torch.telemetry.metrics import Counter, Gauge, Histogram, Registry


@dataclasses.dataclass
class CellMetrics:
    """Every instrument of one serving cell (see module docstring)."""

    # lane lifecycle (streams and LM request slots alike)
    joins: Counter            # cell_lane_joins_total
    evictions: Counter        # cell_lane_evictions_total
    occupancy: Gauge          # cell_lane_occupancy (active / slots)

    # admission control (cell.admission)
    admitted: Counter         # cell_admission_total{decision="admit"}
    degraded: Counter         # cell_admission_total{decision="degrade"}
    rejected: Counter         # cell_admission_total{decision="reject"}
    queue_depth: Gauge        # cell_queue_depth

    # hop/token flow
    hops: Counter             # cell_hops_total (per-lane hops ingested)
    dropped_hops: Counter     # cell_dropped_hops_total (MUST stay 0)
    tokens: Counter           # cell_tokens_total (LM tokens decoded)
    prefill_tokens: Counter   # cell_prefill_tokens_total (joined prompts)
    hop_ms: Histogram         # cell_hop_latency_ms
    decode_ms: Histogram      # cell_decode_latency_ms
    prefill_ms: Histogram     # cell_prefill_latency_ms
    latency_budget: Gauge     # cell_latency_budget_ms (SLO; 0 = unset)

    # checkpoint hot-swap (cell.hotswap)
    swaps: Counter            # cell_swaps_total
    swap_failures: Counter    # cell_swap_failures_total (parity gate)
    swap_ms: Histogram        # cell_swap_latency_ms (load+warm+verify+swap)
    engine_generation: Gauge  # cell_engine_generation


def make_cell_metrics(registry: Registry) -> CellMetrics:
    """Register (or fetch) the full ``cell_*`` instrument set."""
    adm = "admission decisions for offered lanes"
    return CellMetrics(
        joins=registry.counter("cell_lane_joins_total",
                               "lanes joined into the batch in flight"),
        evictions=registry.counter("cell_lane_evictions_total",
                                   "lanes evicted (EOS / stream end)"),
        occupancy=registry.gauge("cell_lane_occupancy",
                                 "active lanes / batch slots"),
        admitted=registry.counter("cell_admission_total", adm,
                                  labels={"decision": "admit"}),
        degraded=registry.counter("cell_admission_total", adm,
                                  labels={"decision": "degrade"}),
        rejected=registry.counter("cell_admission_total", adm,
                                  labels={"decision": "reject"}),
        queue_depth=registry.gauge("cell_queue_depth",
                                   "lanes waiting for a slot"),
        hops=registry.counter("cell_hops_total",
                              "per-lane stream hops ingested"),
        dropped_hops=registry.counter(
            "cell_dropped_hops_total",
            "hops lost to churn/swap (the soak asserts 0)"),
        tokens=registry.counter("cell_tokens_total", "LM tokens decoded"),
        prefill_tokens=registry.counter("cell_prefill_tokens_total",
                                        "prompt tokens prefilled at join"),
        hop_ms=registry.histogram("cell_hop_latency_ms",
                                  "stream hop wall time", unit="ms"),
        decode_ms=registry.histogram("cell_decode_latency_ms",
                                     "LM decode step wall time", unit="ms"),
        prefill_ms=registry.histogram("cell_prefill_latency_ms",
                                      "LM join prefill wall time",
                                      unit="ms"),
        latency_budget=registry.gauge(
            "cell_latency_budget_ms",
            "per-hop latency SLO; the flight recorder burns against "
            "this (0 = no budget set)"),
        swaps=registry.counter("cell_swaps_total",
                               "checkpoint hot-swaps completed"),
        swap_failures=registry.counter(
            "cell_swap_failures_total",
            "hot-swaps rejected by the probe parity gate"),
        swap_ms=registry.histogram(
            "cell_swap_latency_ms",
            "hot-swap load+warm+verify+install wall time", unit="ms"),
        engine_generation=registry.gauge(
            "cell_engine_generation",
            "EngineHandle generation (bumps once per swap)"),
    )
