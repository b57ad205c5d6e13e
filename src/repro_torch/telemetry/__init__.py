"""repro_torch.telemetry — span tracing, serve metrics, quantisation-health taps.

The port of ``repro.telemetry``, in layers:

* :mod:`repro_torch.telemetry.trace`   — host-side nested spans ->
  Chrome/Perfetto trace-event JSON; free when disabled.
* :mod:`repro_torch.telemetry.metrics` — counters / gauges / ring-reservoir
  histograms with Prometheus-text + JSON export and the shared
  :func:`latency_summary` schema; :func:`log` structured log lines.
* :mod:`repro_torch.telemetry.taps`    — quantisation-health statistics
  collected by the Engine's opt-in ``compile_model(..., taps=True)`` aux
  pass (int8 saturation, LUT out-of-domain fractions, Q8.24 headroom).
* :mod:`repro_torch.telemetry.flight`  — a bounded flight recorder for the
  serving cell: last-N-hops ring + anomaly-triggered post-mortem dumps
  with stage attribution.
* :mod:`repro_torch.telemetry.cell`    — the serving cell's ``cell_*``
  metric vocabulary.

:func:`annotate` names a stage for ``torch.profiler`` (a
``torch.profiler.record_function`` pass-through): metadata-only, shows up
in profiler traces, never changes numerics.
"""

from torch.profiler import record_function as annotate

from repro_torch.telemetry import taps
from repro_torch.telemetry.cell import CellMetrics, make_cell_metrics
from repro_torch.telemetry.flight import FlightConfig, FlightRecorder, HopRecord
from repro_torch.telemetry.check import (
    TelemetryFormatError,
    validate_chrome_trace,
    validate_prometheus,
)
from repro_torch.telemetry.metrics import (
    Counter,
    Gauge,
    Histogram,
    Registry,
    default_registry,
    latency_summary,
    log,
)
from repro_torch.telemetry.trace import (
    NOOP_SPAN,
    Tracer,
    active_tracer,
    disable,
    enable,
    span,
    span_coverage,
    tracing,
)

__all__ = [
    "NOOP_SPAN",
    "CellMetrics",
    "Counter",
    "FlightConfig",
    "FlightRecorder",
    "Gauge",
    "Histogram",
    "HopRecord",
    "Registry",
    "TelemetryFormatError",
    "Tracer",
    "active_tracer",
    "annotate",
    "default_registry",
    "disable",
    "enable",
    "latency_summary",
    "log",
    "make_cell_metrics",
    "span",
    "span_coverage",
    "taps",
    "tracing",
    "validate_chrome_trace",
    "validate_prometheus",
]
