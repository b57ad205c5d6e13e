"""Span tracing: nested host spans -> Chrome/Perfetto trace JSON.

The paper's 5x story started from per-op clock-cycle attribution (Figs
3-5: GELU/SoftMax dominate the 26M-cycle inference); this module is the
repo's analogue for Engine plans.  A :class:`Tracer` records nested
``span("hop")`` / ``span("encoder")`` / ``span("attention")`` ... context
managers as Chrome trace-event *complete* events (``ph: "X"``,
microsecond ``ts``/``dur``) that load directly into ``chrome://tracing``
/ Perfetto, and, under ``profiler=True``, as ``record_function`` ranges
(``torch._C._profiler._RecordFunctionFast``) in the profiler's host
timeline.

Design constraints (tests/test_torch_telemetry.py):

* **Disabled fast path is free.**  ``telemetry.span(name)`` with no
  active tracer returns one shared no-op context manager — no object,
  tuple or dict is allocated per call, so instrumented hot paths
  (``Engine.forward``, every layer of ``models/layers.py``) cost one
  global read + ``None`` check when tracing is off.
* **Spans time the host and never wait for the device.**  No span
  synchronizes, so a traced program queues its device work as the
  untraced one does; a span's ``dur`` is the host's time inside it.
  The device time of a span is read from a ``torch.profiler`` trace: the
  kernels whose launches fall inside the span's range.  Where the host
  does wait (a copy to the host), that wait has a span of its own.
* **One clock with the device trace.**  ``ts`` is Unix-epoch
  microseconds, the clock ``torch.profiler`` stamps its host and device
  events on, so an exported trace and a profiler trace lie over one
  another; ``dur`` comes from ``time.perf_counter_ns``.
* **Nesting is explicit.**  Each event records its parent span name in
  ``args["parent"]``, which is what :func:`span_coverage` uses to check
  that named child stages account for a parent's wall time.
"""

from __future__ import annotations

import contextlib
import json
import os
import threading
import time

import torch


class _NoopSpan:
    """Shared do-nothing context manager (the tracing-disabled fast path)."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, exc_type, exc, tb):
        return False


NOOP_SPAN = _NoopSpan()


class _Span:
    """One live span of an enabled tracer (created per ``Tracer.span``)."""

    __slots__ = ("_tracer", "name", "args", "_ts", "_t0", "_annotation")

    def __init__(self, tracer, name, args):
        self._tracer = tracer
        self.name = name
        self.args = args
        self._ts = self._t0 = 0
        self._annotation = None

    def __enter__(self):
        tr = self._tracer
        tr._stack().append(self.name)
        if tr.profiler:
            # the C++ range: ``torch.profiler.record_function`` enters
            # through Python and ``torch.ops``, some twenty times the host
            # time a span, on the critical path of a host-bound hop
            self._annotation = torch._C._profiler._RecordFunctionFast(
                self.name)
            self._annotation.__enter__()
        self._ts = time.time_ns()
        self._t0 = time.perf_counter_ns()
        return self

    def __exit__(self, exc_type, exc, tb):
        t1 = time.perf_counter_ns()
        if self._annotation is not None:
            self._annotation.__exit__(exc_type, exc, tb)
        tr = self._tracer
        stack = tr._stack()
        stack.pop()
        args = dict(self.args) if self.args else {}
        if stack:
            args["parent"] = stack[-1]
        tr._record(self.name, self._ts, t1 - self._t0, args)
        return False


class Tracer:
    """Collects spans as Chrome trace-event JSON (``ph: "X"`` events).

    ``profiler=True`` additionally opens a ``record_function`` range for
    every span, so the names show up in traces that ``torch.profiler``
    captures, on the clock of their ``ts``.
    """

    def __init__(self, *, profiler: bool = False):
        self.events: list[dict] = []
        self.profiler = profiler
        self._local = threading.local()
        self._lock = threading.Lock()

    def _stack(self) -> list:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def _record(self, name, ts_ns, dur_ns, args):
        ev = {"name": name, "cat": "repro", "ph": "X",
              "ts": ts_ns / 1e3,                # Unix-epoch microseconds
              "dur": dur_ns / 1e3,
              "pid": os.getpid(), "tid": threading.get_ident()}
        if args:
            ev["args"] = args
        with self._lock:
            self.events.append(ev)

    def span(self, name: str, args: dict | None = None) -> _Span:
        """Context manager timing one named (nested) stage."""
        return _Span(self, name, args)

    # -- inspection / export ----------------------------------------------

    def durations_us(self, name: str) -> list[float]:
        """All recorded durations (microseconds) of spans called ``name``."""
        return [e["dur"] for e in self.events
                if e.get("ph") == "X" and e["name"] == name]

    def to_chrome(self) -> dict:
        """The Chrome trace-event file format (JSON object flavour)."""
        return {"traceEvents": list(self.events), "displayTimeUnit": "ms"}

    def save(self, path: str) -> str:
        with open(path, "w") as f:
            json.dump(self.to_chrome(), f)
        return path


def span_coverage(tracer_or_events, parent: str,
                  children: tuple | None = None) -> float:
    """Fraction of ``parent`` span wall time accounted for by its direct
    named children (optionally restricted to ``children`` names).

    The acceptance gate for the telemetry layer: named stages must
    explain >= 90% of measured ``Engine.forward`` time per backend —
    anything less means a stage is missing a span.
    """
    events = tracer_or_events.events \
        if isinstance(tracer_or_events, Tracer) else tracer_or_events
    parent_us = sum(e["dur"] for e in events
                    if e.get("ph") == "X" and e["name"] == parent)
    if parent_us <= 0:
        return 0.0
    child_us = sum(
        e["dur"] for e in events
        if e.get("ph") == "X"
        and e.get("args", {}).get("parent") == parent
        and (children is None or e["name"] in children))
    return child_us / parent_us


# ---------------------------------------------------------------------------
# Module-level active tracer (what the instrumented call sites consult)
# ---------------------------------------------------------------------------

_ACTIVE: Tracer | None = None


def enable(tracer: Tracer | None = None, *, profiler: bool = False) -> Tracer:
    """Install ``tracer`` (or a fresh one) as the active tracer."""
    global _ACTIVE
    _ACTIVE = tracer if tracer is not None else Tracer(profiler=profiler)
    return _ACTIVE


def disable() -> Tracer | None:
    """Deactivate tracing; returns the tracer that was active (if any)."""
    global _ACTIVE
    tr, _ACTIVE = _ACTIVE, None
    return tr


def active_tracer() -> Tracer | None:
    return _ACTIVE


def span(name: str, args: dict | None = None):
    """Span under the active tracer, or the shared no-op when disabled.

    The disabled path allocates nothing: it returns the module-level
    ``NOOP_SPAN`` singleton (fixed-arity ``__exit__``, ``__slots__``),
    which is what keeps un-traced ``Engine.forward`` calls free.
    """
    tr = _ACTIVE
    if tr is None:
        return NOOP_SPAN
    return tr.span(name, args)


@contextlib.contextmanager
def tracing(*, profiler: bool = False):
    """Scoped enable: ``with tracing() as tr: ... tr.save(path)``."""
    tr = enable(profiler=profiler)
    try:
        yield tr
    finally:
        disable()
