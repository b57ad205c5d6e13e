"""The spans window: a second traced window, with the program's tracer on.

The runner's traced window reads the device with the program untraced.
The readers of the program's spans (``device_ms``, ``idle_in_pct``,
``span_ms``) share one more window, run once, on their first call, after
everything the runner reads: at least two calls and
``runner.TRACE_SECONDS`` under ``torch.profiler``, with
``repro_torch.telemetry.enable(profiler=True)``, so that each program
span is a ``record_function`` range in the profiler's host timeline, on
the clock of its device activity.  The program's spans never wait for
the card, so the window runs the program as the untraced one does; the
cost of the tracing shows as the calls per second of the two windows,
which the window prints in one ``bench:`` line on standard error.

``SpanTrace.read`` keeps, beside a ``Trace``'s fields,

* ``spans``: the program's spans, the host ``record_function`` ranges
  under the names the program's tracer recorded, ``(start, end, name,
  thread)``;
* ``launched``: each device activity with the host time of its launch,
  joined through the profiler's correlation ids to the runtime call that
  launched it (a kernel launched through ``ctypes`` included), ``(start,
  end, launch or None, thread)``;
* ``t0`` / ``t1``: the window's bounds on the profiler's clock.

A device activity belongs to every span open on its launching thread
when it was launched, and to ``client`` when none was; the device is
idle inside a span while its host thread is inside it and nothing runs
on the device.  A program without such spans (one that records none)
reads nothing.
"""

from __future__ import annotations

import collections
import dataclasses
import functools
import gc
import re
import sys
import time

import torch

from bench.core.trace import Trace

CLIENT = "client"       # no program span open: the harness's own work
RUNTIME = re.compile(r"^cu(da)?[A-Z]")     # cudaLaunchKernel, cuLaunchKernel, ...


def _union(intervals) -> list:
    """Sorted, disjoint ``[start, end)`` pairs covering ``intervals``."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        elif e > s:
            out.append([s, e])
    return out


def _overlap(a: list, b: list) -> int:
    """Length of the intersection of two sorted disjoint interval lists."""
    i = j = total = 0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if hi > lo:
            total += hi - lo
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def _complement(a: list, t0: int, t1: int) -> list:
    out, at = [], t0
    for s, e in a:
        if s > at:
            out.append([at, min(s, t1)])
        at = max(at, e)
    if at < t1:
        out.append([at, t1])
    return [p for p in out if p[1] > p[0]]


@dataclasses.dataclass
class SpanTrace(Trace):
    spans: list = dataclasses.field(default_factory=list)
    launched: list = dataclasses.field(default_factory=list)
    t0: int = 0
    t1: int = 0

    @classmethod
    def read(cls, prof, t0_ns: int, t1_ns: int, names) -> "SpanTrace":
        """``names``: the names of the program's spans (a device range of
        one of them is the profiler's copy of the span, not device work)."""
        dev, host, spans, runtime = [], [], [], {}
        for e in prof.profiler.kineto_results.events():
            start = e.start_ns()
            end = start + e.duration_ns()
            name = e.name()
            if e.device_type() == torch.autograd.DeviceType.CUDA:
                if name not in names:
                    dev.append((start, end, name, e.correlation_id()))
            elif RUNTIME.match(name):
                runtime[e.correlation_id()] = (start, e.start_thread_id())
            elif name.startswith("aten::"):
                host.append((start, end, name))
            elif name in names:
                spans.append((start, end, name, e.start_thread_id()))
        dev.sort()
        launched = [(s, e, *runtime.get(c, (None, None)))
                    for s, e, _, c in dev]
        return cls((t1_ns - t0_ns) * 1e-9, [d[:3] for d in dev],
                   sorted(host), sorted(spans), launched, t0_ns, t1_ns)

    # -- what each activity was launched under -----------------------------

    def names(self) -> set:
        return {n for _, _, n, _ in self.spans}

    @functools.cached_property
    def owners(self) -> list:
        """For each of ``launched``, the names of the spans open on its
        launching thread at its launch (``None``: launch not found)."""
        marks = collections.defaultdict(list)   # thread -> (t, order, ...)
        for s, e, name, tid in self.spans:
            marks[tid] += [(s, 0, name), (e, 2, name)]
        for i, (_, _, at, tid) in enumerate(self.launched):
            if at is not None:
                marks[tid].append((at, 1, i))
        out = [None] * len(self.launched)
        for seq in marks.values():
            open_ = collections.Counter()
            for _, kind, what in sorted(seq, key=lambda m: m[:2]):
                if kind == 0:
                    open_[what] += 1
                elif kind == 2:
                    open_[what] -= 1
                else:
                    out[what] = frozenset(n for n, k in open_.items() if k)
        return out

    def device_s(self, span: str) -> float:
        """Device seconds of the activities launched inside ``span``
        (``client``: inside no span)."""
        total = 0
        for (s, e, _, _), owners in zip(self.launched, self.owners):
            if owners is not None and (
                    span in owners if span != CLIENT else not owners):
                total += e - s
        return total * 1e-9

    def unmatched_s(self) -> float:
        """Device seconds of the activities whose launch was not found."""
        return 1e-9 * sum(e - s for s, e, at, _ in self.launched
                          if at is None)

    # -- where the device idled ----------------------------------------------

    def idle(self) -> list:
        busy = _union([(max(s, self.t0), min(e, self.t1))
                       for s, e, _ in self.device])
        return _complement(busy, self.t0, self.t1)

    def idle_s(self, span: str) -> float:
        """Seconds of the window in which the device idled while the host
        was inside ``span`` (``client``: inside no span)."""
        if span == CLIENT:
            inside = _complement(_union((s, e) for s, e, _, _ in self.spans),
                                 self.t0, self.t1)
        else:
            inside = _union((s, e) for s, e, n, _ in self.spans if n == span)
        return 1e-9 * _overlap(self.idle(), inside)

    def top_level(self) -> set:
        """The names of the spans that no other span on their thread
        holds: with ``client``, they split the window."""
        out, ends = set(), {}
        for s, e, name, tid in sorted(self.spans,
                                      key=lambda x: (x[3], x[0], -x[1])):
            if s >= ends.get(tid, s):
                out.add(name)
            ends[tid] = max(ends.get(tid, e), e)
        return out

    def idle_share(self) -> float:
        """Share of the window in which nothing ran on the device."""
        return sum(e - s for s, e in self.idle()) / (self.t1 - self.t0)


@dataclasses.dataclass
class SpanWindow:
    trace: SpanTrace
    calls: int
    tracer: object          # the program's Tracer of the window

    def device_ms(self, span: str):
        """Device milliseconds a call launched inside ``span``."""
        if not self.trace.device or (span != CLIENT
                                     and span not in self.trace.names()):
            return None
        return 1e3 * self.trace.device_s(span) / self.calls

    def idle_in_pct(self, span: str):
        """Share of the window the device idled with the host in ``span``."""
        if not self.trace.device or (span != CLIENT
                                     and span not in self.trace.names()):
            return None
        return 100.0 * self.trace.idle_s(span) / self.trace.window_s

    def span_ms(self, span: str):
        """Host milliseconds a call spent inside ``span``, from the
        program's own tracer."""
        durs = self.tracer.durations_us(span)
        return sum(durs) / 1e3 / self.calls if durs else None


def window(run) -> SpanWindow:
    """The run's spans window, measured on the first call."""
    got = getattr(run, "span_window", None)
    if got is None:
        got = run.span_window = measure(run)
    return got


def measure(run) -> SpanWindow:
    from torch.profiler import ProfilerActivity, profile

    from bench.core import runner
    from repro_torch import telemetry

    cell, dev = run.cell, run.cell.ctx.device
    acts = [ProfilerActivity.CPU]
    if dev.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    before = cell.calls
    # as in the timed window, no collection of the harness's garbage (here
    # the earlier windows' parsed profiles) lands on a call of the window
    gc.collect()
    gc.freeze()
    gc.disable()
    tracer = telemetry.enable(profiler=True)
    try:
        with profile(activities=acts) as prof:
            t0 = time.time_ns()
            p0 = time.perf_counter()
            while cell.calls - before < 2 or \
                    time.perf_counter() - p0 < runner.TRACE_SECONDS:
                cell.step()
            runner._sync(dev)
            t1 = time.time_ns()
    finally:
        telemetry.disable()
        gc.enable()
        gc.unfreeze()
    names = {e["name"] for e in tracer.events}
    out = SpanWindow(SpanTrace.read(prof, t0, t1, names),
                     cell.calls - before, tracer)
    _report(run, out)
    return out


def _report(run, w: SpanWindow) -> None:
    """One ``bench:`` line: calls per second in the plain traced window
    and in the spans window, and how the spans window's device time and
    idle share split."""
    tr = w.trace
    plain = run.traced_calls / run.trace.window_s if run.trace else 0.0
    spans = w.calls / tr.window_s
    line = (f"spans window: {spans:.4f} calls/s against {plain:.4f} in the "
            f"plain traced window ({100 * (plain - spans) / plain:+.2f} % "
            "with tracing on)" if plain else
            f"spans window: {spans:.4f} calls/s")
    busy = tr.busy_s()
    if tr.device and busy > 0:
        idle = {n: 100 * tr.idle_s(n) / tr.window_s
                for n in sorted(tr.top_level()) + [CLIENT]}
        line += (f"; device busy {busy:.4f} of {tr.window_s:.4f} s, "
                 f"launch unmatched {100 * tr.unmatched_s() / busy:.3f} % "
                 f"of busy; idle {100 * tr.idle_share():.3f} % = "
                 + " + ".join(f"{n} {v:.3f}" for n, v in idle.items()))
    print("bench:", line, file=sys.stderr)
