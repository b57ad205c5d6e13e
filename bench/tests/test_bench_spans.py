"""The readers of the program's spans (``device_ms``, ``idle_in_pct``,
``span_ms``) on a synthetic spans window, and ``SpanTrace.read`` on a CPU
profile of the port's spans."""

import dataclasses

import pytest

from bench.core import runner
from bench.core.spans import SpanTrace, SpanWindow

MS = 10**6      # nanoseconds


class Tracer:
    """The program tracer's ``durations_us``, of fixed events."""

    def __init__(self, durations):
        self.durations = durations

    def durations_us(self, name):
        return self.durations.get(name, [])


def synthetic() -> SpanTrace:
    """A 100 ms window on one host thread: ``hop`` (10-50) holds
    ``stream_step`` (12-45), which holds ``encoder`` (20-40); ``join``
    (55-60), ``evict`` (61-62); the rest is the client's.  Device
    activity: two kernels launched in ``encoder``, one in ``join``, one
    by the client and one whose launch the profiler did not give."""
    spans = [(a * MS, b * MS, name, 1) for a, b, name in (
        (10, 50, "hop"), (12, 45, "stream_step"), (20, 40, "encoder"),
        (55, 60, "join"), (61, 62, "evict"))]
    launched = [(a * MS, b * MS, at * MS, 1) for a, b, at in (
        (5, 8, 4), (22, 30, 21), (30, 45, 30), (56, 58, 56))]
    launched.append((70 * MS, 72 * MS, None, None))
    device = [(s, e, f"k{i}") for i, (s, e, _, _) in enumerate(launched)]
    return SpanTrace(0.1, device, [], spans, launched, 0, 100 * MS)


@pytest.fixture
def run(spec):
    """A run whose spans window is the synthetic one, of 2 calls."""
    info = runner.RunInfo(spec, None, {}, {}, {}, calls=1, window_s=1.0)
    info.span_window = SpanWindow(synthetic(), 2, Tracer(
        {"to_host": [1500.0, 2500.0, 1000.0]}))
    return info


def read(spec, run, name):
    return spec.reader(name).read(name, run)


def test_device_ms_attributes_each_launch_to_its_open_spans(spec, run):
    assert read(spec, run, "device_ms.encoder.streams") == \
        pytest.approx((8 + 15) / 2)
    # a kernel belongs to every span open at its launch
    assert read(spec, run, "device_ms.hop.streams") == pytest.approx(23 / 2)
    assert read(spec, run, "device_ms.join.streams") == pytest.approx(1.0)
    assert read(spec, run, "device_ms.client.streams") == pytest.approx(1.5)
    assert read(spec, run, "device_ms.evict.streams") == 0.0
    # a span the program never recorded reads nothing
    assert read(spec, run, "device_ms.attention.streams") is None
    tr = run.span_window.trace
    assert tr.unmatched_s() == pytest.approx(2e-3)
    assert tr.busy_s() == pytest.approx(30e-3)


def test_idle_in_pct_splits_the_windows_idle_share(spec, run):
    tr = run.span_window.trace
    # idle: 0-5, 8-22, 45-56, 58-70, 72-100 = 70 of 100 ms
    assert tr.idle_share() == pytest.approx(0.70)
    want = {"hop": 17.0, "join": 3.0, "evict": 1.0, "client": 49.0,
            "stream_step": 10.0, "encoder": 2.0}
    for span, pct in want.items():
        assert read(spec, run, f"idle_in_pct.{span}.streams") == \
            pytest.approx(pct), span
    assert tr.top_level() == {"hop", "join", "evict"}
    total = sum(read(spec, run, f"idle_in_pct.{s}.streams")
                for s in tr.top_level() | {"client"})
    assert total == pytest.approx(100 * tr.idle_share())
    assert read(spec, run, "idle_in_pct.detector.streams") is None


def test_span_ms_reads_the_programs_tracer(spec, run):
    assert read(spec, run, "span_ms.to_host.streams") == pytest.approx(2.5)
    assert read(spec, run, "span_ms.detector.streams") is None


def test_device_readers_read_nothing_without_device_activity(spec, run):
    tr = dataclasses.replace(synthetic(), device=[], launched=[])
    run.span_window = SpanWindow(tr, 2, Tracer({}))
    for name in ("device_ms.encoder.streams", "idle_in_pct.hop.streams",
                 "idle_in_pct.client.streams"):
        assert read(spec, run, name) is None


def test_read_keeps_the_programs_spans_from_a_cpu_profile():
    """On the CPU the profile holds the port's spans as ``record_function``
    ranges, nested as the program opened them, and no device activity."""
    import time

    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch import runtime, telemetry
    from repro_torch.configs import registry
    from repro_torch.models import kwt
    cfg = registry.get("kwt-tiny").config
    p = kwt.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    eng = runtime.compile_model(cfg, p, backend="lut", device="cpu")
    x = np.zeros((2, *cfg.input_dim), np.float32)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        t0 = time.time_ns()
        with telemetry.tracing(profiler=True) as tracer:
            eng.forward(x)
        t1 = time.time_ns()
    tr = SpanTrace.read(prof, t0, t1, {e["name"] for e in tracer.events})
    assert {"forward", "encode", "attention", "mlp", "norm"} <= tr.names()
    assert tr.top_level() == {"forward"}
    assert not tr.device and not tr.launched
    assert all(t0 <= s <= e <= t1 for s, e, _, _ in tr.spans)
