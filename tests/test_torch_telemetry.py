"""repro_torch.telemetry: the reference's telemetry contracts in the port,
and the port's artifacts against the reference's validators.

The reference's contracts (``tests/test_telemetry.py``, the flight-recorder
tests of ``tests/test_perf.py``), restated for the port on the CPU:

* taps-on logits are bit-identical to the untapped plan on every backend
  (the aux comes from a separate pass; the served logits never do);
* histogram quantiles are correct, including after the ring reservoir
  wraps; traces validate as Chrome trace-event JSON and the Prometheus
  text exposition as Prometheus;
* the telemetry-disabled fast path allocates nothing per call and adds no
  span to ``Engine.forward``;
* the flight recorder's ring, its three triggers, its attribution and its
  dump schema.

Against the reference, on the same numpy inputs and weights:

* taps aux: the same sites and statistics; fractions within
  ``TAP_FRAC_ATOL`` 0.01 and headroom bits equal (measured: every
  statistic equal, KWT-Tiny and KWT-1 at 2 layers, ``float`` /
  ``lut_float`` / ``lut`` / ``lut`` + ``flash_lut`` / non-executing
  ``lut``);
* the port's trace and Prometheus text pass the reference's validators
  (``repro.telemetry.check``, which imports no JAX), and the reference's
  pass the port's.
"""

import json
import os
import tracemalloc

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import runtime as jrt
from repro import telemetry as jtel
from repro.configs import registry as jregistry
from repro.models import kwt as jkwt
from repro.telemetry import check as jcheck
from repro_torch import convert
from repro_torch import runtime
from repro_torch import telemetry
from repro_torch.configs import registry
from repro_torch.models import kwt
from repro_torch.telemetry import FlightConfig, FlightRecorder
from repro_torch.telemetry import check as tcheck
from repro_torch.telemetry import make_cell_metrics
from repro_torch.telemetry import taps

torch.set_num_threads(1)

CFG = registry.get("kwt-tiny").config
TAP_FRAC_ATOL = 0.01


@pytest.fixture(scope="module")
def params():
    return kwt.init_params(CFG, torch.Generator().manual_seed(0), "cpu")


@pytest.fixture(scope="module")
def mfcc():
    return (0.5 * np.random.default_rng(1).normal(size=(2, *CFG.input_dim))
            ).astype(np.float32)


@pytest.fixture(autouse=True)
def _tracing_off():
    yield
    telemetry.disable()


# ---------------------------------------------------------------------------
# taps: bit-identity + health stats
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("backend", ["float", "lut_float", "lut"])
def test_taps_logits_bit_identical(params, mfcc, backend):
    eng = runtime.compile_model(CFG, params, backend=backend, device="cpu")
    engt = runtime.compile_model(CFG, params, backend=backend, taps=True,
                                 device="cpu")
    base = eng.forward(mfcc)
    logits, aux = engt.forward(mfcc)
    assert torch.equal(logits, base)
    # per-layer aux is present, scoped, and finite
    assert "block0/softmax" in aux
    assert "lut_oob_frac" in aux["block0/softmax"]
    assert "embed" in aux and "logits" in aux
    for site, stats in aux.items():
        for stat, v in stats.items():
            assert np.isfinite(float(v)), f"{site}/{stat} not finite"


def test_taps_off_by_default_and_no_aux(params, mfcc):
    eng = runtime.compile_model(CFG, params, backend="lut", device="cpu")
    assert eng.taps is False
    out = eng.forward(mfcc)
    assert not isinstance(out, tuple)


def test_taps_report_saturation_when_activations_hot(params):
    """Scores far beyond the eq-9 grid edge must read as saturated (the
    non-executing resident plan: its embed output is not clipped by an
    input quantiser)."""
    hot = (300.0 * np.random.default_rng(2).normal(size=(2, *CFG.input_dim))
           ).astype(np.float32)
    engt = runtime.compile_model(CFG, params, backend="lut", taps=True,
                                 integer_exec=False, device="cpu")
    _, aux = engt.forward(hot)
    assert float(aux["embed"]["int8_sat_frac"]) > 0.5
    assert float(aux["embed"]["q24_headroom_bits"]) < 0


def test_tap_calls_are_noops_without_collector():
    """Model code calls taps unconditionally; inactive they emit nothing."""
    assert not taps.active()
    taps.tap_gelu(torch.zeros(4))
    taps.tap_softmax(torch.zeros(2, 4))
    with taps.collecting() as col:
        assert taps.active()
        taps.tap_gelu(torch.zeros(4))
    assert not taps.active()
    assert len(col) == 1 and col[0][0] == "gelu"


def _np_params(jcfg, seed=0):
    shapes = jax.eval_shape(lambda k: jkwt.init_params(jcfg, k),
                            jax.random.PRNGKey(0))
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda s: rng.normal(0, 1 / np.sqrt(s.shape[0]) if len(s.shape) > 1
                             else 0.1, s.shape).astype(np.float32), shapes)


@pytest.mark.parametrize("name,smoke", [("kwt-tiny", False), ("kwt-1", True)])
@pytest.mark.parametrize("backend,kw", [("float", {}), ("lut_float", {}),
                                        ("lut", {}),
                                        ("lut", {"attention": "flash_lut"}),
                                        ("lut", {"integer_exec": False})])
def test_taps_aux_match_the_reference(name, smoke, backend, kw):
    je, te = jregistry.get(name), registry.get(name)
    jcfg, tcfg = (je.smoke, te.smoke) if smoke else (je.config, te.config)
    npp = _np_params(jcfg)
    x = np.random.default_rng(1).normal(0, 0.5, (8, *jcfg.input_dim)) \
        .astype(np.float32)
    jl, ja = jrt.compile_model(jcfg, jax.tree.map(jnp.asarray, npp),
                               backend=backend, taps=True, **kw
                               ).forward(jnp.asarray(x))
    tl, ta = runtime.compile_model(tcfg, convert.from_numpy_tree(npp, "cpu"),
                                   backend=backend, taps=True, device="cpu",
                                   **kw).forward(x)
    assert set(ta) == set(ja)
    for site, stats in ja.items():
        assert set(ta[site]) == set(stats), site
        for stat, want in stats.items():
            got = float(ta[site][stat])
            if stat.endswith("_bits"):
                assert got == float(want), (site, stat)
            else:
                assert abs(got - float(want)) <= TAP_FRAC_ATOL, (site, stat)


# ---------------------------------------------------------------------------
# histogram quantiles
# ---------------------------------------------------------------------------

def test_histogram_quantiles_match_numpy():
    h = telemetry.Histogram("lat", unit="ms", capacity=2048)
    vals = np.random.RandomState(0).lognormal(0, 1, 1000)
    for v in vals:
        h.observe(v)
    for q in (0.5, 0.95, 0.99):
        assert h.quantile(q) == pytest.approx(
            np.percentile(vals, 100 * q), rel=1e-12)
    s = h.summary()
    assert s["n"] == 1000
    assert s["p50_ms"] == pytest.approx(np.percentile(vals, 50), abs=1e-3)


def test_histogram_ring_keeps_latest_window():
    h = telemetry.Histogram("lat", capacity=10)
    for v in range(100):
        h.observe(float(v))
    assert h.count == 100                      # true count survives the ring
    assert sorted(h.values()) == [float(v) for v in range(90, 100)]
    assert h.quantile(0.5) == pytest.approx(np.percentile(range(90, 100), 50))


def test_latency_summary_is_the_shared_schema():
    s = telemetry.latency_summary([1.0, 2.0, 3.0], unit="us")
    assert set(s) == {"n", "mean_us", "p50_us", "p95_us", "p99_us"}
    assert s["n"] == 3 and s["p50_us"] == 2.0
    assert s == jtel.latency_summary([1.0, 2.0, 3.0], unit="us")
    assert telemetry.latency_summary([], unit="ms")["n"] == 0


# ---------------------------------------------------------------------------
# trace + Prometheus format validation
# ---------------------------------------------------------------------------

def test_trace_validates_against_chrome_schema(tmp_path):
    with telemetry.tracing() as tr:
        with telemetry.span("forward", {"backend": "float"}):
            with telemetry.span("unpack"):
                pass
            with telemetry.span("encode"):
                pass
        tr.instant("marker")
    path = tr.save(str(tmp_path / "trace.json"))
    n = telemetry.validate_chrome_trace(path)
    assert n == 4
    obj = json.load(open(path))
    by_name = {e["name"]: e for e in obj["traceEvents"]}
    assert by_name["unpack"]["args"]["parent"] == "forward"
    assert by_name["encode"]["ph"] == "X" and by_name["encode"]["dur"] >= 0
    assert by_name["marker"]["ph"] == "i"
    # and the reference's validator accepts the port's trace
    assert jcheck.validate_chrome_trace(path) == 4


def test_trace_schema_violations_rejected():
    with pytest.raises(tcheck.TelemetryFormatError):
        telemetry.validate_chrome_trace({"events": []})    # wrong key
    with pytest.raises(tcheck.TelemetryFormatError):
        telemetry.validate_chrome_trace(
            {"traceEvents": [{"name": "x", "ph": "X", "ts": 0,
                              "pid": 1, "tid": 1}]})       # X without dur


def test_span_coverage_accounts_children():
    with telemetry.tracing() as tr:
        with tr.span("forward"):
            with tr.span("unpack"):
                sum(range(2000))
            with tr.span("encode"):
                sum(range(20000))
    cov = telemetry.span_coverage(tr, "forward")
    assert 0.5 < cov <= 1.0


def test_profiler_spans_reach_torch_profiler():
    """``profiler=True`` spans appear as ``record_function`` events."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with telemetry.tracing(profiler=True) as tr:
            with telemetry.span("stage_x"):
                torch.ones(4).sum()
    assert tr.durations_us("stage_x")
    assert "stage_x" in {e.key for e in prof.key_averages()}


def test_prometheus_export_validates():
    reg = telemetry.Registry()
    reg.counter("events_total", "events", {"backend": "lut"}).inc(3)
    reg.gauge("queue_depth", "depth").set(7)
    h = reg.histogram("hop_latency_ms", "latency", unit="ms")
    for v in range(50):
        h.observe(float(v))
    text = reg.to_prometheus()
    assert telemetry.validate_prometheus(text) == 7   # 1 + 1 + (3q + sum + n)
    assert 'events_total{backend="lut"} 3' in text
    with pytest.raises(tcheck.TelemetryFormatError):
        telemetry.validate_prometheus("no_type_line 1")
    # the reference's validator reads the port's exposition the same way
    assert jcheck.validate_prometheus(text) == 7


def test_reference_artifacts_pass_the_port_validators(tmp_path):
    reg = jtel.Registry()
    reg.counter("c_total", "c").inc(2)
    reg.histogram("h_ms", "h").observe(1.5)
    with jtel.tracing() as tr:
        with jtel.span("forward"):
            with jtel.span("encode"):
                pass
    trace = tr.save(str(tmp_path / "ref.json"))
    reg.save(str(tmp_path / "ref"))
    out = tcheck.check_artifacts(trace, require_metrics=True)
    assert out["events"] == 2 and out["prom_samples"] == 6
    assert telemetry.validate_prometheus(reg.to_prometheus()) == 6


def test_registry_save_layout_matches_checker(tmp_path):
    reg = telemetry.Registry()
    reg.counter("c_total").inc()
    with telemetry.tracing() as tr:
        with telemetry.span("hop"):
            pass
    trace = tr.save(str(tmp_path / "t.json"))
    reg.save(str(tmp_path / "t"))
    out = tcheck.check_artifacts(trace, require_metrics=True)
    assert out["events"] == 1 and out["prom_samples"] == 1
    assert jcheck.check_artifacts(trace, require_metrics=True) == out
    assert tcheck.main([trace, "--require-metrics"]) == 0
    assert tcheck.main([str(tmp_path / "missing.json")]) == 1


def test_structured_log_line_is_parseable(capsys):
    line = telemetry.log("serve_done", streams=4, rtf=0.123456,
                         note="two words")
    assert line.startswith("event=serve_done ts=")
    assert "rtf=0.1235" in line and 'note="two words"' in line
    assert capsys.readouterr().out.strip() == line


# ---------------------------------------------------------------------------
# disabled fast path: no per-call allocation
# ---------------------------------------------------------------------------

def test_disabled_span_is_shared_singleton():
    telemetry.disable()
    s = telemetry.span("anything")
    assert s is telemetry.NOOP_SPAN
    assert s is telemetry.span("something_else", {"k": 1})


def test_disabled_span_allocates_nothing():
    telemetry.disable()
    for _ in range(4):                      # warm any lazy caches
        with telemetry.span("warm"):
            pass
    tracemalloc.start()
    snap1 = tracemalloc.take_snapshot()
    for _ in range(200):
        with telemetry.span("hot"):
            pass
    snap2 = tracemalloc.take_snapshot()
    tracemalloc.stop()
    grew = [st for st in snap2.compare_to(snap1, "lineno")
            if st.size_diff > 0
            and "repro_torch/telemetry" in str(st.traceback)]
    assert not grew, f"disabled span path allocated: {grew}"


def test_engine_forward_disabled_path_unchanged(params, mfcc):
    """With tracing off and taps unplanned, forward is the plain call —
    same result; under a tracer the float plan records forward + encode
    (no unpack stage exists for it) and nothing once tracing is off."""
    telemetry.disable()
    eng = runtime.compile_model(CFG, params, backend="float", device="cpu")
    base = eng.forward(mfcc)
    with telemetry.tracing() as tr:
        traced = eng.forward(mfcc)
    assert torch.equal(base, traced)        # tracing never changes numerics
    names = {e["name"] for e in tr.events}
    assert names == {"forward", "encode"}
    after = eng.forward(mfcc)               # disabled again -> no new events
    assert torch.equal(base, after)
    assert len(tr.events) == 2


def test_engine_spans_by_plan(params, mfcc):
    """The non-executing resident plan has an unpack stage and records it;
    a taps plan records its taps pass; ``stream_step`` records
    ``stream_step`` > ``hop``.  Named children cover the parent."""
    from repro_torch.stream import engine as stream_engine
    from repro_torch.stream import features
    resident = runtime.compile_model(CFG, params, backend="lut",
                                     integer_exec=False, device="cpu")
    tapped = runtime.compile_model(CFG, params, backend="lut", taps=True,
                                   device="cpu")
    fcfg = features.FrontendConfig()
    state = stream_engine.init_stream_state(CFG, fcfg, 2, device="cpu")
    chunk = np.zeros((2, fcfg.hop_len), np.float32)
    want_state, want = resident.stream_step(state, chunk, fcfg)
    with telemetry.tracing() as tr:
        resident.forward(mfcc)
        tapped.forward(mfcc)
        _, got = resident.stream_step(state, chunk, fcfg)
    assert torch.equal(got, want)
    pairs = [(e["name"], e.get("args", {}).get("parent")) for e in tr.events]
    assert pairs.count(("unpack", "forward")) == 1
    assert pairs.count(("unpack", "stream_step")) == 1
    assert ("taps", "forward") in pairs and ("hop", "stream_step") in pairs
    assert telemetry.span_coverage(tr, "stream_step") > 0.5


def test_engine_handle_caches_live_params_per_generation(params, mfcc):
    eng = runtime.compile_model(CFG, params, backend="lut",
                                integer_exec=False, device="cpu")
    handle = runtime.EngineHandle(eng)
    lp = handle.live_params()
    assert handle.live_params() is lp and handle.generation == 0
    other = runtime.compile_model(CFG, params, backend="lut",
                                  integer_exec=False, device="cpu")
    assert handle.swap(other) is eng and handle.generation == 1
    assert handle.live_params() is not lp
    with pytest.raises(ValueError, match="exec config"):
        handle.swap(runtime.compile_model(CFG, params, backend="float",
                                          device="cpu"))


def test_quantize_params_shim_is_the_recipes_float_tree(params):
    got = runtime.quantize_params(params, CFG)
    want = runtime.QuantRecipe.from_config(CFG, rounding="nearest") \
        .apply(params)
    assert torch.equal(got["proj_w"], want["proj_w"])
    assert not torch.equal(got["proj_w"], params["proj_w"])


# ---------------------------------------------------------------------------
# perf.ledger provenance + the flight recorder
# ---------------------------------------------------------------------------

def test_provenance_fields():
    from repro_torch import perf
    p = perf.provenance("cal-1")
    assert {"git_commit", "torch_version", "cuda_version", "device",
            "power_limit", "timestamp", "calibration"} <= set(p)
    assert p["calibration"] == "cal-1" and p["torch_version"] == torch.__version__
    if not torch.cuda.is_available():
        assert p["device"] == "cpu" and p["power_limit"] is None


@pytest.fixture()
def flight(tmp_path):
    m = make_cell_metrics(telemetry.Registry())
    fr = FlightRecorder(m, FlightConfig(capacity=8, shed_spike=3,
                                        min_hops=4,
                                        dump_dir=str(tmp_path)),
                        stage_weights={"encode": 0.7, "featurise": 0.3})
    return m, fr


def test_flight_ring_wraps(flight):
    _, fr = flight
    for i in range(20):
        fr.record_hop(float(i))
    assert len(fr) == 8
    win = fr.window()
    assert [r.seq for r in win] == list(range(12, 20))
    assert win[-1].duration_ms == 19.0


def test_flight_shed_spike_dumps_once(flight):
    m, fr = flight
    for _ in range(4):
        fr.record_hop(1.0)
    m.rejected.inc(3)
    path = fr.record_hop(1.0)
    assert path is not None
    art = json.load(open(path))
    assert art["reason"] == "shed_spike"
    assert art["admission"]["rejected_in_window"] == 3
    # still tripped: no second dump until the window clears
    assert fr.record_hop(1.0) is None
    # spike rolls out of the 8-hop window -> re-arms -> a NEW spike dumps
    for _ in range(8):
        assert fr.record_hop(1.0) is None
    m.rejected.inc(3)
    assert fr.record_hop(1.0) is not None
    assert len(fr.dumps) == 2


def test_flight_slo_burn_uses_budget_gauge(flight):
    m, fr = flight
    m.latency_budget.set(10.0)
    for _ in range(3):
        assert fr.record_hop(50.0) is None     # below min_hops: no dump
    path = fr.record_hop(50.0)
    assert path is not None and "slo_burn" in path
    att = json.load(open(path))["attribution"]
    assert att["slowest_stage"] == "encode"    # 0.7 weight wins
    assert att["method"] == "cost-model-weights"
    assert att["stage_ms"]["encode"] == pytest.approx(35.0)


def test_flight_swap_failure_via_check(flight):
    m, fr = flight
    for _ in range(2):
        fr.record_hop(1.0)
    assert fr.check() is None
    m.swap_failures.inc()                      # probe-parity refusal
    path = fr.check()                          # between hops, no new slot
    assert path is not None
    assert json.load(open(path))["reason"] == "swap_failure"
    assert len(fr) == 2                        # check() consumed no slot


def test_flight_attribution_prefers_measured_spans(flight):
    m, fr = flight
    m.latency_budget.set(10.0)
    for _ in range(4):
        fr.record_hop(50.0, spans={"featurise": 40.0, "encode": 9.0})
    att = fr.attribution()
    assert att["method"] == "measured-spans"
    assert att["slowest_stage"] == "featurise"


def test_flight_lazy_stage_weights_resolve_once(tmp_path):
    m = make_cell_metrics(telemetry.Registry())
    calls = []

    def weights():
        calls.append(1)
        return {"encode": 1.0}

    fr = FlightRecorder(m, FlightConfig(capacity=4,
                                        dump_dir=str(tmp_path)),
                        stage_weights=weights)
    fr.record_hop(1.0)
    fr.dump("manual")
    fr.dump("manual")
    assert len(calls) == 1                     # resolved once, then cached


def test_flight_dump_artifact_schema(flight):
    m, fr = flight
    for i in range(6):
        fr.record_hop(1.0 + i)
    path = fr.dump("manual")
    art = json.load(open(path))
    assert {"reason", "provenance", "attribution", "admission",
            "hotswap", "trace", "hop_latency"} <= set(art)
    assert len(art["trace"]) == 6
    assert art["provenance"]["git_commit"]
    assert os.path.exists(path)


def test_flight_without_weights_charges_encode(tmp_path):
    """What the port's StreamLanes installs until the cost model exists:
    no stage weights, so a span-less dump charges the hop to encode."""
    m = make_cell_metrics(telemetry.Registry())
    fr = FlightRecorder(m, FlightConfig(capacity=4, dump_dir=str(tmp_path)))
    fr.record_hop(3.0)
    att = json.load(open(fr.dump("manual")))["attribution"]
    assert att["stage_ms"] == {"encode": 3.0}
