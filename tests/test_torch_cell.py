"""repro_torch.cell and the stream-serve launcher, on the CPU.

The reference's own contracts (``tests/test_cell.py``: admission control,
hop-pipeline parity, checkpoint hot-swap, lane recycling, the exact hop
ledger, the crash-faithful telemetry flush), restated for the port, plus
parity against the reference on the same numpy inputs and weights:

* ``ServeCell`` / ``StreamLanes`` in both packages on the same chunk
  sequence: detector events equal and scores within ``SCORE_ATOL`` 1e-5
  (measured 1.2e-7 under ``float``, 6.0e-8 under ``lut``: the MFCC
  frames' FFT rounding, ``tests/test_torch_stream.py``);
* the pipelined and feature-ingest lanes, ``HopPipeline.step`` and
  ``HopPipeline.run`` against the fused ``stream_step``: bit-exact;
* ``stream_serve.main`` end to end on the CPU with ``--telemetry-out``:
  the hop ledger is exact and the artifacts pass both packages'
  validators.

On the card ``chip_smoke.py`` holds the same contracts under ``cuda``
(two CUDA streams in the pipelined lanes, the ``lut`` parity gate of a
``cuda`` cell's hot-swap).
"""

import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import cell as jcell
from repro import runtime as jrt
from repro import telemetry as jtel
from repro.configs import registry as jregistry
from repro.models import kwt as jkwt
from repro.stream import detector as jdet
from repro.stream import features as jfeatures
from repro.telemetry import check as jcheck
from repro_torch import cell as cellmod
from repro_torch import convert
from repro_torch import runtime
from repro_torch import telemetry
from repro_torch.cell import admission as admission_mod
from repro_torch.checkpoint import manager
from repro_torch.configs import registry
from repro_torch.core import quant
from repro_torch.core.tree import tree_map
from repro_torch.launch import serve_common
from repro_torch.launch import stream_serve
from repro_torch.models import kwt
from repro_torch.stream import detector as det
from repro_torch.stream import engine as stream_engine
from repro_torch.stream import features
from repro_torch.telemetry import check as tcheck

torch.set_num_threads(1)

FCFG = features.FrontendConfig()
HOP = FCFG.hop_len
SCORE_ATOL = 1e-5


@pytest.fixture(scope="module")
def kwt_setup():
    cfg = registry.get("kwt-tiny").smoke
    params = kwt.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    return cfg, params


def _metrics():
    return telemetry.make_cell_metrics(telemetry.Registry())


def _compile(cfg, params, backend, **kw):
    return runtime.compile_model(cfg, params, backend=backend, device="cpu",
                                 **kw)


# ---------------------------------------------------------------------------
# admission control
# ---------------------------------------------------------------------------

class _Clock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def test_admission_bounded_queue():
    met = _metrics()
    a = admission_mod.AdmissionController(
        admission_mod.AdmissionConfig(max_queue=2), metrics=met)
    assert a.offer("s0").admitted and a.offer("s1").admitted
    d = a.offer("s2")
    assert not d.admitted and d.reason == "queue_full"
    assert met.admitted.value == 2 and met.rejected.value == 1
    assert a.pop() == "s0" and len(a) == 1


def test_admission_token_bucket():
    clk = _Clock()
    a = admission_mod.AdmissionController(
        admission_mod.AdmissionConfig(max_queue=100, rate=2.0, burst=2),
        clock=clk)
    assert a.offer(0).admitted and a.offer(1).admitted
    assert a.offer(2).reason == "rate"           # bucket drained
    clk.t += 0.5                                 # refills one token
    assert a.offer(3).admitted
    assert not a.offer(4).admitted


def test_admission_deadline_shed():
    clk = _Clock()
    met = _metrics()
    a = admission_mod.AdmissionController(
        admission_mod.AdmissionConfig(max_queue=10, deadline_ms=100.0),
        metrics=met, clock=clk)
    a.offer("stale")
    clk.t += 0.2                                 # 200 ms > deadline
    a.offer("fresh")
    assert a.pop() == "fresh"                    # stale one was shed
    assert met.rejected.value == 1


def test_admission_degrades_before_rejecting():
    clk = _Clock()
    met = _metrics()
    cfg = admission_mod.AdmissionConfig(max_queue=4, degrade_queue=2,
                                        degraded_chunk_hops=4,
                                        deadline_ms=1000.0)
    a = admission_mod.AdmissionController(cfg, metrics=met, clock=clk)
    a.offer(0)
    a.offer(1)
    assert a.chunk_hops() == 1                   # within bounds
    a.offer(2)                                   # queue depth 3 > 2
    assert a.chunk_hops() == 4                   # degraded, nothing shed
    assert met.degraded.value == 1 and met.rejected.value == 0
    a.offer(3)
    assert not a.offer(4).admitted               # only now: reject
    for _ in range(4):
        a.pop()
    assert a.chunk_hops() == 1                   # drained: recovers


# ---------------------------------------------------------------------------
# hop pipeline
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("backend", ["float", "lut"])
def test_pipeline_split_matches_fused(kwt_setup, backend):
    """The featurise/encode split reproduces the fused stream_step logits
    bit for bit, and the pipelined generator reproduces the synchronous
    split path."""
    cfg, params = kwt_setup
    eng = _compile(cfg, params, backend)
    pipe = cellmod.HopPipeline(eng, FCFG)
    rng = np.random.RandomState(0)
    chunks = [rng.randn(2, HOP).astype(np.float32) * 0.1 for _ in range(5)]

    s_fused = stream_engine.init_stream_state(cfg, FCFG, 2,
                                              keep_features=False,
                                              device="cpu")
    s_split = pipe.init_state(2)
    sync = []
    for c in chunks:
        s_fused, l_f = eng.stream_step(s_fused, c, FCFG)
        s_split, l_s = pipe.step(s_split, c)
        assert torch.equal(l_f, l_s)
        sync.append(l_s)
    piped = [lg for _, lg in pipe.run(pipe.init_state(2), chunks)]
    assert len(piped) == len(sync)
    for a, b in zip(sync, piped):
        assert torch.equal(a, b)
    assert not torch.is_inference_mode_enabled()   # nothing leaks out


# ---------------------------------------------------------------------------
# hot-swap
# ---------------------------------------------------------------------------

def _probe(cfg):
    """A representative probe batch.  (An all-zero MFCC is not one: it
    leaves only the quantised positions in the tokens, which LayerNorm
    blows up, so the integer-executing plan of a perfectly good artifact
    can sit over 0.5 from its float view — in either package, on the same
    weights.)"""
    return np.random.RandomState(1).randn(1, *cfg.input_dim) \
        .astype(np.float32)


def _packed(cfg, seed):
    """A packed int8 QTensor tree — the deploy artifact hot_swap loads."""
    params = kwt.init_params(cfg, torch.Generator().manual_seed(seed), "cpu")
    return runtime.QuantRecipe.from_config(cfg).quantize(params)


def _corrupt(qtree):
    """Wrong exponents on every packed weight: the float view grows 2^10
    times and the integer-executing plan saturates — the kind of broken
    artifact the gate must refuse."""
    return tree_map(lambda leaf: quant.QTensor(
        values=leaf.values, exponent=leaf.exponent - 10,
        axis_exponents=leaf.axis_exponents, bits=leaf.bits,
        logical_shape=leaf.logical_shape)
        if isinstance(leaf, quant.QTensor) else leaf, qtree)


def test_hot_swap_parity_gate_and_generation(kwt_setup):
    cfg, _ = kwt_setup
    eng = _compile(cfg, _packed(cfg, 0), "lut")
    assert eng.int_resident
    handle = runtime.EngineHandle(eng)
    probe = _probe(cfg)
    before = handle.engine.forward(probe)
    lp0 = handle.live_params()
    assert handle.live_params() is lp0           # cached per generation

    met = _metrics()
    q2 = _packed(cfg, 7)
    old = cellmod.hot_swap(handle, q2, probe, metrics=met)
    assert old is eng and handle.generation == 1
    assert met.swaps.value == 1 and met.swap_failures.value == 0
    after = handle.engine.forward(probe)
    assert not torch.equal(before, after)
    # the deploy gate's own criterion, re-checked from outside
    assert handle.engine.int_exec
    same = _compile(cfg, q2, "lut")
    assert torch.equal(after, same.forward(probe))
    ref = _compile(cfg, q2, "lut", integer_resident=False, integer_exec=False)
    assert float((after - ref.forward(probe)).abs().max()) <= \
        cellmod.hotswap._INT_EXEC_PROBE_TOL
    assert handle.live_params() is not lp0       # cache invalidated


def test_hot_swap_refuses_a_corrupted_artifact(kwt_setup, tmp_path):
    """Fails closed: SwapRejected, swap_failures + 1, the old engine
    serving, and the flight recorder's swap_failure dump."""
    cfg, _ = kwt_setup
    eng = _compile(cfg, _packed(cfg, 0), "lut")
    cell = cellmod.ServeCell(eng, slots=1, registry=telemetry.Registry(),
                             flight=telemetry.FlightConfig(
                                 dump_dir=str(tmp_path)))
    probe = _probe(cfg)
    cell.flight.record_hop(1.0)                  # a serving cell has hops
    with pytest.raises(cellmod.SwapRejected):
        cellmod.hot_swap(cell.handle, _corrupt(_packed(cfg, 7)), probe,
                         metrics=cell.metrics)
    assert cell.metrics.swap_failures.value == 1
    assert cell.engine is eng and cell.handle.generation == 0
    path = cell.flight.check()
    assert path is not None and json.load(open(path))["reason"] == \
        "swap_failure"
    assert len(cell.flight.dumps) == 1


def test_hot_swap_strict_rejects_exec_mismatch(kwt_setup):
    cfg, params = kwt_setup
    handle = runtime.EngineHandle(_compile(cfg, params, "float"))
    other = _compile(cfg, params, "lut")
    with pytest.raises(ValueError, match="exec config"):
        handle.swap(other)
    assert handle.generation == 0                # untouched


def test_watcher_and_poll_and_swap(kwt_setup, tmp_path):
    cfg, _ = kwt_setup
    like = _packed(cfg, 0)
    handle = runtime.EngineHandle(_compile(cfg, like, "lut"))
    probe = _probe(cfg)
    w = cellmod.CheckpointWatcher(str(tmp_path))
    assert w.poll() is None
    assert not cellmod.poll_and_swap(handle, w, like, probe)
    manager.save(str(tmp_path), 5, _packed(cfg, 3))
    assert w.poll() == 5
    assert cellmod.poll_and_swap(handle, w, like, probe)
    assert handle.generation == 1 and w.last_step == 5
    assert not cellmod.poll_and_swap(handle, w, like, probe)  # consumed


def test_watcher_wait_timeout_injected_clock(tmp_path):
    t = {"now": 0.0}
    slept = []

    def sleep(s):
        slept.append(s)
        t["now"] += s

    w = cellmod.CheckpointWatcher(str(tmp_path), poll_s=0.25,
                                  clock=lambda: t["now"], sleep=sleep)
    assert w.wait_for_new_step(timeout_s=1.0) is None
    assert slept and t["now"] >= 1.0


# ---------------------------------------------------------------------------
# checkpoint manager: latest-step discovery under partial writes
# ---------------------------------------------------------------------------

def test_latest_step_skips_partial_writes(tmp_path):
    d = str(tmp_path)
    manager.save(d, 3, {"w": torch.ones((2,))})
    os.makedirs(os.path.join(d, "step_00000009.tmp-abcd1234"))
    os.makedirs(os.path.join(d, "step_00000007"))
    os.makedirs(os.path.join(d, "step_00000008"))
    with open(os.path.join(d, "step_00000008", "manifest.json"), "w") as f:
        json.dump({"step": 8}, f)
    os.makedirs(os.path.join(d, "step_00000011"))
    with open(os.path.join(d, "step_00000011", "manifest.json"), "w") as f:
        f.write('{"step": 11')
    os.makedirs(os.path.join(d, "step_garbage"))
    open(os.path.join(d, "step_"), "w").close()
    assert manager.latest_step(d) == 3
    manager.save(d, 12, {"w": torch.ones((2,))})
    assert manager.latest_step(d) == 12


def test_latest_step_missing_dir():
    assert manager.latest_step("/nonexistent/ckpts") is None


# ---------------------------------------------------------------------------
# detector lane recycling
# ---------------------------------------------------------------------------

def test_recycled_lane_must_not_inherit_detector_state():
    dcfg = det.DetectorConfig(smooth_hops=2, on_threshold=0.6,
                              off_threshold=0.4, refractory_hops=50)
    hot = torch.tensor([[0.1, 0.9]])
    state = det.detector_init(dcfg, 1, device="cpu")
    fired_hops = []
    for _ in range(4):
        state, ev = det.detector_step(state, hot, dcfg)
        fired_hops.append(bool(ev["fired"][0]))
    assert any(fired_hops)

    leaked = state
    for _ in range(4):
        leaked, ev = det.detector_step(leaked, hot, dcfg)
        assert not bool(ev["fired"][0])

    clean = det.detector_reset_lane(state, 0)
    fired2 = []
    for _ in range(4):
        clean, ev = det.detector_step(clean, hot, dcfg)
        fired2.append(bool(ev["fired"][0]))
    assert fired2 == fired_hops


def test_detector_reset_lane_accepts_index_array():
    dcfg = det.DetectorConfig()
    state = det.detector_init(dcfg, 4, device="cpu")
    state = {**state, "cooldown": state["cooldown"] + 9}
    state = det.detector_reset_lane(state, torch.tensor([1, 3]))
    assert state["cooldown"].tolist() == [9, 0, 9, 0]


# ---------------------------------------------------------------------------
# ServeCell + StreamLanes
# ---------------------------------------------------------------------------

def test_stream_lanes_lifecycle_and_ledger(kwt_setup):
    cfg, params = kwt_setup
    cell = cellmod.ServeCell(_compile(cfg, params, "float"), slots=2,
                             registry=telemetry.Registry())
    rng = np.random.RandomState(0)
    with cell:
        lanes = cell.stream_lanes(FCFG, det.DetectorConfig())
        lanes.join(0)
        lanes.join(1)
        with pytest.raises(AssertionError):
            lanes.join(0)                        # occupied
        for _ in range(3):
            lanes.hop(rng.randn(2, HOP).astype(np.float32))
        lanes.evict(1)
        lanes.hop(rng.randn(2, HOP).astype(np.float32))
        lanes.hop(np.zeros((2, HOP), np.float32), ingest=np.asarray([1, 0]))
        m = cell.metrics
        assert m.joins.value == 2 and m.evictions.value == 1
        assert m.hops.value == 3 * 2 + 1 + 1
        assert m.dropped_hops.value == 0
        assert lanes.free_lanes() == [1]


def test_stream_lanes_pipelined_matches_joint(kwt_setup):
    cfg, params = kwt_setup
    eng = _compile(cfg, params, "float")
    cell = cellmod.ServeCell(eng, slots=2, registry=telemetry.Registry())
    rng = np.random.RandomState(2)
    chunks = [rng.randn(2, HOP).astype(np.float32) for _ in range(4)]
    with cell:
        a = cell.stream_lanes(FCFG, det.DetectorConfig())
        b = cell.stream_lanes(FCFG, det.DetectorConfig(), pipelined=True)
        r = cell.stream_lanes(FCFG, det.DetectorConfig(), pipelined=True)
        for lanes in (a, b, r):
            lanes.join(0)
            lanes.join(1)
        joint = []
        for c in chunks:
            ea, eb = a.hop(c), b.hop(c)
            np.testing.assert_array_equal(ea["score"], eb["score"])
            np.testing.assert_array_equal(ea["fired"], eb["fired"])
            joint.append(ea)
        # the lookahead loop gives the same events hop by hop
        ran = list(r.run(chunks))
        assert len(ran) == len(joint)
        for ea, er in zip(joint, ran):
            np.testing.assert_array_equal(ea["score"], er["score"])
        assert cell.metrics.hops.value == 3 * 2 * len(chunks)


def test_stream_lanes_feature_ingest_matches_audio(kwt_setup):
    cfg, params = kwt_setup
    eng = _compile(cfg, params, "float")
    cell = cellmod.ServeCell(eng, slots=2, registry=telemetry.Registry())
    rng = np.random.RandomState(4)
    with cell:
        with pytest.raises(AssertionError):
            cell.stream_lanes(FCFG, det.DetectorConfig(),
                              feature_ingest=True, pipelined=True)
        a = cell.stream_lanes(FCFG, det.DetectorConfig())
        f = cell.stream_lanes(FCFG, det.DetectorConfig(),
                              feature_ingest=True)
        for lanes in (a, f):
            lanes.join(0)
            lanes.join(1)
        edge = features.frontend_init(FCFG, 2, device="cpu")
        for _ in range(4):
            c = rng.randn(2, HOP).astype(np.float32)
            edge, frames = features.frontend_push(edge, torch.from_numpy(c),
                                                  FCFG)
            ea, ef = a.hop(c), f.hop(frames)
            np.testing.assert_array_equal(ea["score"], ef["score"])
            np.testing.assert_array_equal(ea["fired"], ef["fired"])


def test_cell_swap_under_streaming_drops_nothing(kwt_setup, tmp_path):
    cfg, _ = kwt_setup
    like = _packed(cfg, 0)
    probe = _probe(cfg)
    cell = cellmod.ServeCell(
        _compile(cfg, like, "lut"), slots=2,
        registry=telemetry.Registry(), watch_dir=str(tmp_path),
        watch_like=like, probe=probe)
    rng = np.random.RandomState(3)
    n_hops = 6
    with cell:
        lanes = cell.stream_lanes(FCFG, det.DetectorConfig())
        lanes.join(0)
        lanes.join(1)
        for h in range(n_hops):
            if h == 2:
                manager.save(str(tmp_path), 1, _packed(cfg, 9))
            assert cell.maybe_swap() == (h == 2)
            lanes.hop(rng.randn(2, HOP).astype(np.float32))
        m = cell.metrics
        assert cell.handle.generation == 1 and m.swaps.value == 1
        assert m.hops.value == n_hops * 2 and m.dropped_hops.value == 0
        want = min(n_hops, stream_engine.window_frames(cfg))
        assert int(lanes.state["embed"]["count"][0]) == want


def test_cell_watcher_requires_template_and_probe(kwt_setup):
    cfg, params = kwt_setup
    eng = _compile(cfg, params, "float")
    with pytest.raises(AssertionError):
        cellmod.ServeCell(eng, slots=1, registry=telemetry.Registry(),
                          watch_dir="/tmp/nowhere")


def test_cuda_cell_needs_the_card(kwt_setup):
    """No fallback: a cuda plan on a CPU device raises, in the cell's
    constructor path and in the launcher."""
    cfg, params = kwt_setup
    with pytest.raises(ValueError, match="CUDA device"):
        cellmod.ServeCell(_compile(cfg, params, "cuda"), slots=1)
    with pytest.raises(ValueError, match="CUDA device"):
        stream_serve.main(["--device", "cpu", "--backend", "cuda",
                           "--train-steps", "0", "--streams", "1"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            stream_serve.main(["--train-steps", "0", "--streams", "1"])


@pytest.mark.parametrize("backend", ["float", "lut"])
def test_cell_matches_the_reference_cell(backend):
    """The same weights, chunks and detector in both packages' cells:
    events equal, scores within SCORE_ATOL."""
    jcfg, tcfg = jregistry.get("kwt-tiny").config, registry.get("kwt-tiny").config
    shapes = jax.eval_shape(lambda k: jkwt.init_params(jcfg, k),
                            jax.random.PRNGKey(0))
    rng = np.random.default_rng(0)
    npp = jax.tree.map(lambda s: rng.normal(
        0, 1 / np.sqrt(s.shape[0]) if len(s.shape) > 1 else 0.1,
        s.shape).astype(np.float32), shapes)
    npp["head_b"] = np.array([-0.25, 0.25], np.float32)   # keyword-leaning
    kw = dict(on_threshold=0.57, off_threshold=0.5, refractory_hops=5)
    jc = jcell.ServeCell(jrt.compile_model(
        jcfg, jax.tree.map(jnp.asarray, npp), backend=backend), slots=4,
        registry=jtel.Registry())
    tc = cellmod.ServeCell(runtime.compile_model(
        tcfg, convert.from_numpy_tree(npp, "cpu"), backend=backend,
        device="cpu"), slots=4, registry=telemetry.Registry())
    fired = 0
    with jc, tc:
        jl = jc.stream_lanes(jfeatures.FrontendConfig(),
                             jdet.DetectorConfig(**kw))
        tl = tc.stream_lanes(FCFG, det.DetectorConfig(**kw))
        for lane in range(4):
            jl.join(lane)
            tl.join(lane)
        r = np.random.RandomState(0)
        for h in range(45):
            if h == 20:                          # recycle one lane mid-run
                jl.evict(2), tl.evict(2)
                jl.join(2), tl.join(2)
            c = (0.3 * r.randn(4, HOP)).astype(np.float32)
            a, b = jl.hop(c), tl.hop(c)
            np.testing.assert_array_equal(np.asarray(a["fired"]), b["fired"])
            np.testing.assert_allclose(b["score"], np.asarray(a["score"]),
                                       rtol=0, atol=SCORE_ATOL)
            fired += int(b["fired"].sum())
    assert fired > 0
    assert tc.metrics.hops.value == jc.metrics.hops.value == 45 * 4


# ---------------------------------------------------------------------------
# serve_common: crash-faithful telemetry flush
# ---------------------------------------------------------------------------

def test_session_flushes_on_exception(tmp_path, capsys):
    out = str(tmp_path / "trace.json")
    with pytest.raises(RuntimeError, match="boom"):
        with serve_common.session(out) as (tracer, met):
            met.counter("serve_test_total").inc(3)
            with telemetry.span("doomed"):
                pass
            raise RuntimeError("boom")
    assert os.path.exists(out)
    assert os.path.exists(str(tmp_path / "trace.prom"))
    with open(str(tmp_path / "trace.metrics.json")) as f:
        assert json.load(f)["serve_test_total"]["value"] == 3
    assert "aborted=RuntimeError" in capsys.readouterr().out


def test_session_flushes_on_keyboard_interrupt(tmp_path):
    out = str(tmp_path / "trace.json")
    with pytest.raises(KeyboardInterrupt):
        with serve_common.session(out):
            raise KeyboardInterrupt
    assert os.path.exists(out)
    assert os.path.exists(str(tmp_path / "trace.metrics.json"))


def test_session_isolates_artifact_save_failures(tmp_path, monkeypatch):
    out = str(tmp_path / "trace.json")
    monkeypatch.setattr(
        telemetry.Tracer, "save",
        lambda self, p: (_ for _ in ()).throw(OSError("disk full")))
    with serve_common.session(out) as (tracer, met):
        met.gauge("serve_test_gauge").set(7.0)
    assert not os.path.exists(out)
    with open(str(tmp_path / "trace.metrics.json")) as f:
        assert json.load(f)["serve_test_gauge"]["value"] == 7.0


def test_session_disabled_without_out_path():
    with serve_common.session(None) as (tracer, met):
        assert tracer is None
        assert telemetry.active_tracer() is None


# ---------------------------------------------------------------------------
# the launcher end to end
# ---------------------------------------------------------------------------

def _log_fields(out: str, event: str) -> dict:
    line = next(ln for ln in out.splitlines()
                if ln.startswith(f"event={event} "))
    return dict(p.split("=", 1) for p in line.split()[2:])


def test_stream_serve_end_to_end_on_the_cpu(tmp_path, capsys):
    out = str(tmp_path / "t.json")
    stream_serve.main(["--device", "cpu", "--backend", "lut", "--streams", "8",
                       "--slots", "4", "--hops", "60", "--train-steps", "4",
                       "--degrade-queue", "2", "--telemetry-out", out])
    log = capsys.readouterr().out
    done = _log_fields(log, "serve_done")
    assert done["ingested_hops"] == done["offered_hops"]    # exact ledger
    assert int(done["streams"]) == 8 and done["backend"] == "lut"
    summary = tcheck.check_artifacts(out, require_metrics=True)
    assert summary == jcheck.check_artifacts(out, require_metrics=True)
    metrics = json.load(open(str(tmp_path / "t.metrics.json")))
    assert metrics["cell_hops_total"]["value"] == float(done["ingested_hops"])
    assert metrics["cell_dropped_hops_total"]["value"] == 0
    assert metrics["cell_lane_joins_total"]["value"] == 8
    names = {(e["name"], e.get("args", {}).get("parent"))
             for e in json.load(open(out))["traceEvents"]}
    # the joint lanes go through Engine.stream_step under the tracer
    assert {("hop", None), ("stream_step", "hop"),
            ("hop", "stream_step")} <= names
    # the CLI validator of the port reads the same artifacts
    assert tcheck.main([out, "--require-metrics"]) == 0


def test_port_cell_modules_import_without_jax_or_the_reference():
    code = (
        "import sys\n"
        "for name in ('jax', 'jaxlib', 'repro'):\n"
        "    sys.modules[name] = None\n"
        "import repro_torch.cell, repro_torch.telemetry, repro_torch.perf, "
        "repro_torch.dist.ctx, repro_torch.launch.mesh, "
        "repro_torch.launch.stream_serve, repro_torch.data.prng\n"
        "import repro_torch.telemetry.__main__\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.') "
        "or m == 'repro' or m.startswith('repro.')]\n"
        "assert all(sys.modules[m] is None for m in bad), bad\n"
        "print('ok')\n")
    src = os.path.join(os.path.dirname(os.path.dirname(__file__)), "src")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env={**os.environ, "PYTHONPATH": src},
                         timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr
