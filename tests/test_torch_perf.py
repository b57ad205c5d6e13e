"""The cost model and the rooflines: ``repro_torch.perf`` against
``repro.perf`` on the same numpy weights and inputs, plus
``repro_torch.core.calibrate`` against ``repro.core.calibrate``.

The reference's cost model classifies equations by their trace-time frames
(``repro.analysis.jaxpr_walk.user_frames``).  Under jax 0.9 that helper
hands ``source_info_util.user_frames`` the whole ``SourceInfo`` where jax
now takes its traceback, gets an ``AttributeError`` and returns no frames,
so every equation lands in the default stage as ``other`` (and the
reference's own ``tests/test_perf.py`` fails 5 cases on such a host).  The
fixture below hands that helper the traceback for this module only; no
file of the reference changes.

Stated tolerances, with the measured error behind them (KWT-Tiny at full
size and KWT-1 at its smoke size, batches 1 and 4, PyTorch CPU vs the
reference's jaxprs):

* ``matmul_flops`` and the (stage, op) keys: exact.
* FLOPs per (stage, op) line: rtol 0.15.  Measured max 0.114 (KWT-1
  ``lut``, encode/other: the fused Q/K/V and the per-column requant are
  realised with other element-wise ops than the reference's).
* Bytes per (stage, op) line: rtol 0.25.  Measured max 0.203 (KWT-Tiny
  ``lut`` B=1, embed/other, 1.5 kB of the container ``cat``); 0.115 on the
  LUT softmax (the port indexes its tables with int64).  Not compared:
  the bytes of the ``matmul`` lines of integer-executing plans — the
  reference unrolls products of at most 8192 MACs into multiply-add chains
  and counts their intermediates (KWT-Tiny B=1 embed: 78560 B against one
  product's 3680 B).
* Stream-hop stage weights on the paper's MCU: atol 0.02.  Measured max
  0.004 (featurise; the port frames audio with a strided view where the
  reference gathers).

The LM plans (internlm2, granite-moe, rwkv6, hymba smoke configs, batch 2
of the default 8 tokens, ``float`` / ``lut`` / ``lut_resident``) are held
to the same terms.  Measured: ``matmul_flops`` and the keys exact; FLOPs
per line at most 0.057 apart (the fixed-point masked softmax: the port
takes its clips as one ``clamp``); bytes at most 0.218 (granite-moe's
``other``: the dispatch's one ``index_put_`` and its one-hot positions
move more than the reference's scatter), 0.132 on hymba's ``other`` and
0.16 on the float softmax (the port's one ``_softmax``).  The
reference's frames of a cached trace (``jnp.clip`` is jitted) are its
first caller's, so an equation's class depends on what was priced before
it in the process; its caches are cleared before each LM pricing.
"""

import json
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax._src import source_info_util

from repro import perf as jperf
from repro import runtime as jrt
from repro.analysis import jaxpr_walk as jw
from repro.configs import registry as jregistry
from repro.core import calibrate as jcal
from repro.models import kwt as jkwt
from repro.models import layers as jlayers
from repro.stream import features as jfeatures
from repro_torch import analysis, convert
from repro_torch import cell as cellmod
from repro_torch import perf as tperf
from repro_torch import runtime as trt
from repro_torch import telemetry
from repro_torch.analysis import op_walk
from repro_torch.configs import registry as tregistry
from repro_torch.core import calibrate as tcal
from repro_torch.kernels import lut_gelu as tgelu_mod
from repro_torch.kernels import ops
from repro_torch.models import kwt as tkwt
from repro_torch.models import layers as tlayers
from repro_torch.perf import __main__ as perf_cli
from repro_torch.perf import cost as tcost
from repro_torch.stream import detector
from repro_torch.stream import features as tfeatures

torch.set_num_threads(1)

FLOPS_RTOL = 0.15
BYTES_RTOL = 0.25
WEIGHTS_ATOL = 0.02

MODELS = {"kwt-tiny": False, "kwt-1": True}     # name -> use the smoke config
LM_MODELS = ["internlm2-1.8b", "granite-moe-3b-a800m", "rwkv6-3b",
             "hymba-1.5b"]
LM_PLANS = ["float", "lut", "lut_resident"]
LM_BATCH = 2


@pytest.fixture(scope="module", autouse=True)
def _reference_frames():
    def user_frames(eqn):
        try:
            return list(source_info_util.user_frames(
                eqn.source_info.traceback))
        except Exception:
            return []

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jw, "user_frames", user_frames)
        yield


def _np_params(jcfg, seed=0):
    shapes = jax.eval_shape(lambda k: jkwt.init_params(jcfg, k),
                            jax.random.PRNGKey(0))
    rng = np.random.default_rng(seed)

    def leaf(s):
        scale = 1.0 / np.sqrt(s.shape[0]) if len(s.shape) > 1 else 0.1
        return rng.normal(0, scale, s.shape).astype(np.float32)

    return jax.tree.map(leaf, shapes)


_SETUP = {}


def _setup(name):
    if name not in _SETUP:
        je, te = jregistry.get(name), tregistry.get(name)
        jcfg, tcfg = (je.smoke, te.smoke) if MODELS[name] else \
            (je.config, te.config)
        npp = _np_params(jcfg)
        _SETUP[name] = (jcfg, tcfg, npp, jax.tree.map(jnp.asarray, npp))
    return _SETUP[name]


# plan name -> (backend, compile_model keywords)
PLANS = {"float": ("float", {}), "lut_float": ("lut_float", {}),
         "lut": ("lut", {}), "lut_resident": ("lut", {"integer_exec": False})}

_ENGINES = {}


def _engines(name, plan):
    key = (name, plan)
    if key not in _ENGINES:
        jcfg, tcfg, npp, jp = _setup(name)
        backend, kw = PLANS[plan]
        _ENGINES[key] = (
            jrt.compile_model(jcfg, jp, backend=backend, **kw),
            trt.compile_model(tcfg, convert.from_numpy_tree(npp, "cpu"),
                              backend=backend, device="cpu", **kw))
    return _ENGINES[key]


_COSTS = {}


def _costs(name, plan, batch):
    key = (name, plan, batch)
    if key not in _COSTS:
        je, te = _engines(name, plan)
        _COSTS[key] = (jperf.engine_cost(je, batch=batch),
                       tperf.engine_cost(te, batch=batch))
    return _COSTS[key]


def _analytic_matmul_flops(cfg, batch):
    """tests/test_perf.py's hand count of a KWT forward's products."""
    f, t_in = cfg.input_dim
    d, h = cfg.d_model, cfg.n_heads
    dh = cfg.resolved_head_dim
    t = t_in + 1
    per_layer = (3 * 2 * t * d * (h * dh) + 2 * 2 * h * t * t * dh
                 + 2 * t * (h * dh) * d + 2 * t * d * cfg.d_ff
                 + 2 * t * cfg.d_ff * d)
    return batch * (2 * t_in * d * f + cfg.n_layers * per_layer
                    + 2 * d * cfg.n_classes)


def analytic_lm_matmul_flops(cfg, batch, t):
    """A dense LM forward's products over ``t`` tokens: Q, K, V and O,
    the full ``t x t`` score and value products, the gated MLP, the
    untied head."""
    d, h, kv, dh, f = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                       cfg.resolved_head_dim, cfg.d_ff)
    per_layer = (2 * t * d * h * dh + 2 * 2 * t * d * kv * dh
                 + 2 * 2 * h * t * t * dh + 2 * t * h * dh * d
                 + 3 * 2 * t * d * f)
    return batch * (cfg.n_layers * per_layer + 2 * t * d * cfg.padded_vocab)


def _lm_np_params(jcfg, seed=0):
    """Every leaf random (tests/test_torch_lm_model.py's ``np_params``)."""
    from repro.models import transformer as JT
    shapes = jax.eval_shape(lambda k: JT.init_params(jcfg, k),
                            jax.random.PRNGKey(0))
    rng = np.random.default_rng(seed)

    def leaf(path, s):
        names = [getattr(k, "key", "") for k in path]
        per = s.shape[1:] if names[0] == "blocks" else s.shape
        if "scale" in names:
            return rng.normal(1.0, 0.1, s.shape).astype(np.float32)
        scale = 1.0 / np.sqrt(per[0]) if len(per) > 1 else 0.1
        return rng.normal(0, scale, s.shape).astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


_LM = {}


def _lm_setup(name):
    if name not in _LM:
        jcfg, tcfg = jregistry.get(name).smoke, tregistry.get(name).smoke
        npp = _lm_np_params(jcfg)
        _LM[name] = (jcfg, tcfg, npp)
    return _LM[name]


def _lm_engine(name, plan):
    """The port's plan of an LM smoke config (``cuda``: its plain
    versions)."""
    key = ("port", name, plan)
    if key not in _ENGINES:
        _, tcfg, npp = _lm_setup(name)
        backend, kw = PLANS.get(plan, (plan, {}))
        _ENGINES[key] = trt.compile_model(
            tcfg, convert.from_numpy_tree(npp, "cpu"), backend=backend,
            device="cpu", plain_kernels=plan == "cuda", **kw)
    return _ENGINES[key]


def _lm_costs(name, plan):
    key = ("lm", name, plan)
    if key not in _COSTS:
        jcfg, _, npp = _lm_setup(name)
        backend, kw = PLANS[plan]
        je = jrt.compile_model(jcfg, jax.tree.map(jnp.asarray, npp),
                               backend=backend, **kw)
        jax.clear_caches()          # frames of this pricing's own traces
        _COSTS[key] = (jperf.engine_cost(je, batch=LM_BATCH),
                       tperf.engine_cost(_lm_engine(name, plan),
                                         batch=LM_BATCH))
    return _COSTS[key]


# ---------------------------------------------------------------------------
# hand counts
# ---------------------------------------------------------------------------

def test_linear_flops_bytes_hand_counted():
    m, k, n = 5, 7, 11
    rep = tperf.program_cost(
        lambda a, b: tlayers.linear(a, b, "mk,kn->mn"),
        torch.zeros(m, k), torch.zeros(k, n))
    assert rep.flops == 2 * m * n * k
    assert rep.bytes == 4 * (m * k + k * n + m * n)
    assert rep.matmul_flops == rep.flops
    ref = jperf.program_cost(
        lambda a, b: jlayers.linear(a, b, "mk,kn->mn"),
        jnp.zeros((m, k)), jnp.zeros((k, n)))
    assert (rep.flops, rep.bytes) == (ref.flops, ref.bytes)


@pytest.mark.parametrize("batch", [1, 4])
@pytest.mark.parametrize("plan", ["float", "lut_float", "lut", "cuda",
                                  "cuda_flash"])
def test_kwt_tiny_matmul_flops_hand_counted(plan, batch):
    """Every plan does the same linear algebra: the analytic count, and
    the reference's ``engine_cost`` of the same weights."""
    jcfg, tcfg, npp, _ = _setup("kwt-tiny")
    want = _analytic_matmul_flops(tcfg, batch)
    if plan.startswith("cuda"):
        attention = "flash_lut" if plan == "cuda_flash" else None
        eng = trt.compile_model(
            tcfg, convert.from_numpy_tree(npp, "cpu"), backend="cuda",
            attention=attention, device="cpu", plain_kernels=True)
        rep = tperf.engine_cost(eng, batch=batch)
        ref = _costs("kwt-tiny", "lut", batch)[0]
    else:
        ref, rep = _costs("kwt-tiny", plan, batch)
    assert rep.matmul_flops == want == ref.matmul_flops


# ---------------------------------------------------------------------------
# stages, op classes and the per-line tolerance
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", list(MODELS))
@pytest.mark.parametrize("plan", list(PLANS))
def test_stage_and_op_keys_match_reference(name, plan):
    ref, rep = _costs(name, plan, 1)
    assert set(rep.by_stage()) == set(ref.by_stage())
    assert set(rep.lines) == set(ref.lines)
    # an unpack stage exists only where the plan unpacks per call: an
    # integer-resident plan that does not execute on integers
    assert ("unpack" in rep.by_stage()) == (plan == "lut_resident")
    if plan != "float":
        assert {"softmax", "gelu", "norm", "matmul"} <= \
            {op for _, op in rep.lines}


@pytest.mark.parametrize("batch", [1, 4])
@pytest.mark.parametrize("name", list(MODELS))
@pytest.mark.parametrize("plan", list(PLANS))
def test_lines_within_stated_tolerance(name, plan, batch):
    ref, rep = _costs(name, plan, batch)
    int_exec = _engines(name, plan)[1].int_exec
    for key, want in ref.lines.items():
        got = rep.lines[key]
        assert got.flops == pytest.approx(want.flops, rel=FLOPS_RTOL), key
        if not (int_exec and key[1] == "matmul"):
            assert got.bytes == pytest.approx(want.bytes, rel=BYTES_RTOL), key


@pytest.mark.parametrize("name", LM_MODELS)
@pytest.mark.parametrize("plan", LM_PLANS)
def test_lm_stage_and_op_keys_match_reference(name, plan):
    """An LM plan is one ``encode`` stage (no unpack: the LM plans never
    unpack per call), classed as the reference classes it."""
    ref, rep = _lm_costs(name, plan)
    assert set(rep.by_stage()) == set(ref.by_stage()) == {"encode"}
    assert set(rep.lines) == set(ref.lines)
    assert {"matmul", "norm", "other"} <= {op for _, op in rep.lines}


@pytest.mark.parametrize("name", LM_MODELS)
@pytest.mark.parametrize("plan", LM_PLANS)
def test_lm_lines_within_stated_tolerance(name, plan):
    ref, rep = _lm_costs(name, plan)
    for key, want in ref.lines.items():
        got = rep.lines[key]
        assert got.flops == pytest.approx(want.flops, rel=FLOPS_RTOL), key
        assert got.bytes == pytest.approx(want.bytes, rel=BYTES_RTOL), key


@pytest.mark.parametrize("name", LM_MODELS)
def test_lm_matmul_flops_exact_on_every_plan(name):
    """The same linear algebra on every plan, the ``cuda`` plan's kernel
    charges included, and the reference's count; internlm2's against the
    hand count."""
    want = _lm_costs(name, "float")[0].matmul_flops
    for plan in LM_PLANS:
        ref, rep = _lm_costs(name, plan)
        assert rep.matmul_flops == ref.matmul_flops == want, plan
    cuda = tperf.engine_cost(_lm_engine(name, "cuda"), batch=LM_BATCH)
    assert cuda.matmul_flops == want
    assert {op for _, op in cuda.lines} >= {"matmul", "requant"}
    if name == "internlm2-1.8b":
        assert want == analytic_lm_matmul_flops(_lm_setup(name)[1],
                                                LM_BATCH, 8) == 2949120


def test_lm_pricing_takes_the_callers_tokens():
    """``x`` sets the priced shape: 4 x 63 tokens, as the card's phases
    price the full-width forward, against the hand count."""
    eng = _lm_engine("internlm2-1.8b", "cuda")
    rep = tperf.engine_cost(eng, x=torch.zeros((4, 63), dtype=torch.int32))
    assert rep.matmul_flops == analytic_lm_matmul_flops(eng.cfg, 4, 63)


def test_whisper_pricing_raises_naming_c11():
    from repro_torch.launch import steps
    cfg = tregistry.get("whisper-large-v3").smoke
    params = steps.model_module(cfg).init_params(
        cfg, torch.Generator().manual_seed(0), "cpu")
    eng = trt.compile_model(cfg, params, backend="lut", device="cpu")
    with pytest.raises(TypeError, match="C11") as err:
        tperf.engine_cost(eng)
    with pytest.raises(TypeError) as want:
        eng.forward(torch.zeros((1, 8), dtype=torch.int32))
    assert str(err.value) == str(want.value)


def test_describe_cost_carries_an_lm_plans_totals():
    eng = _lm_engine("internlm2-1.8b", "lut")
    rep = tperf.engine_cost(eng, batch=1)
    out = eng.describe(cost=True)
    assert f"cost/fwd: {rep.flops:.0f} flops, {rep.bytes:.0f} B moved" in out
    assert "| encode | matmul |" in out and "est_cycles" in out


@pytest.mark.parametrize("feature_ingest", [False, True])
def test_stream_hop_stages_and_weights(feature_ingest):
    jcfg, tcfg, _, _ = _setup("kwt-tiny")
    je, te = _engines("kwt-tiny", "lut")
    ref = jperf.stream_hop_cost(je, jfeatures.FrontendConfig(), batch=2,
                                feature_ingest=feature_ingest)
    rep = tperf.stream_hop_cost(te, tfeatures.FrontendConfig(), batch=2,
                                feature_ingest=feature_ingest)
    assert set(rep.by_stage()) == set(ref.by_stage())
    assert ("featurise" in rep.by_stage()) == (not feature_ingest)
    w, wr = rep.stage_weights(tperf.PAPER_MCU), \
        ref.stage_weights(jperf.PAPER_MCU)
    assert sum(w.values()) == pytest.approx(1.0, abs=1e-12)
    for stage in wr:
        assert abs(w[stage] - wr[stage]) <= WEIGHTS_ATOL, (stage, w, wr)
    assert rep.matmul_flops == ref.matmul_flops


def test_unpack_stage_scales_with_params_not_batch():
    te = _engines("kwt-tiny", "lut_resident")[1]
    u1 = tperf.engine_cost(te, batch=1).by_stage()["unpack"]
    u8 = tperf.engine_cost(te, batch=8).by_stage()["unpack"]
    assert u1.flops > 0 and (u1.flops, u1.bytes) == (u8.flops, u8.bytes)


# ---------------------------------------------------------------------------
# kernel charges
# ---------------------------------------------------------------------------

def _only_charges(fn, *args):
    _, recs = op_walk.record(fn, *args)
    assert recs and all(r.name == "charge" for r in recs), \
        [r.name for r in recs]
    return [r.charge for r in recs]


@pytest.mark.parametrize("fixed", [True, False])
def test_softmax_charge_exact(fixed):
    x = torch.randn(6, 27, generator=torch.Generator().manual_seed(0))
    got = _only_charges(lambda t: ops.lut_softmax(t, fixed=fixed), x)
    per = tcost.SOFTMAX_OPS_PER_ELEM[fixed]
    assert got == [("softmax", per * x.numel(),
                    2 * 4 * x.numel() + tcost.SOFTMAX_LUT_BYTES)]


@pytest.mark.parametrize("interp", [False, True])
def test_gelu_charge_exact(interp):
    x = torch.randn(3, 27, 24, generator=torch.Generator().manual_seed(1))
    got = _only_charges(lambda t: ops.lut_gelu(t, interp=interp), x)
    assert got == [("gelu", tcost.GELU_OPS_PER_ELEM[interp] * x.numel(),
                    2 * 4 * x.numel() + tcost.GELU_LUT_BYTES)]


@pytest.mark.parametrize("bits", [8, 4])
def test_matmul_charge_exact(bits):
    """The float activation as the cuda plan hands it, a stored int8 or
    nibble-packed int4 weight: 2*M*K*N, every operand read once (the
    packed payload at its stored size) and the f32 result written once."""
    from repro_torch.core import quant
    gen = torch.Generator().manual_seed(2)
    x = torch.randn(2, 27, 12, generator=gen)
    w = quant.quantize_po2(torch.randn(12, 24, generator=gen), 4, bits=bits)
    got = _only_charges(lambda a: ops.int8_matmul(a, w, x_exp=5), x)
    m, k, n = 54, 12, 24
    assert got == [("matmul", 2 * m * k * n,
                    4 * m * k + w.values.numel() * w.values.element_size()
                    + 4 * m * n)]
    raw = _only_charges(
        lambda a, b: ops.int8_matmul_raw(a, b, shift=2, out_int16=True),
        torch.ones(5, 7, dtype=torch.int8), torch.ones(7, 3, dtype=torch.int8))
    assert raw == [("matmul", 2 * 5 * 7 * 3, 5 * 7 + 7 * 3 + 2 * 5 * 3)]


def test_attention_charge_exact():
    gen = torch.Generator().manual_seed(3)
    q, k, v = (torch.randn(2, 3, 27, 8, generator=gen) for _ in range(3))
    got = _only_charges(lambda a, b, c: ops.lut_attention(a, b, c,
                                                          causal=False),
                        q, k, v)
    assert got == [("matmul", 4 * 2 * 3 * 27 * 27 * 8,
                    4 * 4 * q.numel() + tcost.EXP_LUT_BYTES),
                   ("softmax", tcost.SOFTMAX_OPS_PER_ELEM[False]
                    * 2 * 3 * 27 * 27, 0)]


def test_kernel_plan_priced_by_its_charges():
    """A cuda plan on the CPU: the softmax and GELU lines are their
    charges and nothing else (one charge per layer), whatever the plain
    versions run."""
    jcfg, tcfg, npp, _ = _setup("kwt-tiny")
    eng = trt.compile_model(tcfg, convert.from_numpy_tree(npp, "cpu"),
                            backend="cuda", device="cpu", plain_kernels=True)
    rep = tperf.engine_cost(eng, batch=2)
    t = tcfg.input_dim[1] + 1
    sm, ge = rep.lines[("encode", "softmax")], rep.lines[("encode", "gelu")]
    assert (sm.eqns, ge.eqns) == (tcfg.n_layers, tcfg.n_layers)
    assert sm.flops == tcfg.n_layers * 40 * 2 * tcfg.n_heads * t * t
    assert ge.flops == tcfg.n_layers * 8 * 2 * t * tcfg.d_ff


def test_walk_leaves_launch_counts_unchanged():
    """A walk on the card launches the plan's kernels; the counters read
    after it what they read before (here a launch is simulated)."""
    saved = ops.launch_counts()
    ops.restore_launch_counts({n: 7 for n in saved})
    try:
        def launching(x):
            tgelu_mod.launches += 1
            return x + 1
        tperf.program_cost(launching, torch.zeros(3))
        assert ops.launch_counts() == {n: 7 for n in saved}
    finally:
        ops.restore_launch_counts(saved)


def test_walks_do_not_nest_and_frames_are_the_ports():
    p = {"scale": torch.ones(4), "bias": torch.zeros(4)}
    _, recs = op_walk.record(lambda x: tlayers.apply_norm(
        p, x, tregistry.get("kwt-tiny").config), torch.zeros(2, 4))
    assert recs and all(op_walk.frame_functions(r)[0] == "apply_norm"
                        for r in recs)
    assert op_walk.user_site(recs[0]).startswith("apply_norm (layers.py:")
    assert op_walk.tensor_bytes(torch.zeros(3, dtype=torch.bool)) == 3
    with pytest.raises(RuntimeError, match="nest"):
        op_walk.record(lambda: op_walk.record(lambda: None))


# ---------------------------------------------------------------------------
# rooflines
# ---------------------------------------------------------------------------

def test_machine_model_matches_reference():
    args = dict(name="toy", peak_flops=100.0, mem_bw=10.0, clock_hz=50.0)
    jm, tm = jperf.MachineModel(**args), tperf.MachineModel(**args)
    assert (tm.ridge, tm.id) == (jm.ridge, jm.id)
    for ai in (0.5, 5.0, 10.0, 20.0):
        assert tm.attainable(ai) == jm.attainable(ai)
        assert tm.verdict(ai) == jm.verdict(ai)
    for fl, by in ((200.0, 10.0), (10.0, 200.0), (0.0, 0.0)):
        assert tm.time_s(fl, by) == jm.time_s(fl, by)
        assert tm.cycles(fl, by) == jm.cycles(fl, by)
    assert tperf.PAPER_MCU.to_dict() == jperf.PAPER_MCU.to_dict()


@pytest.mark.parametrize("flops,nbytes,secs", [(50.0, 100.0, 2.0),
                                               (1e9, 1e6, 1e-3),
                                               (0.0, 0.0, 0.0)])
def test_roofline_terms_match_reference(flops, nbytes, secs):
    for m in (jperf.PAPER_MCU, jperf.MachineModel("toy", 100.0, 10.0)):
        tm = tperf.MachineModel(**m.to_dict())
        assert tperf.roofline_terms(flops, nbytes, secs, tm) == \
            jperf.roofline_terms(flops, nbytes, secs, m)


def test_h100_datasheet_envelope():
    from repro_torch.perf import roofline
    h = tperf.H100
    assert (h.name, h.peak_flops, h.mem_bw, h.clock_hz) == \
        ("h100-sxm", 989.4e12, 3.35e12, 1.98e9)
    assert (roofline.H100_PEAK_FLOPS_FP32, roofline.H100_PEAK_FLOPS_TF32,
            roofline.H100_PEAK_OPS_INT8) == (67e12, 494.7e12, 1978.9e12)
    ref_rep, rep = _costs("kwt-tiny", "lut", 1)
    row = tperf.annotate_row({"arch": "kwt-tiny"}, rep, 1e-3, h)
    assert row["bound"] == "memory-bound" and row["arch"] == "kwt-tiny"


def test_calibrate_cpu_measures_positive_envelope():
    m = tperf.calibrate(device="cpu", n=128, stream_mb=4, reps=1)
    assert m.peak_flops > 0 and m.mem_bw > 0 and m.source == "measured"
    assert m.name == "measured-cpu" and m.id.startswith("measured-cpu:")


def test_default_device_is_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default resolves to it")
    cfg = tregistry.get("kwt-tiny").config
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tperf.calibrate(n=16, stream_mb=1, reps=1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tperf.host_machine()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        analysis.example_input(cfg)
    params = convert.from_numpy_tree(_setup("kwt-tiny")[2], "cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tperf.engine_cost(trt.compile_model(cfg, params, backend="float"))


# ---------------------------------------------------------------------------
# core.calibrate: the Table V sweep
# ---------------------------------------------------------------------------

def test_sweep_scale_factors_matches_reference():
    jcfg, tcfg, npp, jp = _setup("kwt-tiny")
    rng = np.random.default_rng(7)
    xs = [rng.normal(0, 0.5, (16, *jcfg.input_dim)).astype(np.float32)
          for _ in range(2)]
    ys = [rng.integers(0, jcfg.n_classes, 16) for _ in range(2)]
    pairs = [(3, 3), (5, 5), (6, 5)]
    ref = jcal.sweep_scale_factors(
        lambda p, x: jkwt.forward(p, x, jcfg), jp,
        [(jnp.asarray(x), jnp.asarray(y)) for x, y in zip(xs, ys)],
        pairs=pairs)
    got = tcal.sweep_scale_factors(
        lambda p, x: tkwt.forward(p, x, tcfg),
        convert.from_numpy_tree(npp, "cpu"),
        [(torch.from_numpy(x), torch.from_numpy(y)) for x, y in zip(xs, ys)],
        pairs=pairs)
    n = sum(len(y) for y in ys)
    for r, g in zip(ref, got):
        assert (g.weight_exponent, g.input_exponent, g.quantized_bytes) == \
            (r.weight_exponent, r.input_exponent, r.quantized_bytes)
        assert abs(g.accuracy - r.accuracy) * n <= 1
    assert tcal.best_pair(got).accuracy == max(g.accuracy for g in got)


def test_quantize_inputs_matches_reference():
    x = np.random.default_rng(8).normal(0, 2, (4, 9)).astype(np.float32)
    want = np.asarray(jcal.quantize_inputs(jnp.asarray(x), 5))
    assert np.array_equal(tcal.quantize_inputs(torch.from_numpy(x), 5)
                          .numpy(), want)


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------

def test_cli_cost_and_calibrate_on_the_cpu(capsys):
    assert perf_cli.main(["cost", "--arch", "kwt-tiny", "--backends", "cuda",
                          "lut", "--device", "cpu", "--mcu"]) == 0
    out = capsys.readouterr().out
    assert "backend=cuda" in out and "est_cycles" in out
    assert perf_cli.main(["calibrate", "--device", "cpu", "--reps", "1"]) == 0
    assert json.loads(capsys.readouterr().out)["name"] == "measured-cpu"


def test_cli_prices_an_lm_smoke_config_on_the_cpu(capsys):
    assert perf_cli.main(["cost", "--arch", "internlm2-1.8b", "--smoke",
                          "--backends", "lut", "cuda", "--device",
                          "cpu"]) == 0
    out = capsys.readouterr().out
    assert "internlm2-1.8b · backend=lut" in out
    assert "internlm2-1.8b · backend=cuda" in out
    assert out.count("| encode | matmul |") == 2


def test_cli_regress_exit_codes(tmp_path):
    prov = {"git_commit": "t", "torch_version": "-", "device": "-",
            "timestamp": "-", "calibration": None}
    bad = str(tmp_path / "bad.jsonl")
    tperf.append(bad, [tperf.entry("kwt-tiny", "cuda", 64, la, "mean_us",
                                   prov=prov) for la in (600.0, 610.0, 1300.0)])
    assert perf_cli.main(["regress", "--history", bad]) == 1
    assert perf_cli.main(["regress", "--selftest"]) == 0


# ---------------------------------------------------------------------------
# the cell and the engine
# ---------------------------------------------------------------------------

def test_stream_lanes_install_cost_model_weights(tmp_path):
    """A span-less slow hop dumps with the cost model's stage split of the
    lanes' own hop: resolved once, at the first dump, and the slowest
    stage is the argmax of the weights."""
    te = _engines("kwt-tiny", "lut")[1]
    fcfg = tfeatures.FrontendConfig()
    cell = cellmod.ServeCell(te, slots=2, registry=telemetry.Registry(),
                             flight=telemetry.FlightConfig(
                                 dump_dir=str(tmp_path), min_hops=2))
    lanes = cell.stream_lanes(fcfg, detector.DetectorConfig())
    installed = cell.flight.stage_weights
    assert callable(installed)
    calls = []
    cell.flight.stage_weights = lambda: calls.append(1) or installed()
    cell.metrics.latency_budget.set(1e-9)          # every hop is slow
    rng = np.random.default_rng(4)
    for lane in (0, 1):
        lanes.join(lane)
    for _ in range(3):
        lanes.hop(rng.normal(0, 0.1, (2, fcfg.hop_len)).astype(np.float32))
    assert len(cell.flight.dumps) == 1 and calls == [1]
    att = json.load(open(cell.flight.dumps[0]))["attribution"]
    cell.flight.dump("manual")
    assert calls == [1]
    want = tperf.stream_hop_cost(te, fcfg, batch=1).stage_weights(
        tperf.host_machine(device="cpu"))
    assert att["method"] == "cost-model-weights"
    assert set(att["stage_ms"]) == set(want) == {"featurise", "embed",
                                                 "encode"}
    assert att["slowest_stage"] == max(want, key=want.get)
    assert math.isclose(sum(cell.flight.stage_weights.values()), 1.0)


def test_describe_cost_carries_engine_cost_totals():
    te = _engines("kwt-tiny", "lut_resident")[1]
    rep = tperf.engine_cost(te, batch=1)
    out = te.describe(cost=True)
    assert f"cost/fwd: {rep.flops:.0f} flops, {rep.bytes:.0f} B moved" in out
    assert "est_cycles" in out and "| unpack |" in out
    assert te.describe() == out.split(" | cost/fwd")[0]
    # the analysis passes are ported (tests/test_torch_analysis.py):
    # describe(analyze=True) appends their verdict
    assert te.describe(analyze=True).startswith(te.describe().split(" | ")[0])
    assert "| analysis: ok" in te.describe()
