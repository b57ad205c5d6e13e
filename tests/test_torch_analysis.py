"""The port's static verifier (``repro_torch.analysis``), verified, on
``device="cpu"`` (the ``cuda`` plans through their kernels' plain
versions, which record the same as the card).

Three layers, as the reference's ``tests/test_analysis.py``: (1) the
KWT-Tiny ``float`` / ``lut`` / ``cuda`` plans come back clean; (2) each
pass catches its seeded mutation, on the plan where it gates; (3) the
interval interpreter's unit-level behaviour on known pipelines.

Oracles.  Under jax 0.9 the reference's own analysis fails for residency
(``jax.core.Literal`` is gone) and for two interval contracts,
so residency, geometry and the intervals are held to the documented
contract (the module docstrings), not to the reference's outputs.  The
budget pass is held to the reference's: the weights cross by numpy and
both packages plan them, and ``rom`` / ``lut`` / ``residual`` bytes are
equal.  The activation live-set is not: the port's records are ATen ops,
not jaxpr equations (``PORT_ACT_BYTES`` below pins the port's).
"""

import jax
import numpy as np
import pytest
import torch

from repro import runtime as jruntime
from repro.analysis import budget as jbudget
from repro.configs import registry as jregistry
from repro.models import kwt as jkwt
from repro_torch import analysis, convert
from repro_torch import runtime as trt
from repro_torch.analysis import geometry, mutations, op_walk, ranges
from repro_torch.analysis.__main__ import main as cli_main
from repro_torch.configs import registry
from repro_torch.core import fixedpoint as fxp
from repro_torch.kernels import int8_matmul, lut_attention, lut_gelu, \
    lut_softmax

CFG = registry.get("kwt-tiny").config
# the port's peak activation bytes of KWT-Tiny at [1, 16, 26] (the
# reference's jaxpr live-set at jax 0.9: float 9072, lut 25989 — ratios
# 0.881 and 0.653)
PORT_ACT_BYTES = {"float": 7992, "lut": 16976}
# the geometry of every launch of a KWT-Tiny cuda forward at B = 1, as
# the C queries answered on the H100 (``chip_smoke.py`` phase analysis):
# (kernel, grid, threads, shared memory, variant) -> launches
TINY_GEOMETRY = {
    ("int8_matmul", 1, 256, 11392, 1): 1, ("int8_matmul", 1, 256, 10368, 1): 5,
    ("lut_softmax", 1, 128, 20736, 513): 1, ("int8_matmul", 1, 256, 9344, 1): 1,
    ("lut_gelu", 1, 256, 0, 0): 1, ("int8_matmul", 1, 256, 13440, 1): 1}


@pytest.fixture(scope="module")
def trees():
    jp = jkwt.init_params(jregistry.get("kwt-tiny").config,
                          jax.random.PRNGKey(0))
    npp = jax.tree.map(np.asarray, jp)
    return jp, convert.from_numpy_tree(npp, "cpu")


@pytest.fixture(scope="module")
def params(trees):
    return trees[1]


def _engine(params, backend, **kw):
    if backend == "cuda":
        kw["plain_kernels"] = True
    return trt.compile_model(CFG, params, backend=backend, device="cpu", **kw)


@pytest.fixture(scope="module")
def lut_engine(params):
    return _engine(params, "lut")


@pytest.fixture(scope="module")
def cuda_engine(params):
    return _engine(params, "cuda")


# ---------------------------------------------------------------------------
# clean plans pass
# ---------------------------------------------------------------------------

def test_float_plan_clean(params):
    eng = _engine(params, "float")
    rep = analysis.check_engine(eng)
    assert rep.ok, rep.render()
    assert rep.result("residency").metrics["float_leak_count"] == 0
    assert rep.result("geometry").metrics["kernels"] == 0


def test_lut_plan_clean_with_no_unpack_stage(lut_engine):
    """The lut plan integer-executes: no per-call unpack stage,
    float_leak_count == 0, and the plan survives the strict gate."""
    rep = analysis.check_engine(lut_engine, strict=True)
    assert rep.ok, rep.render()
    res = rep.result("residency")
    assert lut_engine.int_exec
    assert res.metrics["float_leak_count"] == 0
    assert any(f.kind == "unpack-stage" and f.severity == "info"
               for f in res.findings)
    assert res.count("violation") == 0
    # every linear's container move and the Q8.24 exit are sanctioned
    kinds = {f.kind for f in res.findings if f.severity == "whitelisted"}
    assert {"int-container", "q824-boundary", "weight-descale"} <= kinds
    bud = rep.result("budget").metrics
    assert bud["budget_bytes"] == 64 * 1024
    assert bud["total_bytes"] <= bud["budget_bytes"]
    assert bud["rom_bytes"] == lut_engine.rom_bytes
    assert "analysis: ok" in lut_engine.describe()


def test_non_exec_resident_plan_counts_unpack_leaks(params):
    """integer_exec=False: the separate unpack stage is back (one float
    cast per QTensor leaf of KWT-Tiny: 9, the reference's count) and the
    strict gate refuses it."""
    eng = _engine(params, "lut", integer_exec=False)
    rep = analysis.check_engine(eng, passes=("residency",))
    assert rep.ok, rep.render()
    res = rep.result("residency")
    from repro_torch.core import quant
    from repro_torch.core.tree import tree_leaves
    n_q = sum(isinstance(leaf, quant.QTensor)
              for leaf in tree_leaves(eng.params))
    assert res.metrics["float_leak_count"] == n_q == 9
    assert any(f.kind == "unpack-stage" and f.severity == "whitelisted"
               for f in res.findings)
    assert res.metrics["descale_sites"] > 0
    strict = analysis.check_engine(eng, passes=("residency",), strict=True)
    assert not strict.ok
    assert any(f.kind == "strict-mode"
               for f in strict.result("residency").findings)


@pytest.mark.parametrize("attention", ["xla", "flash_lut"])
def test_cuda_plan_clean_and_geometry(params, attention):
    """The cuda plan passes; the geometry pass lists every kernel launch
    of its forward (one per linear, a softmax or an attention and a GELU
    per layer), each inside the H100's limits."""
    eng = _engine(params, "cuda", attention=attention)
    rep = analysis.check_engine(eng)
    assert rep.ok, rep.render()
    geo = rep.result("geometry")
    want = (2 + 6 * CFG.n_layers) + 2 * CFG.n_layers
    assert geo.metrics["kernels"] == want
    assert 0 < geo.metrics["max_smem_bytes"] <= geometry.MAX_SMEM
    assert geo.metrics["max_threads"] <= geometry.MAX_THREADS
    rows = [f for f in geo.findings if f.kind == "kernel-geometry"]
    assert sum(int(f.message.split(" x")[1].split(":")[0]) for f in rows) \
        == want
    assert rep.result("residency").metrics["float_leak_count"] == 0
    # the budget is information only on a kernel plan
    assert rep.result("budget").metrics["budget_bytes"] == 0


def test_cuda_geometry_is_the_cards(cuda_engine):
    """Every launch of the KWT-Tiny cuda forward, as the CPU mirror works
    it out, is what the C launchers chose on the H100."""
    w = op_walk.walk(lambda p, x: cuda_engine._mod.forward(
        p, x, cuda_engine.exec_cfg), cuda_engine.params,
        analysis.example_input(CFG, device="cpu"))
    got = {}
    for rec in w.records:
        if rec.launch is not None:
            kernel, code, geo = geometry.launch_geometry(rec, "cpu")
            assert code == 0
            got[(kernel,) + geo] = got.get((kernel,) + geo, 0) + 1
    assert got == TINY_GEOMETRY


# ---------------------------------------------------------------------------
# mutation testing: each pass catches its seeded violation
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("backend", ["lut", "cuda"])
def test_mutation_float_leak_caught(params, backend):
    eng = _engine(params, backend)
    with mutations.apply("float_leak"):
        rep = analysis.check_engine(eng, passes=("residency",))
    assert not rep.ok
    assert any(f.kind == "float-leak" for f in rep.result("residency").findings)


@pytest.mark.parametrize("backend", ["lut", "cuda"])
def test_mutation_unsat_shift_caught(params, backend):
    eng = _engine(params, backend)
    with mutations.apply("unsat_shift"):
        rep = analysis.check_engine(eng, passes=("ranges",))
    assert not rep.ok
    assert any("overflow" in f.kind and f.severity == "violation"
               for f in rep.result("ranges").findings)


def test_mutation_big_lut_caught(lut_engine, cuda_engine):
    with mutations.apply("big_lut"):
        rep = analysis.check_engine(lut_engine, passes=("budget",))
        info = analysis.check_engine(cuda_engine, passes=("budget",))
    assert not rep.ok
    assert any(f.kind == "ram-budget" and f.severity == "violation"
               for f in rep.result("budget").findings)
    # a cuda plan's table is information only
    assert info.ok
    assert any(f.kind == "ram-budget-scope"
               for f in info.result("budget").findings)


def test_mutations_restore_cleanliness(lut_engine, cuda_engine):
    for eng in (lut_engine, cuda_engine):
        for name in mutations.MUTATIONS:
            with mutations.apply(name):
                pass
        rep = analysis.check_engine(eng)
        assert rep.ok, "mutation context managers must restore the originals"
    with pytest.raises(ValueError, match="unknown mutation"):
        with mutations.apply("nope"):
            pass


# ---------------------------------------------------------------------------
# CLI exit codes and describe
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("backend", ["lut", "cuda"])
def test_cli_clean_exits_zero(capsys, backend):
    assert cli_main(["check", "--config", "kwt_tiny", "--backend", backend,
                     "--device", "cpu", "--passes", "residency,budget"]) == 0
    out = capsys.readouterr().out
    assert "analysis: ok" in out


@pytest.mark.parametrize("mut", mutations.MUTATIONS)
def test_cli_mutations_exit_nonzero(mut, capsys):
    assert cli_main(["check", "--config", "kwt_tiny", "--backend", "lut",
                     "--device", "cpu", "--mutate", mut]) == 1
    assert "CAUGHT" in capsys.readouterr().out


def test_cli_budget_override():
    assert cli_main(["check", "--config", "kwt_tiny", "--backend", "lut",
                     "--device", "cpu", "--passes", "budget",
                     "--budget", "1024"]) == 1


def test_describe_analyze_runs_the_pipeline_once(params):
    eng = _engine(params, "cuda")
    assert not hasattr(eng, "_analysis_verdict")
    line = eng.describe(analyze=True)
    assert line.endswith("| analysis: ok (leaks 0 whitelisted, ram 12764 B)")
    assert eng.describe() == line
    calls = []
    real = analysis.check_engine
    analysis.check_engine = lambda *a, **k: calls.append(1) or real(*a, **k)
    try:
        assert eng.describe(analyze=True) == line      # the cached verdict
    finally:
        analysis.check_engine = real
    assert calls == []


# ---------------------------------------------------------------------------
# budget: the reference's table
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("backend", ["float", "lut"])
def test_budget_matches_the_reference(trees, backend):
    jp, tp = trees
    jeng = jruntime.compile_model(jregistry.get("kwt-tiny").config, jp,
                                  backend=backend)
    jx = jax.numpy.zeros((1, *CFG.input_dim), jax.numpy.float32)
    want = jbudget.check_budget(jeng, jx).metrics
    got = analysis.check_engine(_engine(tp, backend),
                                passes=("budget",)).result("budget").metrics
    for key in ("rom_bytes", "lut_bytes", "residual_float_bytes",
                "budget_bytes"):
        assert got[key] == want[key], key
    assert got["peak_activation_bytes"] == PORT_ACT_BYTES[backend]
    ratio = got["peak_activation_bytes"] / want["peak_activation_bytes"]
    assert 0.5 < ratio <= 1.0, ratio


def test_budget_liveness_charges_views_nothing():
    """A view allocates nothing and keeps its base alive; a buffer dies at
    its last use."""
    x = torch.zeros(4, 8)

    def prog(x):
        y = x + 1                    # 128 B
        v = y.view(32)               # a view: 0 B, keeps y alive
        z = x * 2                    # 128 B, the last use of x
        return v.sum() + z.sum()
    from repro_torch.analysis import budget
    w = op_walk.walk(prog, x)
    # x + y + z at the multiply; y dead there, or v charged, would read
    # 256 or 512
    assert budget.peak_live(w) == 384


# ---------------------------------------------------------------------------
# interval interpreter units
# ---------------------------------------------------------------------------

def test_interval_flags_wrapping_shift():
    def wrapping(v):
        return fxp.to_fixed(v) << 5
    f, _ = ranges.analyze_fn(wrapping, (torch.zeros(4),),
                             [ranges.Interval(-8.0, 8.0)], label="t")
    assert any(f_.severity == "violation" and "overflow" in f_.kind
               for f_ in f)


def test_interval_accepts_saturating_shift():
    f, outs = ranges.analyze_fn(
        lambda v: fxp.fixed_shift_mul(fxp.to_fixed(v), 5),
        (torch.zeros(4),), [ranges.Interval(-8.0, 8.0)], label="t")
    assert not any(f_.severity == "violation" for f_ in f)
    assert any(f_.kind == "guarded-overflow" for f_ in f)
    lo, hi = outs[0].lo, outs[0].hi
    assert lo >= -(2**31) and hi <= 2**31 - 1


def test_interval_fixed_mul_precondition():
    one = fxp.ONE
    # two tensors, so that each input has its own interval
    ints = (torch.zeros(4, dtype=torch.int32),
            torch.zeros(4, dtype=torch.int32))
    clean, _ = ranges.analyze_fn(
        fxp.fixed_mul, ints,
        [ranges.Interval(0, one), ranges.Interval(0, one)], label="t")
    assert not any(f.severity == "violation" for f in clean)
    dirty, _ = ranges.analyze_fn(
        fxp.fixed_mul, ints,
        [ranges.Interval(0, one), ranges.Interval(0, 4 * one)], label="t")
    assert any(f.kind == "fixed-mul-precondition" for f in dirty)


def test_interval_softmax_pipeline_bounded():
    from repro_torch.core import approx
    f, outs = ranges.analyze_fn(
        lambda v: approx.softmax(v, mode="lut_fixed"),
        (torch.zeros((1, 27)),), [None], label="t",
        suppress_frames=("reciprocal_q24", "fixed_mul"))
    assert not any(f_.severity == "violation" for f_ in f)
    # the Q8.24 -> float exit bounds the output to the representable range
    assert outs[0].lo >= -128.0 and outs[0].hi <= 128.0


def test_interval_lut_gather_takes_the_table_range():
    """A gather from LUT_EXP is in the table's own range whatever the
    index interval (the constants enter with their concrete min/max)."""
    from repro_torch.core import lut
    tab = lut.bank_tensors("cpu")["exp_q24"]
    _, outs = ranges.analyze_fn(
        lambda i: tab[i.clamp(0, 319).long()],
        (torch.zeros(3, dtype=torch.int32),), [None], label="t")
    assert (outs[0].lo, outs[0].hi) == (int(tab.min()), int(tab.max()))


@pytest.mark.parametrize("fn, want", [
    (lambda x, b: x.clamp(min=b), (5, 20)),
    (lambda x, b: x.clamp(max=b), (0, 10)),
    (lambda x, b: x.clamp(min=b - 15), (0, 10)),
    (lambda x, b: x.clamp(max=b - 15), (-10, 5)),
    (lambda x, b: x.clamp(b - 15, b - 8), (-3, 10)),
], ids=["min", "max", "min_below", "max_below", "both"])
def test_interval_clamp_by_tensor_bounds(fn, want):
    """A bound that is a tensor with a range of its own: each end of the
    result comes from the same end of the bounds (x in [0, 10], b in
    [5, 20])."""
    ints = (torch.zeros(4, dtype=torch.int32),
            torch.zeros(4, dtype=torch.int32))
    _, outs = ranges.analyze_fn(
        fn, ints, [ranges.Interval(0, 10), ranges.Interval(5, 20)],
        label="t")
    assert (outs[0].lo, outs[0].hi) == want


# ---------------------------------------------------------------------------
# the geometry mirrors
# ---------------------------------------------------------------------------

def _model(key, threads, smem):
    return geometry.h100_occupancy(key, threads, smem)


def test_geometry_mirrors_pick_the_launchers_paths():
    sm = lut_softmax.geometry
    # rows of up to 128 floats on aligned addresses: the slab path
    assert sm(0, 0, 64, 27, 1, sms=132, occupancy=_model) == \
        (0, (1, 128, 4 * 3 * 4 * 16 * 27, 513))
    # a misaligned base or a longer row: the global path, 8 rows a block
    assert sm(4, 0, 64, 27, 1, sms=132, occupancy=_model) == \
        (0, (8, 256, 0, 0))
    assert sm(0, 0, 10 ** 6, 1000, 1, sms=132, occupancy=_model) == \
        (0, (4096, 256, 0, 0))
    # the GELU: a scalar head up to the first 16-byte boundary
    assert lut_gelu.geometry(4, 4, 1000, 0) == (0, (1, 256, 0, 3))
    assert lut_gelu.geometry(2, 6, 1000, 2) == (1, (0, 0, 0, 0))
    # the matmul: one slab up to K = 256, the K loop beyond
    code, (grid, threads, smem, variant) = int8_matmul.geometry(
        0, 0, 0, 4, 2048, 92544, 8 | 8 << 8 | 1 << 4, sms=132,
        occupancy=_model)
    assert code == 0 and variant > 100 and threads == 256
    assert int8_matmul.geometry(0, 0, 0, 0, 12, 8, 0, sms=132,
                                occupancy=_model) == (0, (0, 0, 0, 0))
    # the attention refuses D > 256
    assert lut_attention.geometry(1, 1, 1, 8, 8, 257, 8, sms=132,
                                  occupancy=_model)[0] == 1
    code, (grid, threads, smem, variant) = lut_attention.geometry(
        2, 16, 8, 1024, 1024, 128, 128, sms=132, occupancy=_model)
    assert code == 0 and smem <= geometry.MAX_SMEM and variant % 10 == 1


# the wide kernel's shared memory: the table and the row maxima, then Q
# (16 rows a group, rows of DT * 8 + 4 floats) and a ring of slots, each
# the larger of a float32 and a bf16 chunk: tiles of <= 128 keys in 3
# slots at D <= 192 and 2 at D <= 256 of 64 float32 or 128 bf16 keys
# (bf16 rows of DT * 8 + 8 values), tiles of <= 32 keys in 4 slots of 32
def _wide_smem(groups, dt, slots, keys_f32, keys_bf16):
    slot = max(keys_f32 * (dt * 8 + 4) * 4, keys_bf16 * (dt * 8 + 8) * 2)
    return (320 + 8 * 16) * 4 + groups * 16 * (dt * 8 + 4) * 4 + slots * slot


@pytest.mark.parametrize("d, bk, want", [
    # nemotron-4-340b's causal GQA at key tiles of 128: 4 row groups of two
    # warps a block, 16 query-row splits a head, one block an SM walking
    # the 3072 items (NT 16, 3 slots)
    # (the ids of the cases the test had before D = 256 was added)
    pytest.param(192, 128, (132, 256, _wide_smem(4, 24, 3, 64, 128), 24163),
                 id="128-want0"),
    # key tiles of 4 keys (NT 4, 4 slots of 32)
    pytest.param(192, 4, (132, 256, _wide_smem(4, 24, 4, 32, 32), 24044),
                 id="4-want1"),
    # the instances of D <= 256 (DT 32)
    pytest.param(256, 128, (132, 256, _wide_smem(4, 32, 2, 64, 128), 32162),
                 id="d256-128"),
    pytest.param(256, 4, (132, 256, _wide_smem(4, 32, 4, 32, 32), 32044),
                 id="d256-4")])
def test_attention_geometry_at_head_dim_192(d, bk, want):
    """D = 192 takes the wide kernel (DT 24), D = 256 its DT 32 build: K
    and V stream through a ring of chunks, within the 227 KB a block may
    use."""
    code, geo = lut_attention.geometry(2, 96, 8, 1024, 1024, d, bk,
                                       sms=132, occupancy=_model)
    assert code == 0 and geo == want and geo[2] <= geometry.MAX_SMEM


def test_h100_occupancy_model():
    assert geometry.h100_occupancy(("int8_matmul", 0, 1), 256, 0) == 8
    assert geometry.h100_occupancy(("int8_matmul", 0, 1), 256, 104192) == 2
    # the attention's 255 registers a thread: one block of 8 warps an SM
    assert geometry.h100_occupancy(("lut_attention", 8, 16), 256, 1024) == 1
    assert geometry.h100_occupancy(("lut_attention", 8, 16), 128, 1024) == 2


def test_geometry_flags_a_launch_past_the_limits():
    bad = geometry._violations("lut_softmax", 0, (0, 2048, 60000, 0))
    kinds = {k for k, _ in bad}
    assert kinds == {"empty-grid", "threads", "smem-overflow"}
    assert geometry._violations("int8_matmul", 0, (4, 256, 200000, 1)) == []
    assert geometry._violations("int8_matmul", 1, (0, 0, 0, 0))[0][0] == \
        "refused-launch"


def test_lm_smoke_cuda_plan_clean():
    """A dense LM plan (internlm2's smoke config): the residency walk
    crosses the packed embed and head, the geometry lists one softmax a
    layer and the head's matmul."""
    from repro_torch.launch import steps
    cfg = registry.get("internlm2-1.8b").smoke
    p = steps.model_module(cfg).init_params(
        cfg, torch.Generator().manual_seed(0), "cpu")
    eng = trt.compile_model(cfg, p, backend="cuda", device="cpu",
                            plain_kernels=True)
    rep = analysis.check_engine(eng)
    assert rep.ok, rep.render()
    assert rep.result("geometry").metrics["kernels"] == cfg.n_layers + 1
    assert rep.result("residency").metrics["float_leak_count"] == 0
