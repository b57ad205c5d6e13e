"""The moe family in the port against the reference: the router's top-k
(lower index first on ties, as ``jax.lax.top_k``), the capacity and its
drops, ``apply_moe`` under every softmax mode, the load-balance loss, and
the granite-moe / deepseek-moe smoke configs whole — ``forward``,
``prefill`` and ``decode_step`` under the port's ``float``, ``lut`` and
``cuda`` plans against the reference's ``float``, ``lut`` and ``pallas``
(the ``cuda`` plan through its kernels' plain versions on the CPU, the
reference's in interpret mode), on the same numpy weights and tokens —
and moe serving through ``LMScheduler`` and ``launch.serve``.

Tolerances, beside what was measured on this host (PERF.md §6, PR 19):

* routing (expert ids, capacity positions, the keep mask) and every
  integer or fixed-point stage: equal;
* float stages (the router's product, the expert products, the combine)
  reduce in another order under PyTorch than under XLA:CPU:
  ``FLOAT_RTOL`` relative to the largest output on the ``exact`` mode
  (measured at most 4.3e-7 for the block, 3.6e-7 for the gates; 0.0 on
  the LUT modes), and ``FLOAT_ATOL`` on the ``float`` plan's logits of
  scale ~4 (measured at most 3.9e-6);
* ``lut`` and ``cuda`` logits: bit-equal, as the dense configs' are
  (measured 0.0: no router probability moves across a LUT bin on these
  weights, and the head's eq-9 quantiser absorbs the float stages' ulps);
* decode == forward at ``capacity_factor = 8.0`` (drop-free, as the
  reference's own test) within the reference's rel 1e-4 (measured at most
  4.6e-7 on ``float``, 0.0 on ``lut`` and ``cuda``).

On 2048 LUT rows of 40 N(0, 1) logits, 15.8 % tie between the 8th and 9th
probability and ``torch.topk`` picks other experts or another slot order
than ``lax.top_k`` on 36.9 % of the rows.
"""

import dataclasses
import importlib.util
import json
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import runtime as jrt
from repro.configs import registry as jregistry
from repro.models import moe as JM
from repro.models import transformer as JT
from repro_torch import cell as cellmod
from repro_torch import convert
from repro_torch import runtime as trt
from repro_torch.configs import registry as tregistry
from repro_torch.core import approx as tapprox
from repro_torch.kernels import ops as tops
from repro_torch.launch import serve
from repro_torch.models import moe as TM

torch.set_num_threads(1)

MOE = ["granite-moe-3b-a800m", "deepseek-moe-16b"]
PLANS = {"float": "float", "lut": "lut", "cuda": "pallas"}
# (port softmax mode, port act_approx, reference softmax mode, act_approx)
MODES = {"exact": ("exact", "exact", "exact", "exact"),
         "lut": ("lut", "lut", "lut", "lut"),
         "lut_fixed": ("lut_fixed", "lut", "lut_fixed", "lut"),
         "cuda": ("cuda", "cuda", "pallas", "pallas")}
FLOAT_RTOL = 1e-6       # float stages, relative to the largest output
FLOAT_ATOL = 1e-4       # float logits of scale ~4
DECODE_REL = 1e-4
DROP_FREE = 8.0         # capacity_factor under which no slot drops


def _cfgs(name, **kw):
    return (jregistry.get(name).smoke.with_(**kw),
            tregistry.get(name).smoke.with_(**kw))


def np_params(jcfg, seed=0):
    """Reference-layout parameters with every leaf random (matrices
    fan-in scaled, stacked block leaves by their per-layer fan-in, norm
    scales around 1)."""
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


def _setup(name, seed=0, **kw):
    jcfg, tcfg = _cfgs(name, **kw)
    npp = np_params(jcfg, seed)
    return jcfg, tcfg, jax.tree.map(jnp.asarray, npp), \
        convert.from_numpy_tree(npp, "cpu")


def _tokens(cfg, b=2, s=16, seed=1):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (b, s)).astype(np.int32)


def _compile(tcfg, tp, plan, **kw):
    return trt.compile_model(tcfg, tp, backend=plan, device="cpu",
                             plain_kernels=plan == "cuda", **kw)


def _layer0(npp):
    """Layer 0's moe leaves of a numpy tree."""
    return jax.tree.map(lambda a: a[0], npp["blocks"]["moe"])


def _block_inputs(name, seed, t, **kw):
    """A moe block's weights and a [t, D] float32 input, in both
    packages."""
    jcfg, tcfg = _cfgs(name, **kw)
    p = _layer0(np_params(jcfg, seed))
    xt = np.random.default_rng(seed + 1).normal(
        0, 1, (t, jcfg.d_model)).astype(np.float32)
    return jcfg, tcfg, p, xt


def _tp(p):
    return convert.from_numpy_tree(p, "cpu")


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / np.abs(want).max())


# ---------------------------------------------------------------------------
# top-k: lower index first on ties
# ---------------------------------------------------------------------------

def _lut_rows(m=2048, n=40, seed=0):
    """Router-like probabilities through the Q8.24 LUT softmax: many lanes
    land on one ROM value, so ties are common."""
    z = np.random.default_rng(seed).normal(0, 1, (m, n)).astype(np.float32)
    return tapprox.softmax(torch.from_numpy(z), mode="lut_fixed").numpy()


def _tie_rows(kind, k=8, n=40):
    rng = np.random.default_rng(3)
    if kind == "all_equal":
        return np.full((4, n), 1.0 / n, np.float32)
    if kind == "tie_at_k":
        x = rng.permutation(np.linspace(0.01, 0.9, n)).astype(np.float32)
        x = np.tile(x, (6, 1))
        for r in range(6):          # the k-th and (k+1)-th largest tie
            order = np.argsort(-x[r], kind="stable")
            x[r, order[k]] = x[r, order[k - 1]]
            x[r, order[k + r % 3]] = x[r, order[k - 1]]
        return x
    if kind == "lut":
        return _lut_rows()
    raise ValueError(kind)


@pytest.mark.parametrize("kind", ["all_equal", "tie_at_k", "lut"])
@pytest.mark.parametrize("k", [2, 6, 8])
def test_top_k_is_lax_top_k_on_ties(kind, k):
    x = _tie_rows(kind, k)
    jv, ji = jax.lax.top_k(jnp.asarray(x), k)
    tv, ti = TM.top_k(torch.from_numpy(x), k)
    assert np.array_equal(ti.numpy(), np.asarray(ji))
    assert np.array_equal(tv.numpy(), np.asarray(jv))


def test_torch_topk_breaks_lut_ties_otherwise():
    """On LUT rows ``torch.topk`` disagrees with ``lax.top_k`` (the set or
    the slot order of the experts), where the port's top-k agrees: a
    regression to ``torch.topk`` fails here."""
    x = _lut_rows()
    _, ji = jax.lax.top_k(jnp.asarray(x), 8)
    ji = np.asarray(ji)
    _, naive = torch.topk(torch.from_numpy(x), 8)
    differ = (naive.numpy() != ji).any(axis=1)
    assert differ.sum() > 0
    rows = np.flatnonzero(differ)
    _, ti = TM.top_k(torch.from_numpy(x[rows]), 8)
    assert np.array_equal(ti.numpy(), ji[rows])
    # ties between the 8th and 9th expert: the set itself depends on them
    srt = -np.sort(-x, axis=1)
    assert (srt[:, 7] == srt[:, 8]).mean() > 0.05


@pytest.mark.parametrize("mode", list(MODES))
def test_route_matches_reference(mode):
    """Expert ids equal; gates to the float stages' tolerance (the LUT
    modes' probabilities are equal, so their gates are too)."""
    ts, ta, js, ja = MODES[mode]
    jcfg, tcfg, p, xt = _block_inputs("granite-moe-3b-a800m", 0, 256)
    jcfg = jcfg.with_(softmax_mode=js, act_approx=ja)
    tcfg = tcfg.with_(softmax_mode=ts, act_approx=ta)
    jg, ji = JM._route(jnp.asarray(xt), jnp.asarray(p["router"]), jcfg)
    tg, ti = TM._route(torch.from_numpy(xt), torch.from_numpy(p["router"]),
                       tcfg)
    assert np.array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), rtol=0,
                               atol=FLOAT_RTOL)


# ---------------------------------------------------------------------------
# capacity and drops
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("cf", [0.25, 1.0, 1.25, 8.0])
def test_capacity_matches_reference(cf):
    for t in (1, 2, 4, 63, 64, 252, 256, 1000):
        for k in (1, 2, 6, 8):
            for e in (8, 40, 64):
                jcfg, tcfg = _cfgs("granite-moe-3b-a800m", top_k=k,
                                   n_experts=e, capacity_factor=cf)
                assert TM._capacity(t, tcfg) == JM._capacity(t, jcfg)
    assert TM.padded_experts(tregistry.get("granite-moe-3b-a800m").config) \
        == 48


def _reference_slots(idx, e_n, C):
    """The reference's position and keep lines
    (``src/repro/models/moe.py::_dispatch_ffn_combine``, e_lo = 0)."""
    fid = idx.reshape(-1)
    mine = jnp.logical_and(fid >= 0, fid < e_n)
    lid = jnp.clip(fid, 0, e_n - 1)
    onehot = jnp.where(mine[:, None],
                       jax.nn.one_hot(lid, e_n, dtype=jnp.int32), 0)
    pos = jnp.take_along_axis(jnp.cumsum(onehot, axis=0) - 1,
                              lid[:, None], axis=1)[:, 0]
    return lid, pos, jnp.logical_and(mine, pos < C)


@pytest.mark.parametrize("name", MOE)
@pytest.mark.parametrize("mode", ["exact", "cuda"])
def test_forced_overflow_drops_as_the_reference(name, mode):
    """capacity_factor 0.25 at T = 96: hot experts overflow.  The keep
    mask and the positions equal the reference's, and so does the
    dispatched, FFN'd and combined output (float32; ``FLOAT_RTOL`` of its
    largest element)."""
    ts, ta, js, ja = MODES[mode]
    jcfg, tcfg, p, xt = _block_inputs(name, 2, 96, capacity_factor=0.25)
    jcfg = jcfg.with_(softmax_mode=js, act_approx=ja)
    tcfg = tcfg.with_(softmax_mode=ts, act_approx=ta)
    ep, C = TM.padded_experts(tcfg), TM._capacity(96, tcfg)
    jg, ji = JM._route(jnp.asarray(xt), jnp.asarray(p["router"]), jcfg)
    jl, jpos, jkeep = _reference_slots(ji, ep, C)
    ti = torch.from_numpy(np.array(ji)).long()
    tl, tpos, tkeep = TM._slots(ti, e_lo=0, e_n=ep, C=C)
    assert np.array_equal(tl.numpy(), np.asarray(jl))
    assert np.array_equal(tpos.numpy(), np.asarray(jpos))
    assert np.array_equal(tkeep.numpy(), np.asarray(jkeep))
    assert 0 < int((~tkeep).sum()) < tkeep.numel()   # some slots dropped
    w = {k: p[k] for k in ("w_gate", "w_up", "w_down")}
    want = JM._dispatch_ffn_combine(
        jnp.asarray(xt), jg, ji, *(jnp.asarray(w[k]) for k in w), jcfg,
        e_lo=0, e_n=ep, C=C)
    got = TM._dispatch_ffn_combine(
        torch.from_numpy(xt), torch.from_numpy(np.asarray(jg)), ti,
        *(torch.from_numpy(w[k]) for k in w), tcfg, e_lo=0, e_n=ep, C=C)
    assert _rel(got.numpy(), want) <= FLOAT_RTOL
    # a dropped slot contributes nothing: a token whose every slot dropped
    # comes out zero in both
    dropped_all = (~tkeep.reshape(96, -1)).all(dim=1).numpy()
    assert np.array_equal(np.asarray(want)[dropped_all] == 0,
                          got.numpy()[dropped_all] == 0)


@pytest.mark.parametrize("name", MOE)
@pytest.mark.parametrize("mode", list(MODES))
def test_apply_moe_matches_reference(name, mode):
    """The block at each softmax mode (deepseek with its 2 shared
    experts), [2, 48] tokens at the config's capacity factor 1.25."""
    ts, ta, js, ja = MODES[mode]
    jcfg, tcfg, p, xt = _block_inputs(name, 4, 96)
    jcfg = jcfg.with_(softmax_mode=js, act_approx=ja)
    tcfg = tcfg.with_(softmax_mode=ts, act_approx=ta)
    x = xt.reshape(2, 48, -1)
    want = JM.apply_moe(jax.tree.map(jnp.asarray, p), jnp.asarray(x), jcfg)
    with torch.inference_mode():
        got = TM.apply_moe(_tp(p), torch.from_numpy(x), tcfg)
    assert got.shape == want.shape and got.dtype == torch.float32
    assert _rel(got.numpy(), want) <= FLOAT_RTOL
    assert ("shared" in p) == (name == "deepseek-moe-16b")


def test_apply_moe_promotes_bf16_against_float32_weights():
    """An integer plan's blocks are a float32 view: bf16 activations meet
    float32 router and experts, and the block runs its products in
    float32 and returns bf16, as ``jnp`` promotes."""
    jcfg, tcfg, p, xt = _block_inputs("deepseek-moe-16b", 5, 32)
    jcfg, tcfg = jcfg.with_(dtype="bfloat16"), tcfg.with_(dtype="bfloat16")
    x = xt.reshape(2, 16, -1)
    want = JM.apply_moe(jax.tree.map(jnp.asarray, p),
                        jnp.asarray(x, jnp.bfloat16), jcfg)
    with torch.inference_mode():
        got = TM.apply_moe(_tp(p), torch.from_numpy(x).to(torch.bfloat16),
                           tcfg)
    assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
    # one bf16 rounding of the output apart at most
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=2 ** -7,
                               atol=2 ** -7 * float(np.abs(want).max()))


def test_apply_moe_raises_on_a_mesh():
    """The expert-parallel branch runs on a device mesh (it raised before
    the mesh was ported): on a one-rank gloo mesh — the card's mesh
    shape — it routes every token through the one model rank's experts
    and equals the local branch bit for bit (4 ranks:
    tests/test_torch_mesh.py)."""
    import socket

    import torch.distributed as dist

    from repro_torch.dist import ctx
    from repro_torch.launch import mesh as tmesh
    _, tcfg, p, xt = _block_inputs("granite-moe-3b-a800m", 0, 8)
    x = torch.from_numpy(xt)[None]
    assert ctx._mesh_active() is False
    want = TM.apply_moe(_tp(p), x, tcfg)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=1, rank=0)
    try:
        mesh = tmesh.make_host_mesh(1, 1)
        with mesh, ctx.mesh_context(tmesh.dp_axes(mesh)):
            assert ctx._mesh_active() is True
            got = TM.apply_moe(_tp(p), x, tcfg)
    finally:
        dist.destroy_process_group()
    assert ctx._mesh_active() is False
    assert torch.equal(got, want)


def test_load_balance_loss_matches_reference():
    jcfg, tcfg = _cfgs("granite-moe-3b-a800m")
    rng = np.random.default_rng(6)
    logits = rng.normal(0, 2, (64, jcfg.n_experts)).astype(np.float32)
    idx = rng.integers(0, jcfg.n_experts, (64, jcfg.top_k)).astype(np.int32)
    want = JM.load_balance_loss(jnp.asarray(logits), jnp.asarray(idx), jcfg)
    got = TM.load_balance_loss(torch.from_numpy(logits),
                               torch.from_numpy(idx), tcfg)
    assert abs(float(got) - float(want)) <= 1e-6


# ---------------------------------------------------------------------------
# the two smoke configs whole
# ---------------------------------------------------------------------------

def _check(got, want, plan, what):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, what
    if plan == "float":
        np.testing.assert_allclose(got, want, rtol=0, atol=FLOAT_ATOL,
                                   err_msg=what)
    else:
        assert np.array_equal(got, want), \
            f"{what}: max abs {np.abs(got - want).max()}"


@pytest.mark.parametrize("name", MOE)
@pytest.mark.parametrize("plan", list(PLANS))
def test_moe_plan_matches_reference_plan(name, plan):
    jcfg, tcfg, jp, tp = _setup(name)
    toks = _tokens(tcfg)
    je = jrt.compile_model(jcfg, jp, backend=PLANS[plan])
    te = _compile(tcfg, tp, plan)
    assert te.int_exec == je.int_exec
    _check(te.forward(toks).numpy(), je.forward(jnp.asarray(toks)), plan,
           f"{name} {plan} forward")
    js = je.init_decode_state(2, 32)
    jl, js = je.prefill(jnp.asarray(toks[:, :-1]), js)
    jd, _ = je.decode_step(jnp.asarray(toks[:, -1]), js)
    ts = te.init_decode_state(2, 32)
    tl, ts = te.prefill(toks[:, :-1], ts)
    td, _ = te.decode_step(toks[:, -1], ts)
    _check(tl.numpy(), jl, plan, f"{name} {plan} prefill")
    _check(td.numpy(), jd, plan, f"{name} {plan} decode_step")


@pytest.mark.parametrize("name", MOE)
@pytest.mark.parametrize("plan", list(PLANS))
def test_moe_decode_matches_forward(name, plan):
    """The reference's own check (tests/test_models.py) at its drop-free
    capacity factor: the last token decoded against a cache of the prompt
    equals the last position of the teacher-forced forward."""
    _, tcfg, _, tp = _setup(name, seed=2, capacity_factor=DROP_FREE)
    eng = _compile(tcfg, tp, plan)
    toks = _tokens(tcfg, seed=3)
    ref = eng.forward(toks)[:, -1]
    state = eng.init_decode_state(2, 32)
    _, state = eng.prefill(toks[:, :-1], state)
    lg, _ = eng.decode_step(toks[:, -1], state)
    assert float((lg - ref).abs().max()) / float(ref.abs().max()) \
        < DECODE_REL


@pytest.mark.parametrize("plan", ["lut", "cuda"])
def test_moe_partial_residency_matches_reference(plan):
    """The router and the expert stacks (padded experts included) and the
    shared experts are dequantised float32 as the reference's, from
    per-channel exponents over the same leaves."""
    jcfg, tcfg, jp, tp = _setup("deepseek-moe-16b")
    je = jrt.compile_model(jcfg, jp, backend=PLANS[plan])
    te = _compile(tcfg, tp, plan)
    tm, jm = te.params["blocks"]["moe"], je.params["blocks"]["moe"]
    leaves = jax.tree_util.tree_leaves_with_path(jm)
    assert len(leaves) == 7
    for path, want in leaves:
        got = tm
        for k in path:
            got = got[k.key]
        assert isinstance(got, torch.Tensor) and got.dtype == torch.float32
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert te.quantized_bytes == tuple(je.quantized_bytes)


def test_cuda_plan_routes_through_the_softmax(monkeypatch):
    """On the ``cuda`` plan the router runs ``approx.softmax(mode="cuda")``
    (the kernel on the card: two softmax launches a layer with the
    attention's); on the CPU the wrappers count nothing."""
    _, tcfg, _, tp = _setup("granite-moe-3b-a800m")
    eng = _compile(tcfg, tp, "cuda")
    assert eng.exec_cfg.softmax_mode == "cuda"
    calls = []
    real = tops.lut_softmax

    def counting(x, **kw):
        calls.append(tuple(x.shape))
        return real(x, **kw)

    monkeypatch.setattr(tops, "lut_softmax", counting)
    tops.reset_launch_counts()
    eng.forward(_tokens(tcfg))
    assert calls.count((32, tcfg.n_experts)) == tcfg.n_layers
    assert len(calls) == 2 * tcfg.n_layers
    assert tops.launch_counts() == {k: 0 for k in tops.launch_counts()}


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------

def _requests(cfg, n=6, seed=0):
    rng = np.random.RandomState(seed)
    return [(i, rng.randint(0, cfg.vocab_size, rng.randint(2, 10)),
             int(rng.randint(2, 8))) for i in range(n)]


def _serve(eng, reqs, order, slots=3):
    sched = cellmod.LMScheduler(eng, slots=slots, max_len=24, prefill_len=16)
    for j in order:
        sched.submit(*reqs[j])
    return sched.run()


@pytest.mark.parametrize("plan", ["float", "cuda"])
def test_scheduler_serves_moe_order_invariant_when_drop_free(plan):
    """Per-lane decode on a moe engine; at the drop-free capacity factor
    the same requests in two orders give the same tokens (ROADMAP C8: at
    1.25 a join group shares its experts' capacity)."""
    _, tcfg, _, tp = _setup("granite-moe-3b-a800m",
                            capacity_factor=DROP_FREE)
    eng = _compile(tcfg, tp, plan)
    reqs = _requests(tcfg)
    a = _serve(eng, reqs, range(len(reqs)))
    b = _serve(eng, reqs, reversed(range(len(reqs))))
    assert a == b
    assert {k: len(v) for k, v in a.items()} == {r[0]: r[2] for r in reqs}


def test_per_lane_moe_decode_step_equals_the_scalar_one():
    _, tcfg, _, tp = _setup("deepseek-moe-16b", capacity_factor=DROP_FREE)
    eng = _compile(tcfg, tp, "cuda")
    toks = _tokens(tcfg)
    state = eng.init_decode_state(2, 32)
    _, state = eng.prefill(toks[:, :-1], state)
    lanes = {"layers": {k: v.clone() for k, v in state["layers"].items()},
             "index": torch.full((2,), state["index"], dtype=torch.long)}
    a, _ = eng.decode_step(toks[:, -1], state)
    b, _ = eng.decode_step(toks[:, -1], lanes)
    assert torch.equal(a, b)


def test_scheduler_emits_the_reference_schedulers_tokens():
    """On the ``lut`` plan (bit-equal logits) the port's scheduler emits
    the reference scheduler's greedy tokens for a moe engine."""
    from repro import cell as jcell
    jcfg, tcfg, jp, tp = _setup("deepseek-moe-16b")
    je = jrt.compile_model(jcfg, jp, backend="lut")
    te = _compile(tcfg, tp, "lut")
    reqs = _requests(tcfg, n=4, seed=1)
    js = jcell.LMScheduler(je, slots=2, max_len=24, prefill_len=16)
    ts = cellmod.LMScheduler(te, slots=2, max_len=24, prefill_len=16)
    for r in reqs:
        js.submit(*r)
        ts.submit(*r)
    assert ts.run() == js.run()


@pytest.mark.parametrize("name", MOE)
def test_serve_cli_serves_moe_on_the_cpu(name, capsys):
    out = serve.main(["--arch", name, "--smoke", "--device", "cpu",
                      "--backend", "cuda", "--requests", "4",
                      "--max-len", "32"])
    reqs = serve.make_requests(tregistry.get(name).smoke, 4, 32, 0)
    assert {k: len(v) for k, v in out.items()} == \
        {r["id"]: r["gen"] for r in reqs}
    log = capsys.readouterr().out
    assert "event=serve_done" in log and f"Engine[cuda] {name}" in log


def test_moe_engine_dataclass_replace_keeps_params():
    """A plan at another capacity factor shares the planned weights (how
    ``chip_smoke.py`` holds the served plan drop-free)."""
    _, tcfg, _, tp = _setup("granite-moe-3b-a800m")
    eng = _compile(tcfg, tp, "cuda")
    free = dataclasses.replace(
        eng, exec_cfg=eng.exec_cfg.with_(capacity_factor=DROP_FREE))
    assert free.params is eng.params and free.exec_cfg.int_exec
    assert free.forward(_tokens(tcfg)).shape == (2, 16, tcfg.padded_vocab)


def test_decode_gap_tool_takes_a_moe_plan_apart(capsys):
    """``tools/lm_decode_gap.py`` on a moe config (the decode-against-
    forward diagnosis of ``chip_smoke.py``'s ``lm_granite_moe``, run on the
    card) on the CPU at smoke size: drop-free, one row a plan, every route
    of the last position the same in the decode step as in the forward."""
    path = pathlib.Path(__file__).resolve().parents[1] / "tools" / \
        "lm_decode_gap.py"
    spec = importlib.util.spec_from_file_location("lm_decode_gap", path)
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    assert tool.main(["--arch", "granite-moe-3b-a800m", "--smoke",
                      "--device", "cpu"]) == 0
    rows = [json.loads(line) for line in capsys.readouterr().out.splitlines()]
    assert len(rows) == 11
    assert all(r["model"] == "granite-moe-3b-a800m" for r in rows)
    assert all(r["expert_set_agree"] == 1.0 and r["first_route_flip"] is None
               and r["per_lane_equal"] and r["argmax_equal"] for r in rows)
    assert [r["rel"] for r in rows] == [0.0] * 11


def test_cuda_vs_lut_gap_is_the_attentions_masked_softmax(capsys):
    """``tools/lm_decode_gap.py --cuda-vs-lut`` (the granite-moe split run
    on the card) at smoke size on the CPU: the ``cuda`` and ``lut`` plans'
    attention outputs part from the first layer (the kernel's masked
    lanes leak at the clip bin and renormalise in float32; the ``lut``
    rule drops them in Q8.24), routes then flip, and the logits part; with
    the ``cuda`` plan's attention outputs forced into the ``lut`` forward
    the logits are equal bit for bit — at the config's capacity factor
    (drops included) and the drop-free one.  No other op sets the plans
    apart."""
    path = pathlib.Path(__file__).resolve().parents[1] / "tools" / \
        "lm_decode_gap.py"
    spec = importlib.util.spec_from_file_location("lm_decode_gap", path)
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    assert tool.main(["--arch", "granite-moe-3b-a800m", "--smoke",
                      "--device", "cpu", "--cuda-vs-lut"]) == 0
    rows = [json.loads(line) for line in capsys.readouterr().out.splitlines()]
    assert [r["capacity_factor"] for r in rows] == [1.25, 8.0]
    for r in rows:
        assert r["attn_rel"][0] > 0 and r["logits_max_abs"] > 0
        assert min(r["expert_set_agree"]) < 1.0
        assert r["forced"]["equal"]
    assert rows[1]["dropped"] == {"cuda": [0, 0], "lut": [0, 0]}
