"""The rwkv family in the port against the reference: the chunked wkv
scan and its naive oracle, the time-mix and channel-mix blocks in every
projection layout, and rwkv6-3b's smoke config through ``forward``,
``prefill`` and ``decode_step`` under the port's ``float``, ``lut`` and
``cuda`` plans against the reference's ``float``, ``lut`` and ``pallas``
plans (the ``cuda`` plan through its kernels' plain versions on the CPU,
the reference's in interpret mode), on the same numpy weights and tokens.

Tolerances, beside what was measured on the CPU (PERF.md §6):

* the scans and blocks: float32 ``cumsum`` / ``exp`` / ``tanh`` /
  ``rsqrt`` and the products round apart under PyTorch and XLA:CPU:
  ``SCAN_TOL`` and ``BLOCK_TOL``, rtol and atol 1e-4, the reference's own
  bound between its chunked scan and its naive oracle (measured: at most
  4.5e-5 absolute on outputs up to ~30, 2.5e-6 of the largest magnitude,
  scans and chunk bodies; 9.5e-6 absolute, 9.4e-7 relative, the blocks);
* the model's logits: ``float`` atol 1e-4 (measured 3.4e-6), ``lut`` and
  ``cuda`` bit-equal (measured 0.0: no ulp moved an eq-9 code of the
  head's input on these weights and tokens; one that did would move a
  logit by one input step of the head, ``max|W_head| * 2^-5``);
* decode == forward within the reference's rel 1e-4, state continuity
  within its atol 1e-3 (``tests/test_models.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import runtime as jrt
from repro.configs import registry as jregistry
from repro.core import quant as jquant
from repro.models import rwkv as JR
from repro.models import transformer as JT
from repro_torch import convert
from repro_torch import runtime as trt
from repro_torch.configs import registry as tregistry
from repro_torch.core import quant as tquant
from repro_torch.core.tree import tree_leaves_sorted
from repro_torch.models import layers as L
from repro_torch.models import rwkv as TR
from repro_torch.models import transformer as TT

torch.set_num_threads(1)

PLANS = {"float": "float", "lut": "lut", "cuda": "pallas"}

NAME = "rwkv6-3b"
SCAN_TOL = 1e-4
NAIVE_TOL = 1e-4              # the reference's chunked-vs-naive bound
BLOCK_TOL = 1e-4
FLOAT_ATOL = 1e-4
DECODE_REL = 1e-4
CONTINUITY_ATOL = 1e-3
# the two projection layouts and the padded heads (smoke: 2 heads -> 16)
VARIANTS = {"split": {}, "fused": {"rwkv_fused_proj": True},
            "padded": {"rwkv_head_pad": True},
            "fused_padded": {"rwkv_fused_proj": True, "rwkv_head_pad": True}}


def np_params(jcfg, seed=0):
    """Reference-layout parameters with every leaf random: matrices
    fan-in scaled (stacked block leaves by their per-layer fan-in),
    vectors small, norm scales around 1 (the reference's zeros and ones
    would hide a dropped bias, bonus or scale)."""
    shapes = jax.eval_shape(lambda k: JT.init_params(jcfg, k),
                            jax.random.PRNGKey(0))
    rng = np.random.default_rng(seed)

    def leaf(path, s):
        names = [getattr(k, "key", "") for k in path]
        per = s.shape[1:] if names[0] == "blocks" else s.shape
        if "scale" in names or names[-1] in ("q_norm", "k_norm", "ln_x",
                                             "out_norm_a", "out_norm_m"):
            return rng.normal(1.0, 0.1, s.shape).astype(np.float32)
        scale = 1.0 / np.sqrt(per[0]) if len(per) > 1 else 0.1
        return rng.normal(0, scale, s.shape).astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


def _cfgs(**kw):
    return (jregistry.get(NAME).smoke.with_(**kw),
            tregistry.get(NAME).smoke.with_(**kw))


def _setup(seed=0, **kw):
    jcfg, tcfg = _cfgs(**kw)
    npp = np_params(jcfg, seed)
    return jcfg, tcfg, jax.tree.map(jnp.asarray, npp), \
        convert.from_numpy_tree(npp, "cpu")


def _tokens(cfg, b=2, s=16, seed=1):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (b, s)).astype(np.int32)


def _compile(tcfg, tp, plan, **kw):
    return trt.compile_model(tcfg, tp, backend=plan, device="cpu",
                             plain_kernels=plan == "cuda", **kw)


def _close(got, want, tol, what):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=tol,
                               atol=tol, err_msg=what)


def _wkv_inputs(b, h, s, dh, seed=0, state=True):
    rng = np.random.default_rng(seed)
    r, k, v = (rng.normal(size=(b, h, s, dh)).astype(np.float32)
               for _ in range(3))
    lw = -np.exp(rng.normal(size=(b, h, s, dh))).astype(np.float32)
    u = (rng.normal(size=(h, dh)) * 0.1).astype(np.float32)
    S0 = (rng.normal(size=(b, h, dh, dh)) * (0.5 if state else 0.0)) \
        .astype(np.float32)
    return r, k, v, lw, u, S0


# ---------------------------------------------------------------------------
# the recurrence
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("c", [16, 5, 1])
def test_chunk_body_matches_reference(c):
    r, k, v, lw, u, S0 = _wkv_inputs(2, 3, c, 16)
    chunk = {"r": r, "k": k, "v": v, "lw": lw}
    jS, jy = JR.chunk_body(jnp.asarray(S0), jax.tree.map(jnp.asarray, chunk),
                           jnp.asarray(u))
    tS, ty = TR.chunk_body(torch.from_numpy(S0),
                           {n: torch.from_numpy(a) for n, a in chunk.items()},
                           torch.from_numpy(u))
    _close(ty, jy, SCAN_TOL, "y")
    _close(tS, jS, SCAN_TOL, "S")


@pytest.mark.parametrize("s", [67, 9, 1])
def test_wkv_scan_matches_reference_and_naive(s):
    """Length 67: four full chunks and a tail of 3; S < CHUNK: one direct
    call (decode)."""
    arrays = _wkv_inputs(2, 3, s, 16, seed=s)
    jy, jS = JR.wkv_scan(*map(jnp.asarray, arrays))
    ty, tS = TR.wkv_scan(*map(torch.from_numpy, arrays))
    _close(ty, jy, SCAN_TOL, "scan y")
    _close(tS, jS, SCAN_TOL, "scan S")
    ny, nS = TR.wkv_naive(*map(torch.from_numpy, arrays))
    jny, jnS = JR.wkv_naive(*map(jnp.asarray, arrays))
    _close(ny, jny, SCAN_TOL, "naive y")
    _close(nS, jnS, SCAN_TOL, "naive S")
    _close(ty, ny, NAIVE_TOL, "scan against naive y")
    _close(tS, nS, NAIVE_TOL, "scan against naive S")


# ---------------------------------------------------------------------------
# the blocks
# ---------------------------------------------------------------------------

def _layer0(tree):
    return jax.tree.map(lambda a: a[0], tree)


def _block_inputs(jcfg, b=2, s=19, seed=3):
    rng = np.random.default_rng(seed)
    d = jcfg.d_model
    x = rng.normal(size=(b, s, d)).astype(np.float32)
    h = JR.n_heads(jcfg)
    st = {"tmix": {"S": (rng.normal(size=(b, h, 64, 64)) * 0.3)
                   .astype(np.float32),
                   "x_prev": rng.normal(size=(b, 1, d)).astype(np.float32)},
          "cmix": {"x_prev": rng.normal(size=(b, 1, d)).astype(np.float32)}}
    return x, st


def _to_t(tree):
    return convert.from_numpy_tree(jax.tree.map(np.asarray, tree), "cpu")


@pytest.mark.parametrize("variant", list(VARIANTS))
@pytest.mark.parametrize("mode", ["exact", "lut"])
def test_mixes_match_reference(variant, mode):
    """Time-mix and channel-mix of layer 0 with a carried state (S and
    both token-shift tails), the receptance sigmoid exact or the LUT."""
    jcfg, tcfg, jp, tp = _setup(**VARIANTS[variant], act_approx=mode)
    x, st = _block_inputs(jcfg)
    jb, tb = _layer0(jp["blocks"]), _layer0(tp["blocks"])
    tst = _to_t(st)
    xt = torch.from_numpy(x)
    for part, jf, tf in (("tmix", JR.apply_time_mix, TR.apply_time_mix),
                         ("cmix", JR.apply_channel_mix, TR.apply_channel_mix)):
        jo, js = jf(jb[part], jnp.asarray(x), jcfg,
                    jax.tree.map(jnp.asarray, st[part]))
        to, ts = tf(tb[part], xt, tcfg, tst[part])
        assert to.dtype == xt.dtype
        _close(to, jo, BLOCK_TOL, f"{part} out")
        for key in js:
            _close(ts[key], js[key], BLOCK_TOL, f"{part} {key}")
    jo, js = JR.apply_block(jb, jnp.asarray(x), jcfg,
                            jax.tree.map(jnp.asarray, st))
    to, ts = TR.apply_block(tb, xt, tcfg, tst)
    _close(to, jo, BLOCK_TOL, "block")
    _close(ts["tmix"]["S"], js["tmix"]["S"], BLOCK_TOL, "block S")


def test_padded_heads_preserve_the_function():
    """Zero pad heads change nothing: the padded layout's block equals
    the unpadded one on the same real weights (the reference's claim)."""
    _, tcfg = _cfgs()
    _, pcfg = _cfgs(rwkv_head_pad=True)
    tp = TT.init_params(tcfg, torch.Generator().manual_seed(0), "cpu")
    pp = TT.init_params(pcfg, torch.Generator().manual_seed(0), "cpu")
    assert TR.n_heads(tcfg) == 2 and TR.n_heads(pcfg) == 16
    di = 16 * 64
    assert pp["blocks"]["tmix"]["wr"].shape[-1] == di
    assert float(pp["blocks"]["tmix"]["wr"][..., 128:].abs().max()) == 0.0
    # carry the real weights into the padded layout
    for name in ("wr", "wk", "wv", "wg", "wB"):
        pp["blocks"]["tmix"][name][..., :128] = tp["blocks"]["tmix"][name]
    pp["blocks"]["tmix"]["wo"][:, :128] = tp["blocks"]["tmix"]["wo"]
    for name in ("mu", "wA"):
        pp["blocks"]["tmix"][name] = tp["blocks"]["tmix"][name]
    pp["blocks"]["cmix"] = tp["blocks"]["cmix"]
    pp["embed"], pp["lm_head"] = tp["embed"], tp["lm_head"]
    toks = torch.from_numpy(_tokens(tcfg))
    with torch.inference_mode():
        a = TT.forward(tp, toks, tcfg)
        b = TT.forward(pp, toks, pcfg)
    assert float((a - b).abs().max()) < 1e-5


# ---------------------------------------------------------------------------
# the model against the reference's plans
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


@pytest.mark.parametrize("plan", list(PLANS))
def test_rwkv_plan_matches_reference_plan(plan):
    jcfg, tcfg, jp, tp = _setup()
    toks = _tokens(tcfg)
    je = jrt.compile_model(jcfg, jp, backend=PLANS[plan])
    te = _compile(tcfg, tp, plan)
    assert te.int_exec == je.int_exec
    _check(te.forward(toks).numpy(), je.forward(jnp.asarray(toks)), plan,
           f"{plan} forward")
    js = je.init_decode_state(2, 32)
    jl, js = je.prefill(jnp.asarray(toks[:, :-1]), js)
    jd, js = je.decode_step(jnp.asarray(toks[:, -1]), js)
    ts = te.init_decode_state(2, 32)
    tl, ts = te.prefill(toks[:, :-1], ts)
    assert ts["index"] == 15
    td, ts = te.decode_step(toks[:, -1], ts)
    assert ts["index"] == 16
    _check(tl.numpy(), jl, plan, f"{plan} prefill")
    _check(td.numpy(), jd, plan, f"{plan} decode_step")
    # the final recurrence: float32 scans, rounded apart
    for part, key in (("tmix", "S"), ("tmix", "x_prev"), ("cmix", "x_prev")):
        np.testing.assert_allclose(ts["layers"][part][key].numpy(),
                                   np.asarray(js["layers"][part][key]),
                                   rtol=SCAN_TOL, atol=SCAN_TOL,
                                   err_msg=f"{plan} state {part}.{key}")


@pytest.mark.parametrize("variant", ["fused", "padded"])
def test_rwkv_variant_logits_match_reference(variant):
    jcfg, tcfg, jp, tp = _setup(**VARIANTS[variant])
    toks = _tokens(tcfg)
    je = jrt.compile_model(jcfg, jp, backend="float")
    te = _compile(tcfg, tp, "float")
    _check(te.forward(toks).numpy(), je.forward(jnp.asarray(toks)), "float",
           f"{variant} forward")


@pytest.mark.parametrize("plan", list(PLANS))
def test_decode_matches_forward(plan):
    """The reference's own check, in the port: prefill of S - 1 tokens and
    one decode step against the last position of the forward."""
    _, tcfg, _, tp = _setup(seed=2)
    eng = _compile(tcfg, tp, plan)
    toks = _tokens(tcfg, seed=3)
    ref = eng.forward(toks)[:, -1]
    state = eng.init_decode_state(2, 32)
    _, state = eng.prefill(toks[:, :-1], state)
    lg, _ = eng.decode_step(toks[:, -1], state)
    rel = float((lg - ref).abs().max()) / float(ref.abs().max())
    assert rel < DECODE_REL


def test_state_continuity_matches_reference():
    """prefill(a + b) == prefill(a) then prefill(b) through the carried
    state (the reference's check, at its split of 24 = 11 + 13), and the
    port's split prefill against the reference's."""
    jcfg, tcfg, jp, tp = _setup()
    toks = _tokens(tcfg, b=1, s=24, seed=4)
    eng = _compile(tcfg, tp, "float")
    full, _ = eng.prefill(toks, eng.init_decode_state(1, 24))
    st = eng.init_decode_state(1, 24)
    _, st = eng.prefill(toks[:, :11], st)
    split, st = eng.prefill(toks[:, 11:], st)
    assert st["index"] == 24
    assert float((split - full).abs().max()) < CONTINUITY_ATOL
    je = jrt.compile_model(jcfg, jp, backend="float")
    js = je.init_decode_state(1, 24)
    _, js = je.prefill(jnp.asarray(toks[:, :11]), js)
    jsplit, _ = je.prefill(jnp.asarray(toks[:, 11:]), js)
    _check(split.numpy(), jsplit, "float", "split prefill")


def test_merge_decode_state_and_per_lane_decode():
    """The reference's per-lane index covers rwkv: lanes merged from two
    states decode with a [B] index, equal to the reference's merged
    decode and to each lane's own scalar decode."""
    jcfg, tcfg, jp, tp = _setup()
    te = _compile(tcfg, tp, "float")
    je = jrt.compile_model(jcfg, jp, backend="float")
    a, b = _tokens(tcfg, s=9, seed=5), _tokens(tcfg, s=9, seed=6)
    mask = np.array([False, True])
    ta = te.prefill(a, te.init_decode_state(2, 16))[1]
    tb = te.prefill(b, te.init_decode_state(2, 16))[1]
    merged = TT.merge_decode_state(ta, tb, mask)
    assert merged["index"].tolist() == [9, 9]
    assert merged["layers"]["tmix"]["S"].data_ptr() not in (
        ta["layers"]["tmix"]["S"].data_ptr(),
        tb["layers"]["tmix"]["S"].data_ptr())
    nxt = np.array([3, 7], np.int32)
    got, after = te.decode_step(nxt, merged)
    assert after["index"].tolist() == [10, 10]
    ja = je.prefill(jnp.asarray(a), je.init_decode_state(2, 16))[1]
    jb = je.prefill(jnp.asarray(b), je.init_decode_state(2, 16))[1]
    jm = JT.merge_decode_state(ja, jb, jnp.asarray(mask))
    want, _ = je.decode_step(jnp.asarray(nxt), jm)
    _check(got.numpy(), want, "float", "merged per-lane decode")
    own_a, _ = te.decode_step(nxt, ta)
    own_b, _ = te.decode_step(nxt, tb)
    assert torch.equal(got[0], own_a[0]) and torch.equal(got[1], own_b[1])


# ---------------------------------------------------------------------------
# quantisation and dtypes
# ---------------------------------------------------------------------------

def _qpaths(tree, qtype):
    flat = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, qtype))[0]
    return {jax.tree_util.keystr(p) for p, leaf in flat
            if isinstance(leaf, qtype)}


def _tpaths(tree, prefix=""):
    out = set()
    for k, v in tree.items():
        p = f"{prefix}['{k}']"
        if isinstance(v, dict):
            out |= _tpaths(v, p)
        elif isinstance(v, tquant.QTensor):
            out.add(p)
    return out


@pytest.mark.parametrize("name", ["rwkv6-3b", "hymba-1.5b"])
def test_quantised_leaf_set_matches_reference(name):
    """The recipe quantises every leaf of rank >= 2, so every stacked
    block leaf — decays, bonus, mixes, norms included — is stored; the
    port's recipe selects the same set and the same payloads."""
    jcfg, tcfg = jregistry.get(name).smoke, tregistry.get(name).smoke
    npp = np_params(jcfg)
    jq = jrt.QuantRecipe.from_config(jcfg).quantize(
        jax.tree.map(jnp.asarray, npp))
    tq = trt.QuantRecipe.from_config(tcfg).quantize(
        convert.from_numpy_tree(npp, "cpu"))
    jset, tset = _qpaths(jq, jquant.QTensor), _tpaths(tq)
    assert tset == jset
    must = ({"['blocks']['tmix']['" + n + "']" for n in
             ("mu", "w0", "u", "ln_x", "wA", "wB")}
            | {"['blocks']['ln1']['scale']", "['blocks']['ln2']['bias']"}
            if name == "rwkv6-3b" else
            {"['blocks']['mamba']['" + n + "']" for n in
             ("A_log", "D", "dt_bias", "conv_w", "conv_b")}
            | {"['blocks']['out_norm_a']", "['blocks']['out_norm_m']"})
    assert must <= tset
    assert "['ln_f']['scale']" not in tset
    flat_j = dict(jax.tree_util.tree_flatten_with_path(
        jq, is_leaf=lambda x: isinstance(x, jquant.QTensor))[0])
    for path, leaf in flat_j.items():
        if isinstance(leaf, jquant.QTensor):
            node = tq
            for k in path:
                node = node[k.key]
            assert np.array_equal(node.values.numpy(), np.asarray(leaf.values))


class _Casts:
    """Records (output dtype, input dtype) of every block output that
    ``layers.keep_dtype`` casts."""

    def __init__(self, monkeypatch):
        self.pairs = []
        keep = L.keep_dtype

        def rec(y, x):
            self.pairs.append((y.dtype, x.dtype))
            return keep(y, x)
        monkeypatch.setattr(L, "keep_dtype", rec)

    def acted(self) -> bool:
        assert self.pairs
        return any(a != b for a, b in self.pairs)


@pytest.mark.parametrize("dtype,plan,cast_acts", [
    ("float32", "float", False), ("float32", "lut", False),
    ("float32", "cuda", False), ("bfloat16", "float", False),
    ("bfloat16", "lut", True), ("bfloat16", "cuda", True)])
def test_block_output_cast_is_a_no_op_where_the_reference_runs(
        dtype, plan, cast_acts, monkeypatch):
    """ROADMAP C9: a block returns the dtype it was given.  Where the
    reference runs (float32 on every plan, bf16 on ``float``) every
    projection already comes out in the model dtype, so the cast changes
    nothing; on a bf16 integer plan the float32 block view makes them
    float32, and the cast keeps the residual stream bf16."""
    _, tcfg = _cfgs(dtype=dtype)
    tp = TT.init_params(tcfg, torch.Generator().manual_seed(0), "cpu")
    eng = _compile(tcfg, tp, plan)
    casts = _Casts(monkeypatch)
    logits = eng.forward(_tokens(tcfg))
    assert len(casts.pairs) == 2 * tcfg.n_layers
    assert casts.acted() == cast_acts
    assert bool(torch.isfinite(logits.float()).all())


@pytest.mark.parametrize("plan", ["lut", "cuda"])
def test_bf16_integer_plan_runs_where_the_reference_raises(plan):
    """ROADMAP C9: the reference's blocks multiply a bf16 activation by
    the float32 view of the dequantised blocks, the residual widens to
    float32 inside its layer scan, and ``lax.scan`` refuses the carry.
    The port casts each mix's output back: it serves, the tails stay bf16,
    and decode == forward holds."""
    jcfg, tcfg = _cfgs(dtype="bfloat16")
    jp = JT.init_params(jcfg, jax.random.PRNGKey(0))
    toks = _tokens(tcfg)
    je = jrt.compile_model(jcfg, jp, backend=PLANS[plan])
    with pytest.raises(TypeError, match="carry"):
        je.forward(jnp.asarray(toks))
    tp = TT.init_params(tcfg, torch.Generator().manual_seed(0), "cpu")
    eng = _compile(tcfg, tp, plan)
    state = eng.init_decode_state(2, toks.shape[1])
    assert state["layers"]["tmix"]["x_prev"].dtype == torch.bfloat16
    assert state["layers"]["tmix"]["S"].dtype == torch.float32
    _, state = eng.prefill(toks[:, :-1], state)
    lg, _ = eng.decode_step(toks[:, -1], state)
    ref = eng.forward(toks)[:, -1]
    assert lg.dtype == ref.dtype and bool(torch.isfinite(lg).all())
    assert torch.equal(lg.argmax(-1), ref.argmax(-1))
    assert float((lg - ref).abs().max() / ref.abs().max()) < DECODE_REL


def test_mesh_specs_raise_and_name_their_item():
    """The specs are ported (every config: tests/test_torch_specs.py):
    here the smoke config, padded heads included, against the
    reference's trees."""
    from jax.sharding import PartitionSpec as JP

    from repro.configs import registry as jregistry
    from repro.models import rwkv as JR
    for pad in (False, True):
        jcfg = jregistry.get(NAME).smoke.with_(rwkv_head_pad=pad)
        tcfg = tregistry.get(NAME).smoke.with_(rwkv_head_pad=pad)
        for name in ("time_mix_specs", "channel_mix_specs", "block_specs",
                     "state_specs"):
            want = jax.tree.leaves(getattr(JR, name)(jcfg),
                                   is_leaf=lambda x: isinstance(x, JP))
            got = tree_leaves_sorted(getattr(TR, name)(tcfg))
            assert [tuple(s) for s in want] == [tuple(s) for s in got]


@pytest.mark.parametrize("arch", ["rwkv6-3b", "hymba-1.5b"])
def test_decode_gap_tool_takes_the_recurrent_plans_apart(arch, capsys):
    """``tools/lm_decode_gap.py --arch`` on the recurrent families at smoke
    size on the CPU: one row a plan, decode == forward on every plan
    (measured 0.0 on the integer plans, below 1e-6 on ``float``); rwkv's
    per-lane step equal to the scalar one, hybrid's not taken (its ring
    caches take a shared index only)."""
    import importlib.util
    import json
    import pathlib
    path = pathlib.Path(__file__).resolve().parents[1] / "tools" / \
        "lm_decode_gap.py"
    spec = importlib.util.spec_from_file_location("lm_decode_gap", path)
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    assert tool.main(["--arch", arch, "--smoke", "--device", "cpu"]) == 0
    rows = [json.loads(line) for line in capsys.readouterr().out.splitlines()]
    assert len(rows) == 11 and {r["model"] for r in rows} == {arch}
    assert all(r["argmax_equal"] and r["rel"] < DECODE_REL for r in rows)
    lanes = {r["per_lane_equal"] for r in rows}
    assert lanes == ({None} if arch == "hymba-1.5b" else {True})
