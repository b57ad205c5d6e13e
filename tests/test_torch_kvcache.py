"""The int8 KV cache (``cfg.quant.quantize_kv_cache``) in the port against
the reference, on the CPU: the per-vector quantiser ``_q8_vec`` and its
decode, the cache's layout, the attention over it at a scalar and a
per-lane index, and prefill + decode of internlm2, granite-moe (drop-free
capacity 8.0), hymba (a prompt within the window, and the ring across
its wrap) and whisper's decoder self cache, each port plan against the
reference's same plan (``cuda`` through its kernels' plain versions
against ``pallas`` in interpret mode), plus continuous batching on the
int8 cache.

Tolerances, beside what was measured on this host:

* ``_q8_vec``: codes equal, exponents equal (ROADMAP C12 aside: the
  reference's ``log2`` reads above ``e`` at some ``2^e`` and picks the
  next exponent; pinned below), the reference's scales within rtol 5e-6
  of the port's exact ones where XLA:CPU's ``exp2`` is inexact (every
  ``e <= -13`` but -14: measured at most 1.0e-6 down to 2^-40 and 4.0e-6
  at 2^-104; the quantiser's exponents reach down to -106);
* logits: the tolerances the float cache is held to
  (tests/test_torch_lm_model.py, test_torch_hybrid.py,
  test_torch_encdec.py): ``float`` atol 1e-4, measured at most 3.8e-6;
  ``lut`` and ``cuda`` bit-equal (measured 0.0); whisper's ``float`` 1e-5
  and LUT plans 1e-3, measured at most 6.0e-7 on every plan;
* decode against forward: the port's gap equals the reference's own on
  the same plan within 1e-3 (measured at most 4.1e-7 apart; the gaps
  themselves are 0.011-0.041, the reference holds its int8 cache to 0.05
  in tests/test_dist.py), argmax equal.
"""

import importlib.util
import json
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import cell as jcell
from repro import runtime as jrt
from repro.configs import registry as jregistry
from repro.configs.base import QuantConfig as JQuant
from repro.models import encdec as JE
from repro.models import layers as jL
from repro.models import transformer as JT
from repro.runtime import backends as jbe
from repro_torch import cell as cellmod
from repro_torch import convert
from repro_torch import runtime as trt
from repro_torch.configs import registry as tregistry
from repro_torch.configs.base import QuantConfig as TQuant
from repro_torch.core.tree import tree_leaves
from repro_torch.models import encdec as TE
from repro_torch.models import layers as tL
from repro_torch.models import transformer as TT
from repro_torch.runtime import backends as tbe

torch.set_num_threads(1)

PLANS = {"float": "float", "lut": "lut", "cuda": "pallas"}
FLOAT_ATOL = 1e-4
WHISPER_FLOAT_ATOL = 1e-5
WHISPER_LUT_ATOL = 1e-3
SCALE_RTOL = 5e-6
GAP_ATOL = 1e-3
MOE_CAPACITY = 8.0          # drop-free: decode == forward needs no drops
HYMBA_W = 8                 # the hymba smoke config's window
ATTN_TOL = dict(rtol=1e-5, atol=1e-5)


def _cfgs(name, **kw):
    """The reference's and the port's smoke configs of ``name`` on the
    int8 cache."""
    return (jregistry.get(name).smoke.with_(
                quant=JQuant(quantize_kv_cache=True), **kw),
            tregistry.get(name).smoke.with_(
                quant=TQuant(quantize_kv_cache=True), **kw))


def _np(x):
    return np.asarray(x)


def _t(x):
    return torch.from_numpy(np.array(x))


def _lm_params(jcfg, seed=0):
    """Every leaf random (as tests/test_torch_lm_model.py's ``np_params``)."""
    shapes = jax.eval_shape(lambda k: JT.init_params(jcfg, k),
                            jax.random.PRNGKey(0))
    rng = np.random.default_rng(seed)

    def leaf(path, s):
        names = [getattr(k, "key", "") for k in path]
        per = s.shape[1:] if names[0] == "blocks" else s.shape
        if "scale" in names or names[-1] in ("q_norm", "k_norm"):
            return rng.normal(1.0, 0.1, s.shape).astype(np.float32)
        scale = 1.0 / np.sqrt(per[0]) if len(per) > 1 else 0.1
        return rng.normal(0, scale, s.shape).astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


_SETUP = {}


def _setup(name, **kw):
    """Both packages' int8-cache configs and the same weights (cached)."""
    key = (name, tuple(sorted(kw.items())))
    if key not in _SETUP:
        jcfg, tcfg = _cfgs(name, **kw)
        npp = _lm_params(jregistry.get(name).smoke)
        _SETUP[key] = (jcfg, tcfg, jax.tree.map(jnp.asarray, npp),
                       convert.from_numpy_tree(npp, "cpu"))
    return _SETUP[key]


_ENGINES = {}


def _engines(name, plan, **kw):
    key = (name, plan, tuple(sorted(kw.items())))
    if key not in _ENGINES:
        jcfg, tcfg, jp, tp = _setup(name, **kw)
        _ENGINES[key] = (
            jrt.compile_model(jcfg, jp, backend=PLANS[plan]),
            trt.compile_model(tcfg, tp, backend=plan, device="cpu",
                              plain_kernels=plan == "cuda"))
    return _ENGINES[key]


def _tokens(cfg, b=2, s=16, seed=1):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (b, s)).astype(np.int32)


def _check(got, want, plan, what):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, what
    if plan == "float":
        np.testing.assert_allclose(got, want, rtol=0, atol=FLOAT_ATOL,
                                   err_msg=what)
    else:
        assert np.array_equal(got, want), \
            f"{what}: max abs {np.abs(got - want).max()}"


def _gap(dec, fwd):
    dec, fwd = np.asarray(dec, np.float64), np.asarray(fwd, np.float64)
    return float(np.abs(dec - fwd).max() / np.abs(fwd).max()), \
        bool((dec.argmax(-1) == fwd.argmax(-1)).all())


# ---------------------------------------------------------------------------
# the quantiser
# ---------------------------------------------------------------------------

def _kv_like(seed, shape=(2, 16, 4, 32)):
    """K/V-like vectors over a wide range of magnitudes (per-vector
    maxabs from ~1e-9 to ~1e3), with zeros, ties at half a step and
    vectors of one value."""
    rng = np.random.default_rng(seed)
    x = rng.normal(0, 1, shape).astype(np.float32)
    mag = 10.0 ** rng.uniform(-9, 3, shape[:-1]).astype(np.float32)
    x = x * mag[..., None]
    x[0, 0] = 0.0                                     # all-zero vectors
    x[0, 1] = 3.0                                     # one value
    x[0, 2, :, :4] = np.float32([63.5, -63.5, 0.5, 127.0]) / 127.0 * 4
    return x


def _exponents(scale):
    """The nearest integer exponent of each scale (the reference's are
    within an ulp of a power of two), and whether it is one exactly."""
    scale = np.asarray(scale, np.float64)
    e = np.rint(np.log2(scale)).astype(np.int32)
    return e, scale == np.ldexp(1.0, e)


def _c12(x):
    """Vectors whose ``maxabs / 127`` is a power of two at which XLA:CPU's
    ``log2`` reads above the exponent (ROADMAP C12)."""
    y = np.maximum(np.abs(x).max(-1), np.float32(1e-30)) / np.float32(127)
    m, _ = np.frexp(y)
    return (m == 0.5) & (_np(jnp.log2(jnp.asarray(y))) > np.log2(y))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_q8_vec_codes_and_exponents_match_reference(seed):
    x = _kv_like(seed)
    assert not _c12(x).any()
    jq, js = jL._q8_vec(jnp.asarray(x))
    tq, ts = tL._q8_vec(_t(x))
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    assert np.array_equal(tq.numpy(), _np(jq))
    te, exact = _exponents(ts.numpy())
    je, _ = _exponents(_np(js))
    assert exact.all()                        # exact powers of two
    assert np.array_equal(te, je)
    np.testing.assert_allclose(ts.numpy(), _np(js), rtol=SCALE_RTOL, atol=0)


def test_q8_vec_c12_vector_is_pinned():
    """ROADMAP C12: at ``maxabs = 127 * 2^-13`` the reference's
    ``ceil(log2(maxabs / 127))`` reads -12 (XLA:CPU's log2 of 2^-13 lies
    just above -13) and its codes halve; the port's exponent is exactly
    -13, so the largest entry codes to 127 as it does at every other
    scale."""
    x = np.zeros((1, 1, 1, 8), np.float32)
    x[..., 0] = np.float32(127 * 2.0 ** -13)
    x[..., 1] = np.float32(-5 * 2.0 ** -13)
    assert float(jnp.log2(jnp.float32(2.0 ** -13))) > -13
    jq, js = jL._q8_vec(jnp.asarray(x))
    tq, ts = tL._q8_vec(_t(x))
    assert float(_np(js).ravel()[0]) == 2.0 ** -12
    assert float(ts.numpy().ravel()[0]) == 2.0 ** -13
    assert tq.numpy().ravel()[:2].tolist() == [127, -5]
    assert _np(jq).ravel()[:2].tolist() == [64, -2]      # 63.5 and -2.5: even
    # one ulp off the power of two, both packages agree again
    x[..., 0] = np.nextafter(x[..., 0], np.float32(1))
    jq, js = jL._q8_vec(jnp.asarray(x))
    tq, ts = tL._q8_vec(_t(x))
    assert np.array_equal(tq.numpy(), _np(jq))
    assert float(ts.numpy().ravel()[0]) == float(_np(js).ravel()[0]) == \
        2.0 ** -12


def test_reference_scales_near_the_exact_ones_below_2e_minus_13():
    """XLA:CPU's ``exp2(e)`` is not exactly ``2^e`` for integer ``e <= -13``
    (except -14); the port builds the scale from its bits."""
    es = np.arange(-106, -12)
    x = np.zeros((1, len(es), 1, 4), np.float32)
    x[0, :, 0, 0] = (127 * 1.5 * 2.0 ** (es - 1)).astype(np.float32)
    _, js = jL._q8_vec(jnp.asarray(x))
    _, ts = tL._q8_vec(_t(x))
    exact = (2.0 ** es).astype(np.float32)
    assert np.array_equal(ts.numpy().ravel(), exact)
    np.testing.assert_allclose(_np(js).ravel(), exact, rtol=SCALE_RTOL,
                               atol=0)
    assert not np.array_equal(_np(js).ravel(), exact)   # C12 still holds


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
def test_q8_vec_decode_matches_reference(dt):
    x = _kv_like(3)
    jq, js = jL._q8_vec(jnp.asarray(x))
    jdt = jnp.float32 if dt == torch.float32 else jnp.bfloat16
    want = _np(jL._q8_vec_decode(jq, js, jdt).astype(jnp.float32))
    got = tL._q8_vec_decode(_t(jq), _t(js), dt)        # the same codes
    assert got.dtype == dt
    assert np.array_equal(got.to(torch.float32).numpy(), want)
    # the round trip is within half a step of each vector's scale
    tq, ts = tL._q8_vec(_t(x))
    err = np.abs(tL._q8_vec_decode(tq, ts, torch.float32).numpy() - x)
    assert np.all(err <= ts.numpy()[..., None] / 2)


# ---------------------------------------------------------------------------
# the cache and the attention over it
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["internlm2-1.8b", "granite-moe-3b-a800m",
                                  "hymba-1.5b"])
def test_init_kv_cache_layout_matches_reference(name):
    jcfg, tcfg = _cfgs(name)
    jc = jL.init_kv_cache(jcfg, 2, 12, dtype=jnp.bfloat16)
    tc = tL.init_kv_cache(tcfg, 2, 12, dtype=torch.bfloat16)
    assert list(tc) == ["k", "ks", "v", "vs"] and set(tc) == set(jc)
    for key in tc:
        assert tuple(tc[key].shape) == jc[key].shape
        assert str(tc[key].dtype).split(".")[-1] == str(jc[key].dtype)
        assert np.array_equal(tc[key].numpy(), _np(jc[key]))
    assert tc["k"].dtype == torch.int8 and tc["ks"].dtype == torch.float32


def _attn_params(tc, seed=0):
    rng = np.random.default_rng(seed)
    d, h, kv, dh = tc.d_model, tc.n_heads, tc.n_kv_heads, \
        tc.resolved_head_dim
    shapes = {"wq": (d, h * dh), "wk": (d, kv * dh), "wv": (d, kv * dh),
              "wo": (h * dh, d)}
    return {k: rng.normal(0, 1 / np.sqrt(s[0]), s).astype(np.float32)
            for k, s in shapes.items()}


@pytest.mark.parametrize("mode", ["exact", "lut_fixed"])
def test_int8_cache_attention_matches_reference(mode):
    """A prefill of 5 tokens into an int8 cache of 12 (scalar write), then
    one token per lane at the lanes' own depths (scatter): outputs, codes
    and scales against the reference's."""
    jc, tc = _cfgs("internlm2-1.8b", softmax_mode=mode)
    p = _attn_params(tc)
    jp, tp = jax.tree.map(jnp.asarray, p), convert.from_numpy_tree(p, "cpu")
    rng = np.random.default_rng(5)
    b, d = 2, tc.d_model
    x = rng.normal(0, 1, (b, 5, d)).astype(np.float32)
    pos = np.arange(5, dtype=np.int32)
    jcache = jL.init_kv_cache(jc, b, 12)
    tcache = tL.init_kv_cache(tc, b, 12)
    jo, jcache = jL.apply_attention(jp, jnp.asarray(x), jc,
                                    positions=jnp.asarray(pos), cache=jcache,
                                    cache_index=0, kv_len_valid=5)
    to, tcache2 = tL.apply_attention(tp, _t(x), tc, positions=_t(pos),
                                     cache=tcache, cache_index=0,
                                     kv_len_valid=5)
    assert tcache2 is tcache                    # written in place
    np.testing.assert_allclose(to.numpy(), _np(jo), **ATTN_TOL)
    idx = np.array([5, 3], np.int32)
    x1 = rng.normal(0, 1, (b, 1, d)).astype(np.float32)
    jo, jcache = jL.apply_attention(
        jp, jnp.asarray(x1), jc, positions=jnp.asarray(idx[:, None]),
        cache=jcache, cache_index=jnp.asarray(idx),
        kv_len_valid=jnp.asarray(idx + 1))
    to, _ = tL.apply_attention(tp, _t(x1), tc, positions=_t(idx[:, None]),
                               cache=tcache, cache_index=_t(idx),
                               kv_len_valid=_t(idx + 1))
    np.testing.assert_allclose(to.numpy(), _np(jo), **ATTN_TOL)
    for key in ("k", "ks", "v", "vs"):
        assert tcache[key].dtype == (torch.int8 if key in "kv"
                                     else torch.float32)
        assert np.array_equal(tcache[key].numpy(), _np(jcache[key])), key


def test_int8_cache_write_overrunning_the_end_is_clamped():
    """A scalar start past ``max_len - sq`` lands where
    ``lax.dynamic_update_slice`` puts it, for the codes and the scales."""
    jc, tc = _cfgs("internlm2-1.8b")
    p = _attn_params(tc, seed=1)
    jp, tp = jax.tree.map(jnp.asarray, p), convert.from_numpy_tree(p, "cpu")
    x = np.random.default_rng(6).normal(0, 1, (1, 3, tc.d_model)) \
        .astype(np.float32)
    pos = np.arange(6, 9, dtype=np.int32)
    _, jcache = jL.apply_attention(jp, jnp.asarray(x), jc,
                                   positions=jnp.asarray(pos),
                                   cache=jL.init_kv_cache(jc, 1, 8),
                                   cache_index=6)
    _, tcache = tL.apply_attention(tp, _t(x), tc, positions=_t(pos),
                                   cache=tL.init_kv_cache(tc, 1, 8),
                                   cache_index=6)
    for key in ("k", "ks", "v", "vs"):
        assert np.array_equal(tcache[key].numpy(), _np(jcache[key])), key


# ---------------------------------------------------------------------------
# the decoder-only families: prefill + decode, plan with plan
# ---------------------------------------------------------------------------

LMS = {"internlm2-1.8b": {},
       "granite-moe-3b-a800m": {"capacity_factor": MOE_CAPACITY}}


def _prefill_decode(eng, toks, max_len=32, jax_side=False):
    arr = jnp.asarray if jax_side else (lambda a: a)
    st = eng.init_decode_state(toks.shape[0], max_len)
    pre, st = eng.prefill(arr(toks[:, :-1]), st)
    dec, st = eng.decode_step(arr(toks[:, -1]), st)
    fwd = eng.forward(arr(toks))[:, -1]
    return [np.asarray(a) for a in (pre, dec, fwd)], st


@pytest.mark.parametrize("name", list(LMS))
@pytest.mark.parametrize("plan", list(PLANS))
def test_int8_cache_prefill_decode_match_reference_plan(name, plan):
    je, te = _engines(name, plan, **LMS[name])
    toks = _tokens(te.cfg)
    (jpre, jdec, jfwd), js = _prefill_decode(je, toks, jax_side=True)
    (tpre, tdec, tfwd), ts = _prefill_decode(te, toks)
    assert ts["index"] == toks.shape[1]
    layers = ts["layers"]
    assert sorted(layers) == ["k", "ks", "v", "vs"]
    assert layers["k"].dtype == torch.int8 and \
        layers["ks"].dtype == torch.float32
    _check(tpre, jpre, plan, f"{name} {plan} prefill")
    _check(tdec, jdec, plan, f"{name} {plan} decode_step")
    if plan != "float":                    # the codes and scales written
        for key in layers:
            assert np.array_equal(layers[key].numpy(),
                                  _np(js["layers"][key])), key
    # decode against forward: the reference's own gap on the same plan
    gap, agree = _gap(tdec, tfwd)
    jgap, jagree = _gap(jdec, jfwd)
    assert agree and jagree
    assert abs(gap - jgap) < GAP_ATOL, (gap, jgap)
    assert 0 < gap < 0.2


def test_int8_cache_sits_in_int8_on_the_integer_plans():
    """``Engine.init_decode_state`` asks for the float32 cache of the
    integer plans (``transformer.kv_dtype``); the int8 cache ignores the
    dtype, as in the reference, and decodes into the activations'."""
    _, te = _engines("internlm2-1.8b", "cuda")
    st = te.init_decode_state(3, 10)
    codes = (te.cfg.n_layers, 3, 10, te.cfg.n_kv_heads,
             te.cfg.resolved_head_dim)
    assert tuple(st["layers"]["k"].shape) == codes
    assert tuple(st["layers"]["vs"].shape) == codes[:4]
    assert float(st["layers"]["ks"].min()) == 1.0
    int8 = sum(t.numel() for t in tree_leaves(st["layers"])
               if t.dtype == torch.int8)
    assert int8 == 2 * int(np.prod(codes))


def test_int8_merge_decode_state_selects_scales_per_lane():
    _, te = _engines("internlm2-1.8b", "float")
    old, new = te.init_decode_state(2, 8), te.init_decode_state(2, 8)
    new["layers"]["k"] += 3
    new["layers"]["ks"] *= 0.5
    merged = TT.merge_decode_state(old, new, np.array([False, True]))
    assert merged["index"].tolist() == [0, 0]
    assert merged["layers"]["k"].dtype == torch.int8
    assert float(merged["layers"]["ks"][:, 0].min()) == 1.0
    assert float(merged["layers"]["ks"][:, 1].max()) == 0.5
    assert int(merged["layers"]["k"][:, 1].min()) == 3
    merged["layers"]["vs"] += 1                       # no alias
    assert float(new["layers"]["vs"].max()) == 1.0


def _requests(cfg, n, seed):
    rng = np.random.RandomState(seed)
    return [(i, rng.randint(0, cfg.vocab_size, size=rng.randint(2, 12)),
             int(rng.randint(3, 10))) for i in range(n)]


@pytest.mark.parametrize("plan", ["lut", "cuda"])
def test_int8_cache_scheduler_emits_the_reference_schedulers_tokens(plan):
    """Continuous batching on the int8 cache: 5 requests on 2 slots (joins
    into freed lanes, evictions at their budgets, the per-lane scatter of
    codes and scales), the port's scheduler and the reference's on the
    same weights emit the same tokens."""
    je, te = _engines("internlm2-1.8b", plan)
    reqs = _requests(te.cfg, 5, seed=3)
    js = jcell.LMScheduler(je, slots=2, max_len=32, prefill_len=16)
    ts = cellmod.LMScheduler(te, slots=2, max_len=32, prefill_len=16)
    for rid, p, g in reqs:
        js.submit(rid, p, g)
        ts.submit(rid, p, g)
    out = ts.run()
    assert out == js.run()
    assert {rid: len(t) for rid, t in out.items()} == \
        {rid: g for rid, _, g in reqs}
    assert ts.state["layers"]["ks"].dtype == torch.float32


def test_int8_cache_scheduler_join_leaves_residents_alone():
    """A join mid-decode merges the joiner's fresh codes and scales into
    its lane only: the resident lane's tokens are those of a solo run."""
    _, te = _engines("internlm2-1.8b", "float")
    reqs = _requests(te.cfg, 2, seed=4)
    solo = cellmod.LMScheduler(te, slots=2, max_len=64, prefill_len=16)
    solo.submit(0, reqs[0][1], reqs[0][2])
    want = solo.run()[0]
    s = cellmod.LMScheduler(te, slots=2, max_len=64, prefill_len=16)
    s.submit(0, reqs[0][1], reqs[0][2])
    out, n = {}, 0
    while not s.idle():
        if n == 2:
            s.submit(1, reqs[1][1], reqs[1][2])
        for ev in s.step():
            out.setdefault(ev.rid, []).append(ev.token)
        n += 1
    assert out[0] == want and len(out[1]) == reqs[1][2]


# ---------------------------------------------------------------------------
# hybrid: the int8 ring cache
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("plan", list(PLANS))
def test_int8_ring_prefill_within_the_window_matches_reference(plan):
    """A prompt of 7 tokens into the ring of 8, one decode step (the
    window's 8 tokens): against the reference's plan, and decode against
    forward as the reference's own gap."""
    je, te = _engines("hymba-1.5b", plan)
    toks = _tokens(te.cfg, s=HYMBA_W)
    (jpre, jdec, jfwd), js = _prefill_decode(je, toks, jax_side=True)
    (tpre, tdec, tfwd), ts = _prefill_decode(te, toks)
    ring = ts["layers"]["kv"]
    assert sorted(ring) == ["k", "ks", "v", "vs"]
    assert ring["k"].dtype == torch.int8 and ring["k"].shape[2] == HYMBA_W
    _check(tpre, jpre, plan, f"hymba {plan} prefill")
    _check(tdec, jdec, plan, f"hymba {plan} decode_step")
    gap, agree = _gap(tdec, tfwd)
    jgap, jagree = _gap(jdec, jfwd)
    assert agree and jagree
    assert abs(gap - jgap) < GAP_ATOL, (gap, jgap)


@pytest.mark.parametrize("plan", list(PLANS))
def test_int8_ring_decode_across_the_wrap_matches_reference(plan):
    """20 tokens decoded one at a time into the int8 ring of 8 slots
    (wrapping twice), against the reference's decode on the same plan."""
    je, te = _engines("hymba-1.5b", plan)
    toks = _tokens(te.cfg, s=20, seed=4)
    st, jst = te.init_decode_state(2, 64), je.init_decode_state(2, 64)
    outs, jouts = [], []
    for t in range(20):
        lg, st = te.decode_step(toks[:, t], st)
        jlg, jst = je.decode_step(jnp.asarray(toks[:, t]), jst)
        outs.append(lg.numpy())
        jouts.append(np.asarray(jlg))
    _check(np.stack(outs, 1), np.stack(jouts, 1), plan,
           f"hymba {plan} int8 ring decode")
    if plan != "float":
        for key in ("k", "ks", "v", "vs"):
            assert np.array_equal(st["layers"]["kv"][key].numpy(),
                                  _np(jst["layers"]["kv"][key])), key


# ---------------------------------------------------------------------------
# whisper: the decoder self cache in int8, the cross caches float
# ---------------------------------------------------------------------------

WHISPER_PLANS = {"float": "float", "lut": "lut", "cuda": "pallas"}


def _whisper_params(jcfg, seed=0):
    shapes = jax.eval_shape(lambda k: JE.init_params(jcfg, k),
                            jax.random.PRNGKey(0))
    rng = np.random.default_rng(seed)

    def leaf(path, s):
        names = [getattr(k, "key", "") for k in path]
        per = s.shape[1:] if names[0] in ("enc_blocks", "dec_blocks") \
            else s.shape
        if "scale" in names:
            return rng.normal(1.0, 0.1, s.shape).astype(np.float32)
        scale = 1.0 / np.sqrt(per[0]) if len(per) > 1 else 0.1
        return rng.normal(0, scale, s.shape).astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


@pytest.mark.parametrize("plan", list(WHISPER_PLANS))
def test_whisper_int8_self_cache_matches_reference_plan(plan):
    """``encdec.prefill`` / ``decode_step`` at module level under each
    plan's ``exec_cfg`` (the reference's kernels in interpret mode, its
    layers unrolled as the port's): the self cache in int8 codes and
    float32 scales, the cross caches in the model dtype, logits plan with
    plan, and decode against ``decode_train`` as the reference's gap."""
    name = "whisper-large-v3"
    jcfg, tcfg = _cfgs(name)
    jcfg = jcfg.with_(scan_layers=False)
    npp = _whisper_params(jcfg)
    jp, tp = jax.tree.map(jnp.asarray, npp), convert.from_numpy_tree(npp,
                                                                     "cpu")
    jc = jbe.get_backend(WHISPER_PLANS[plan]).configure(jcfg, interpret=True)
    tc = tbe.get_backend(plan).configure(tcfg)
    rng = np.random.default_rng(1)
    b, s, max_len = 2, 6, 16
    frames = rng.normal(size=(b, tcfg.enc_seq, tcfg.d_model)) \
        .astype(np.float32)
    toks = rng.integers(0, tcfg.vocab_size, (b, s)).astype(np.int32)
    mem = JE.encode(jp, jnp.asarray(frames), jc)
    jfwd = np.asarray(JE.decode_train(jp, mem, jnp.asarray(toks), jc))[:, -1]
    jst = JE.init_decode_state(jc, b, max_len)
    jpre, jst = JE.prefill(jp, jnp.asarray(frames), jnp.asarray(toks[:, :-1]),
                           jc, jst)
    jdec, jst = JE.decode_step(jp, jnp.asarray(toks[:, -1]), jc, jst)
    with torch.inference_mode():
        tmem = TE.encode(tp, _t(frames), tc)
        tfwd = TE.decode_train(tp, tmem, _t(toks), tc)[:, -1].numpy()
        tst = TE.init_decode_state(tc, b, max_len, device="cpu")
        tpre, tst = TE.prefill(tp, _t(frames), _t(toks[:, :-1]), tc, tst)
        tdec, tst = TE.decode_step(tp, _t(toks[:, -1]), tc, tst)
    kv, cross = tst["layers"]["kv"], tst["layers"]["cross"]
    assert sorted(kv) == ["k", "ks", "v", "vs"] and sorted(cross) == ["k", "v"]
    assert kv["k"].dtype == torch.int8 and kv["vs"].dtype == torch.float32
    assert cross["k"].dtype == getattr(torch, tcfg.dtype)
    assert str(jst["layers"]["kv"]["k"].dtype) == "int8"
    atol = WHISPER_FLOAT_ATOL if plan == "float" else WHISPER_LUT_ATOL
    for got, want, what in ((tpre, jpre, "prefill"), (tdec, jdec, "decode")):
        np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=0,
                                   atol=atol, err_msg=f"{plan} {what}")
    gap, agree = _gap(tdec, tfwd)
    jgap, jagree = _gap(np.asarray(jdec), jfwd)
    assert agree == jagree
    assert abs(gap - jgap) < GAP_ATOL, (gap, jgap)


def test_decode_gap_tool_splits_the_int8_cache(capsys):
    """``tools/lm_decode_gap.py --kv8`` (the split run on the card) at
    smoke size: every plan on the int8 cache, each per-lane step equal to
    the scalar one; with both LUTs off at float32 activations the gap is
    the cache's own (0.0 with the float cache, tests/test_torch_lm_model),
    and it enters at the first layer."""
    path = pathlib.Path(__file__).resolve().parents[1] / "tools" / \
        "lm_decode_gap.py"
    spec = importlib.util.spec_from_file_location("lm_decode_gap", path)
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    assert tool.main(["--smoke", "--device", "cpu", "--kv8"]) == 0
    rows = {r["plan"]: r for r in map(json.loads,
                                      capsys.readouterr().out.splitlines())}
    assert len(rows) == 11
    assert all(r["kv8"] and r["per_lane_equal"] for r in rows.values())
    own = rows["lut softmax=exact silu=exact [float32]"]
    assert 1e-3 < own["rel"] < 0.1 and own["layers"][0] > 1e-3
    assert rows["cuda"]["argmax_equal"]

