"""The hybrid family in the port against the reference: softplus, the
selective scan and its naive oracle, the mamba branch with a carried conv
tail, banded (sliding-window) attention, the ring KV cache, and
hymba-1.5b's smoke config (window 8) under the port's ``float``, ``lut``
and ``cuda`` plans against the reference's ``float``, ``lut`` and
``pallas`` plans (the ``cuda`` plan through its kernels' plain versions
on the CPU, the reference's in interpret mode), on the same numpy weights
and tokens.

Tolerances, beside what was measured on the CPU (PERF.md §6):

* ``softplus``: rtol and atol 1e-6 in both modes.  Exact: ``F.softplus``
  against ``jax.nn.softplus`` (measured 9.5e-7 absolute on values up to
  30); LUT: the same table entry, whose ``log``
  PyTorch and XLA:CPU round one ulp apart at times (measured 2.4e-7);
  the branches above 8 and below -8 exact;
* the scans and the mamba branch: float32 ``cumsum`` / ``exp`` and the
  products round apart under PyTorch and XLA:CPU: rtol and atol 1e-4, the
  reference's own bound between its chunked scan and its naive oracle
  (measured at most 8.6e-6 absolute, scans; 1.0e-6, the mamba branch);
* banded attention: exact softmax rtol and atol 1e-5 (measured 3.6e-7);
  the LUT softmax 1e-3, since a score one ulp apart can take the
  neighbouring exp bin (measured 9.4e-5);
* the model's logits: ``float`` atol 1e-4 (measured 3.0e-6), ``lut`` and
  ``cuda`` bit-equal (measured 0.0: no ulp moved an eq-9 code of the
  head's input; one that did would move a logit by one input step of the
  head, ``max|W_head| * 2^-5``);
* decode == forward within the reference's rel 1e-4
  (``tests/test_models.py``), ring decode across the wrap included.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import runtime as jrt
from repro.configs import registry as jregistry
from repro.core import approx as japprox
from repro.models import layers as JL
from repro.models import ssm as JS
from repro.models import transformer as JT
from repro_torch import runtime as trt
from repro_torch.configs import registry as tregistry
from repro_torch.core import approx as tapprox
from repro_torch.models import layers as TL
from repro_torch.models import ssm as TS
from repro_torch.models import transformer as TT

from test_torch_rwkv import PLANS, _Casts, _check, np_params

torch.set_num_threads(1)

NAME = "hymba-1.5b"
W = 8                          # the smoke config's window
SOFTPLUS_TOL = 1e-6
SCAN_TOL = 1e-4
SDPA_TOL = {"exact": 1e-5, "lut": 1e-3}
DECODE_REL = 1e-4
# prefill of a prompt longer than the window, then one decode step,
# against forward: the ring cache is empty (C10); measured 0.98-1.02 on
# the three plans here (the reference's own gap on its smoke weights: 1.10)
C10_MIN_GAP = 0.5


def _cfgs(**kw):
    return (jregistry.get(NAME).smoke.with_(**kw),
            tregistry.get(NAME).smoke.with_(**kw))


def _setup(seed=0, **kw):
    from repro_torch import convert
    jcfg, tcfg = _cfgs(**kw)
    npp = np_params(jcfg, seed)
    return jcfg, tcfg, jax.tree.map(jnp.asarray, npp), \
        convert.from_numpy_tree(npp, "cpu")


def _tokens(cfg, b=2, s=7, seed=1):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (b, s)).astype(np.int32)


def _compile(tcfg, tp, plan, **kw):
    return trt.compile_model(tcfg, tp, backend=plan, device="cpu",
                             plain_kernels=plan == "cuda", **kw)


def _close(got, want, tol, what):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=tol,
                               atol=tol, err_msg=what)


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / np.abs(b).max())


# ---------------------------------------------------------------------------
# softplus
# ---------------------------------------------------------------------------

def _softplus_inputs():
    rng = np.random.default_rng(0)
    edges = np.array([-30, -8.001, -8, -7.999, -0.5, 0, 0.5, 7.999, 8,
                      8.001, 30], np.float32)
    return np.concatenate([edges, rng.normal(0, 6, 4096).astype(np.float32)])


@pytest.mark.parametrize("mode", ["exact", "lut", "cuda"])
def test_softplus_matches_reference(mode):
    """Exact: F.softplus; every other mode (``cuda`` takes the LUT, as the
    reference's ``pallas`` does): x above 8, -log(sigmoid LUT(-x)) below,
    so exactly 0 under -8."""
    x = _softplus_inputs()
    jmode = {"exact": "exact", "lut": "lut", "cuda": "pallas"}[mode]
    want = np.asarray(japprox.softplus(jnp.asarray(x), mode=jmode))
    got = tapprox.softplus(torch.from_numpy(x), mode=mode).numpy()
    assert got.dtype == np.float32
    if mode == "exact":
        _close(got, want, SOFTPLUS_TOL, "exact softplus")
    else:
        _close(got, want, SOFTPLUS_TOL, "LUT softplus")
        assert (got[x < -8] == 0.0).all()
        assert np.array_equal(got[x > 8], x[x > 8])


# ---------------------------------------------------------------------------
# the selective scan
# ---------------------------------------------------------------------------

def _scan_inputs(b, s, d, n, seed=0):
    rng = np.random.default_rng(seed)
    delta = np.log1p(np.exp(rng.normal(size=(b, s, d)))).astype(np.float32)
    xin = rng.normal(size=(b, s, d)).astype(np.float32)
    bt = rng.normal(size=(b, s, n)).astype(np.float32)
    C = rng.normal(size=(b, s, n)).astype(np.float32)
    A = -np.exp(rng.normal(size=(d, n))).astype(np.float32)
    h0 = (rng.normal(size=(b, d, n)) * 0.5).astype(np.float32)
    return delta, xin, bt, C, A, h0


@pytest.mark.parametrize("form", ["la_dbx", "delta_xin"])
def test_mamba_chunk_body_matches_reference(form):
    """Both chunk forms, with a carried state."""
    delta, xin, bt, C, A, h0 = _scan_inputs(2, 16, 8, 4)
    if form == "la_dbx":
        la = delta[..., None] * A[None, None]
        dbx = (delta * xin)[..., None] * bt[:, :, None, :]
        chunk, a = {"la": la, "dbx": dbx, "C": C}, None
    else:
        chunk, a = {"delta": delta, "xin": xin, "bt": bt, "C": C}, A
    jh, jy = JS.mamba_chunk_body(jnp.asarray(h0),
                                 jax.tree.map(jnp.asarray, chunk),
                                 None if a is None else jnp.asarray(a))
    th, ty = TS.mamba_chunk_body(
        torch.from_numpy(h0), {k: torch.from_numpy(v) for k, v in
                               chunk.items()},
        None if a is None else torch.from_numpy(a))
    _close(ty, jy, SCAN_TOL, "y")
    _close(th, jh, SCAN_TOL, "h")


@pytest.mark.parametrize("s", [53, 7, 1])
def test_ssm_scan_matches_reference_and_naive(s):
    """Length 53: three full chunks and a tail of 5; S < CHUNK: one
    direct call (decode)."""
    delta, xin, bt, C, A, h0 = _scan_inputs(2, s, 8, 4, seed=s)
    jy, jh = JS.ssm_scan(*map(jnp.asarray, (delta, xin, bt, C, A, h0)))
    ty, th = TS.ssm_scan(*map(torch.from_numpy, (delta, xin, bt, C, A, h0)))
    _close(ty, jy, SCAN_TOL, "scan y")
    _close(th, jh, SCAN_TOL, "scan h")
    la = delta[..., None] * A[None, None]
    dbx = (delta * xin)[..., None] * bt[:, :, None, :]
    ny, nh = TS.ssm_naive(*map(torch.from_numpy, (la, dbx, C, h0)))
    jny, jnh = JS.ssm_naive(*map(jnp.asarray, (la, dbx, C, h0)))
    _close(ny, jny, SCAN_TOL, "naive y")
    _close(nh, jnh, SCAN_TOL, "naive h")
    _close(ty, ny, SCAN_TOL, "scan against naive y")
    _close(th, nh, SCAN_TOL, "scan against naive h")


@pytest.mark.parametrize("mode", ["exact", "lut"])
def test_apply_mamba_with_a_carried_tail_matches_reference(mode):
    """The mamba branch of layer 0 on 19 tokens after a carried state: the
    conv tail shifts into the causal conv, h into the scan; SiLU and
    softplus exact or the LUT."""
    jcfg, tcfg, jp, tp = _setup(act_approx=mode)
    rng = np.random.default_rng(2)
    d, n, kw = jcfg.d_model, jcfg.ssm_state, jcfg.conv_width
    x = rng.normal(size=(2, 19, d)).astype(np.float32)
    st = {"h": (rng.normal(size=(2, d, n)) * 0.5).astype(np.float32),
          "conv": rng.normal(size=(2, kw - 1, d)).astype(np.float32)}
    jb = jax.tree.map(lambda a: a[0], jp["blocks"]["mamba"])
    tb = {k: v[0] for k, v in tp["blocks"]["mamba"].items()}
    jo, js = JS.apply_mamba(jb, jnp.asarray(x), jcfg,
                            jax.tree.map(jnp.asarray, st))
    to, ts = TS.apply_mamba(tb, torch.from_numpy(x), tcfg,
                            {k: torch.from_numpy(v) for k, v in st.items()})
    _close(to, jo, SCAN_TOL, "out")
    _close(ts["h"], js["h"], SCAN_TOL, "h")
    assert np.array_equal(ts["conv"].numpy(), np.asarray(js["conv"]))
    # the new tail is the last kw - 1 inputs of the conv
    assert ts["conv"].shape == (2, kw - 1, d)


# ---------------------------------------------------------------------------
# banded attention
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("window", [8, 100])
@pytest.mark.parametrize("mode", ["exact", "lut"])
def test_banded_sdpa_over_query_chunks_matches_reference(window, mode):
    """600 queries (two chunks of ``Q_CHUNK``): each chunk takes the keys
    of its band only (``klo = q0 - W + 1``), and the band mask keeps
    ``kpos > qpos - W``; the same as the reference's, and as one unchunked
    block over all keys."""
    jcfg, tcfg = _cfgs(sliding_window=window, softmax_mode=mode)
    rng = np.random.default_rng(window)
    s, h, kv, dh = 600, jcfg.n_heads, jcfg.n_kv_heads, jcfg.resolved_head_dim
    q = rng.normal(size=(1, s, h, dh)).astype(np.float32)
    k, v = (rng.normal(size=(1, s, kv, dh)).astype(np.float32)
            for _ in range(2))
    want = JL.sdpa(*map(jnp.asarray, (q, k, v)), jcfg, q_offset=0,
                   kv_len_valid=None)
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    got = TL.sdpa(tq, tk, tv, tcfg)
    _close(got, want, SDPA_TOL[mode], "banded sdpa")
    whole = TL._sdpa_block(tq, tk, tv, tcfg, q0=0, k0=0, q_offset=0,
                           kv_len_valid=None, causal=True)
    _close(got, whole, SDPA_TOL[mode], "chunked against one block")


# ---------------------------------------------------------------------------
# the model against the reference's plans
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("plan", list(PLANS))
def test_hybrid_plan_matches_reference_plan(plan):
    """forward over 12 tokens (beyond the window: banded), prefill of 6
    tokens into a ring of 8, one decode step."""
    jcfg, tcfg, jp, tp = _setup()
    toks = _tokens(tcfg, s=12)
    je = jrt.compile_model(jcfg, jp, backend=PLANS[plan])
    te = _compile(tcfg, tp, plan)
    assert te.int_exec == je.int_exec
    _check(te.forward(toks).numpy(), je.forward(jnp.asarray(toks)), plan,
           f"{plan} forward")
    js = je.init_decode_state(2, 32)
    jl, js = je.prefill(jnp.asarray(toks[:, :6]), js)
    jd, js = je.decode_step(jnp.asarray(toks[:, 6]), js)
    ts = te.init_decode_state(2, 32)
    assert ts["layers"]["kv"]["k"].shape[2] == W      # min(max_len, W)
    tl, ts = te.prefill(toks[:, :6], ts)
    td, ts = te.decode_step(toks[:, 6], ts)
    assert ts["index"] == 7
    _check(tl.numpy(), jl, plan, f"{plan} prefill")
    _check(td.numpy(), jd, plan, f"{plan} decode_step")
    np.testing.assert_allclose(ts["layers"]["mamba"]["h"].numpy(),
                               np.asarray(js["layers"]["mamba"]["h"]),
                               rtol=SCAN_TOL, atol=SCAN_TOL)


@pytest.mark.parametrize("plan", list(PLANS))
def test_ring_decode_across_the_wrap(plan):
    """The reference's own check, in the port, on every plan: 20 tokens
    decoded one at a time into a ring of 8 slots (wrapping twice) against
    the forward, and against the reference's decode."""
    jcfg, tcfg, jp, tp = _setup(seed=3)
    toks = _tokens(tcfg, s=20, seed=4)
    eng = _compile(tcfg, tp, plan)
    je = jrt.compile_model(jcfg, jp, backend=PLANS[plan])
    state = eng.init_decode_state(2, 64)
    jstate = je.init_decode_state(2, 64)
    outs, jouts = [], []
    for t in range(20):
        lg, state = eng.decode_step(toks[:, t], state)
        jlg, jstate = je.decode_step(jnp.asarray(toks[:, t]), jstate)
        outs.append(lg)
        jouts.append(np.asarray(jlg))
    dec = torch.stack(outs, 1)
    assert _rel(dec, eng.forward(toks)) < DECODE_REL
    _check(dec.numpy(), np.stack(jouts, 1), plan, f"{plan} ring decode")


@pytest.mark.parametrize("plan", list(PLANS))
@pytest.mark.parametrize("prompt", [3, 7])
def test_prefill_within_the_window_then_decode_matches_forward(plan, prompt):
    """A causal chunk of ``prompt <= W`` tokens into the ring, then decode
    steps past the wrap, against the forward."""
    _, tcfg, _, tp = _setup(seed=2)
    eng = _compile(tcfg, tp, plan)
    toks = _tokens(tcfg, s=prompt + 6, seed=5)
    ref = eng.forward(toks)
    state = eng.init_decode_state(2, 64)
    lg, state = eng.prefill(toks[:, :prompt], state)
    outs = [lg]
    for t in range(prompt, toks.shape[1]):
        lg, state = eng.decode_step(toks[:, t], state)
        outs.append(lg)
    assert _rel(torch.stack(outs, 1), ref[:, prompt - 1:]) < DECODE_REL


@pytest.mark.parametrize("plan", list(PLANS))
def test_long_prompt_leaves_the_ring_empty_as_the_reference(plan):
    """ROADMAP C10: a prompt longer than the window runs banded attention
    and threads the mamba state, but does not fill the ring, so the
    decode steps after it attend zero slots marked valid.  Specification:
    the port equals the reference there, not the forward."""
    jcfg, tcfg, jp, tp = _setup(seed=6)
    toks = _tokens(tcfg, s=13, seed=7)
    eng = _compile(tcfg, tp, plan)
    je = jrt.compile_model(jcfg, jp, backend=PLANS[plan])
    state = eng.init_decode_state(2, 64)
    lg, state = eng.prefill(toks[:, :12], state)
    assert state["index"] == 12
    assert float(state["layers"]["kv"]["k"].abs().max()) == 0.0
    assert float(state["layers"]["mamba"]["h"].abs().max()) > 0.0
    dec, _ = eng.decode_step(toks[:, 12], state)
    js = je.init_decode_state(2, 64)
    jl, js = je.prefill(jnp.asarray(toks[:, :12]), js)
    jd, _ = je.decode_step(jnp.asarray(toks[:, 12]), js)
    _check(lg.numpy(), jl, plan, f"{plan} long prefill")
    _check(dec.numpy(), jd, plan, f"{plan} decode after a long prefill")
    # the prefill's own logits are the forward's (banded); the decode's not
    fwd = eng.forward(toks)
    assert _rel(lg, fwd[:, 11]) < DECODE_REL
    assert _rel(dec, fwd[:, 12]) > C10_MIN_GAP


@pytest.mark.parametrize("plan", ["float", "cuda"])
def test_chunk_past_the_ring_end_is_placed_as_the_reference(plan):
    """A second prompt chunk that would run past the ring's end (index 5,
    4 tokens, 8 slots): the reference's ``lax.dynamic_update_slice``
    clamps its start to 4, and the port's cache write does the same."""
    jcfg, tcfg, jp, tp = _setup(seed=8)
    toks = _tokens(tcfg, s=10, seed=9)
    eng = _compile(tcfg, tp, plan)
    je = jrt.compile_model(jcfg, jp, backend=PLANS[plan])
    ts, js = eng.init_decode_state(2, 64), je.init_decode_state(2, 64)
    _, ts = eng.prefill(toks[:, :5], ts)
    _, js = je.prefill(jnp.asarray(toks[:, :5]), js)
    tl, ts = eng.prefill(toks[:, 5:9], ts)
    jl, js = je.prefill(jnp.asarray(toks[:, 5:9]), js)
    _check(tl.numpy(), jl, plan, "clamped chunk")
    np.testing.assert_allclose(ts["layers"]["kv"]["k"].numpy(),
                               np.asarray(js["layers"]["kv"]["k"]),
                               rtol=SCAN_TOL, atol=SCAN_TOL)
    td, _ = eng.decode_step(toks[:, 9], ts)
    jd, _ = je.decode_step(jnp.asarray(toks[:, 9]), js)
    _check(td.numpy(), jd, plan, "decode after the clamped chunk")


def test_per_lane_index_raises_as_in_the_reference():
    _, tcfg, _, tp = _setup()
    eng = _compile(tcfg, tp, "float")
    a = eng.prefill(_tokens(tcfg), eng.init_decode_state(2, 16))[1]
    merged = TT.merge_decode_state(a, a, np.array([True, False]))
    assert merged["layers"]["kv"]["k"].shape == a["layers"]["kv"]["k"].shape
    with pytest.raises(ValueError, match="hybrid ring caches"):
        eng.decode_step(np.zeros(2, np.int32), merged)


# ---------------------------------------------------------------------------
# dtypes: C6 and C9
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype,plan,cast_acts", [
    ("float32", "float", False), ("float32", "cuda", False),
    ("bfloat16", "float", False), ("bfloat16", "lut", True),
    ("bfloat16", "cuda", True)])
def test_block_output_cast_is_a_no_op_where_the_reference_runs(
        dtype, plan, cast_acts, monkeypatch):
    """ROADMAP C9: the mean of the two branches is cast to the residual's
    dtype.  Where the reference runs it already has it; on a bf16 integer
    plan the mamba branch comes out float32 and the cast keeps the
    residual stream bf16."""
    _, tcfg = _cfgs(dtype=dtype)
    tp = TT.init_params(tcfg, torch.Generator().manual_seed(0), "cpu")
    eng = _compile(tcfg, tp, plan)
    casts = _Casts(monkeypatch)
    logits = eng.forward(_tokens(tcfg))
    assert len(casts.pairs) == tcfg.n_layers
    assert casts.acted() == cast_acts
    assert bool(torch.isfinite(logits.float()).all())


@pytest.mark.parametrize("plan", ["lut", "cuda"])
def test_bf16_integer_plan_serves_where_the_reference_raises(plan):
    """ROADMAP C6 and C9 for hymba: the reference's ring-cache write
    (``lax.dynamic_update_slice``) refuses the float32 keys of its float32
    block view against a bf16 cache.  The port keeps the ring cache and
    the conv tail in float32 (``transformer.kv_dtype``: what the blocks
    compute them in) and casts the block's output back: prefill and ring
    decode past the wrap equal the forward within the reference's rel
    1e-4 (measured 0.0; a bf16 conv tail, the reference's rounding, read
    1.4-2.3 % and flipped a greedy token)."""
    jcfg, tcfg = _cfgs(dtype="bfloat16")
    jp = JT.init_params(jcfg, jax.random.PRNGKey(0))
    toks = _tokens(tcfg, s=12)
    je = jrt.compile_model(jcfg, jp, backend=PLANS[plan])
    with pytest.raises(TypeError, match="dynamic_update_slice"):
        je.prefill(jnp.asarray(toks[:, :6]), je.init_decode_state(2, 16))
    tp = TT.init_params(tcfg, torch.Generator().manual_seed(0), "cpu")
    eng = _compile(tcfg, tp, plan)
    state = eng.init_decode_state(2, 16)
    assert state["layers"]["kv"]["k"].dtype == torch.float32
    assert state["layers"]["mamba"]["conv"].dtype == torch.float32
    lg, state = eng.prefill(toks[:, :6], state)
    outs = [lg]
    for t in range(6, 12):
        lg, state = eng.decode_step(toks[:, t], state)
        outs.append(lg)
    dec = torch.stack(outs, 1).float()
    ref = eng.forward(toks)[:, 5:].float()
    assert bool(torch.isfinite(dec).all())
    assert torch.equal(dec.argmax(-1), ref.argmax(-1))
    assert _rel(dec, ref) < DECODE_REL
