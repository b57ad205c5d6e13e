"""The small LM leftovers of the port against the reference: the bf16
exact-softmax branch (``scores_dtype="bfloat16"``), ``matmul_unrolled``
and its price, the stochastic-rounding key of ``quantize_po2`` and the
surgeon's CLI.  The same numpy inputs and weights go through both
packages, on ``device="cpu"``.

Tolerances, beside what was measured on this host (PERF.md §6):

* ``masked_softmax`` on bf16 scores: bit-equal (measured 0.0: the same
  bf16 roundings step for step); its gradient within ``BF16_GRAD_ATOL``
  2^-5 of the largest (measured 2^-7 passes here too);
* the smoke forwards (dense, moe, hybrid, encdec) with bf16 scores on
  ``float``, against the reference's layers unrolled and run op by op
  (``scan_layers=False``, see C14 below): ``BF16_LOGITS_ATOL`` 1e-3 on
  logits of scale ~4 (measured at most 1.1e-5; float32 order noise
  upstream of a bf16 rounding can move it a bf16 ulp);
* one loss (internlm2 smoke, bf16 scores) within ``BF16_LOSS_ATOL`` 1e-5
  (measured 4.8e-7) and its gradients within ``BF16_GRAD_ATOL`` 2^-5 of
  each leaf's largest (measured 1.3e-2: the backward's bf16 products
  round in another order in each package);
* ROADMAP C14: compiled by XLA:CPU (under ``jax.jit`` or the layers'
  ``lax.scan``), the reference drops the bf16 rounding of the softmax's
  last product where the probabilities feed P·V as float32, so its
  scanned logits sit ``C14_SCANNED_ATOL`` 0.05 from its own unrolled ones
  (measured 0.0175);
* ``matmul_unrolled`` over integer grids, the stochastic codes and the
  ablation order: exact.
"""

import importlib

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.configs import registry as jregistry
from repro.core import approx as japprox
from repro.core import quant as jquant
from repro.models import encdec as JE
from repro.models import kwt as jkwt
from repro.models import transformer as JT
from repro.tools import surgeon as jsurgeon
from repro_torch import convert
from repro_torch.configs import registry as tregistry
from repro_torch.core import approx as tapprox
from repro_torch.core import quant as tquant
from repro_torch.core.tree import tree_leaves_sorted
from repro_torch.data import prng
from repro_torch.launch import steps as tsteps
from repro_torch.models import encdec as TE
from repro_torch.models import transformer as TT
from repro_torch.perf import cost as tcost
from repro_torch.tools import surgeon as tsurgeon

torch.set_num_threads(1)

BF16_LOGITS_ATOL = 1e-3
BF16_LOSS_ATOL = 1e-5
BF16_GRAD_ATOL = 2.0 ** -5
C14_SCANNED_ATOL = 0.05

_lm_model = importlib.import_module("test_torch_lm_model")
_encdec = importlib.import_module("test_torch_encdec")


def _bf16_np(a):
    return np.asarray(a, np.float32).astype(ml_dtypes.bfloat16)


def _scores(shape, seed=0, scale=3.0):
    return _bf16_np(np.random.default_rng(seed).normal(0, scale, shape))


def _masks(shape, seed=1):
    rng = np.random.default_rng(seed)
    causal = np.tril(np.ones(shape[-2:], bool))
    ragged = rng.random(shape) > 0.4
    ragged[..., 0, :] = False                  # a fully masked row
    ragged[..., 1, :] = False
    ragged[..., 1, 3] = True                   # a row of one key
    return {"none": None, "causal": np.broadcast_to(causal, shape).copy(),
            "ragged": ragged}


def _to_t(a):
    if a is None:
        return None
    if a.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def _np(t):
    return t.detach().to(torch.float32).numpy()


# ---------------------------------------------------------------------------
# the bf16 exact-softmax branch
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mask", ["none", "causal", "ragged"])
@pytest.mark.parametrize("shape", [(3, 9, 9), (2, 2, 17, 33)])
def test_bf16_masked_softmax_bit_equal(shape, mask):
    s = _scores(shape)
    m = _masks(shape)[mask]
    want = japprox.masked_softmax(jnp.asarray(s),
                                  None if m is None else jnp.asarray(m))
    got = tapprox.masked_softmax(_to_t(s), _to_t(m))
    assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
    assert np.array_equal(_np(got), np.asarray(want).astype(np.float32))
    if mask == "ragged":                       # fully masked rows: zeros
        assert float(got[..., 0, :].abs().max()) == 0.0
        assert float(got[..., 1, 3].min()) == 1.0


@pytest.mark.parametrize("mode", ["lut", "lut_fixed"])
def test_bf16_scores_cast_to_float32_in_lut_modes(mode):
    """Only ``exact`` keeps bf16: the LUT modes cast to float32 first, as
    the reference's do, and equal their float32 run on the same values."""
    s = _scores((2, 5, 12))
    m = _masks((2, 5, 12))["causal"]
    got = tapprox.masked_softmax(_to_t(s), _to_t(m), mode=mode)
    want = tapprox.masked_softmax(_to_t(s).float(), _to_t(m), mode=mode)
    assert got.dtype == torch.float32 and torch.equal(got, want)


def test_bf16_masked_softmax_gradient():
    """The branch differentiates (the training path reaches it): the
    gradient of a weighted sum against ``jax.grad`` of the reference's."""
    shape = (2, 7, 11)
    s = _scores(shape, seed=3)
    m = _masks(shape)["causal"]
    w = np.random.default_rng(4).normal(size=shape).astype(np.float32)

    def jloss(v):
        return jnp.sum(japprox.masked_softmax(v, jnp.asarray(m))
                       .astype(jnp.float32) * w)

    jg = np.asarray(jax.grad(jloss)(jnp.asarray(s))).astype(np.float32)
    ts = _to_t(s).requires_grad_(True)
    loss = (tapprox.masked_softmax(ts, _to_t(m)).float()
            * torch.from_numpy(w)).sum()
    (tg,) = torch.autograd.grad(loss, ts)
    assert tg.dtype == torch.bfloat16
    scale = float(np.abs(jg).max())
    assert scale > 0
    np.testing.assert_allclose(_np(tg), jg, rtol=0,
                               atol=BF16_GRAD_ATOL * scale)
    assert float(tg[~_to_t(m)].abs().max()) == 0.0


# ---------------------------------------------------------------------------
# bf16 scores through the models
# ---------------------------------------------------------------------------

def _bf16_cfgs(name, scan_layers=False):
    """The smoke configs with bf16 scores; the reference's layers unrolled
    unless ``scan_layers`` (C14)."""
    return (jregistry.get(name).smoke.with_(scores_dtype="bfloat16",
                                            scan_layers=scan_layers),
            tregistry.get(name).smoke.with_(scores_dtype="bfloat16"))


def _close(got, want, atol, what):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape, what
    assert np.isfinite(got).all(), what
    np.testing.assert_allclose(got, want, rtol=0, atol=atol, err_msg=what)


@pytest.mark.parametrize("name", ["internlm2-1.8b", "granite-moe-3b-a800m",
                                  "hymba-1.5b"])
def test_bf16_scores_forward_matches_reference(name):
    jcfg, tcfg = _bf16_cfgs(name)
    npp = _lm_model.np_params(jcfg)
    jp = jax.tree.map(jnp.asarray, npp)
    tp = convert.from_numpy_tree(npp, "cpu")
    toks = _lm_model._tokens(tcfg, b=2, s=16)
    want = JT.forward(jp, jnp.asarray(toks), jcfg)
    with torch.inference_mode():
        got = TT.forward(tp, torch.from_numpy(toks), tcfg)
        f32 = TT.forward(tp, torch.from_numpy(toks),
                         tcfg.with_(scores_dtype="float32"))
    _close(got, want, BF16_LOGITS_ATOL, f"{name} bf16-score logits")
    # the branch is taken: bf16 scores move the logits off the float32 ones
    assert not torch.equal(got, f32)
    # C14: the scanned (compiled) reference within its own dropped rounding
    jscan, _ = _bf16_cfgs(name, scan_layers=True)
    _close(got, JT.forward(jp, jnp.asarray(toks), jscan), C14_SCANNED_ATOL,
           f"{name} bf16-score logits, scanned reference")


def test_reference_compiled_bf16_softmax_drops_a_rounding():
    """ROADMAP C14, pinned: the reference's bf16 branch under ``jax.jit``,
    cast to float32 as P·V takes it, is the UNROUNDED float32 product of
    the bf16 ``p`` and the bf16 reciprocal; op by op it is that product
    rounded to bf16, which the port computes, under any caller."""
    s = jnp.asarray(_scores((4, 16, 33)))
    m = jnp.asarray(np.tril(np.ones((16, 33), bool)))

    def to_f32(v, mk):
        return japprox.masked_softmax(v, mk).astype(jnp.float32)

    eager = np.asarray(to_f32(s, m))
    compiled = np.asarray(jax.jit(to_f32)(s, m))
    ported = _np(tapprox.masked_softmax(_to_t(np.asarray(s)),
                                        _to_t(np.asarray(m))))
    assert np.array_equal(ported, eager)
    assert not np.array_equal(compiled, eager)
    assert np.abs(compiled - eager).max() <= 2.0 ** -8


def test_bf16_scores_encdec_matches_reference():
    jcfg, tcfg = (c.with_(scores_dtype="bfloat16") for c in _encdec._cfgs())
    npp = _encdec.np_params(jcfg)
    jp = jax.tree.map(jnp.asarray, npp)
    tp = convert.from_numpy_tree(npp, "cpu")
    frames, toks = _encdec._inputs(tcfg)
    jm = JE.encode(jp, jnp.asarray(frames), jcfg)
    jl = JE.decode_train(jp, jm, jnp.asarray(toks), jcfg)
    with torch.inference_mode():
        tm = TE.encode(tp, torch.from_numpy(frames), tcfg)
        tl = TE.decode_train(tp, tm, torch.from_numpy(toks), tcfg)
    _close(tm, jm, BF16_LOGITS_ATOL, "whisper bf16-score memory")
    _close(tl, jl, BF16_LOGITS_ATOL, "whisper bf16-score logits")


def test_bf16_scores_loss_and_gradient_match_reference():
    jcfg, tcfg = _bf16_cfgs("internlm2-1.8b")
    npp = _lm_model.np_params(jcfg)
    jp = jax.tree.map(jnp.asarray, npp)
    tp = convert.from_numpy_tree(npp, "cpu")
    toks = _lm_model._tokens(tcfg, b=2, s=16)
    labels = np.random.default_rng(9).integers(
        0, tcfg.vocab_size, toks.shape).astype(np.int32)
    jl, jg = jax.value_and_grad(JT.loss_fn)(
        jp, {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels)},
        jcfg)
    tl, tg = tsteps.value_and_grad(
        lambda p, b: TT.loss_fn(p, b, tcfg), tp,
        {"tokens": torch.from_numpy(toks), "labels": torch.from_numpy(labels)})
    assert abs(float(tl) - float(jl)) <= BF16_LOSS_ATOL
    got, want = tree_leaves_sorted(tg), jax.tree.leaves(jg)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        w = np.asarray(w, np.float32)
        scale = max(float(np.abs(w).max()), 1e-12)
        _close(g, w, BF16_GRAD_ATOL * scale, "bf16-score loss gradient")


def test_float32_scores_path_unchanged():
    """``scores_dtype="float32"`` (every config) keeps the float32 path:
    the scores are float32 and the softmax's input is what it was."""
    seen = []
    real = tapprox.masked_softmax

    def spy(s, mask, mode="exact"):
        seen.append(s.dtype)
        return real(s, mask, mode)

    tcfg = tregistry.get("internlm2-1.8b").smoke
    assert tcfg.scores_dtype == "float32"
    tp = convert.from_numpy_tree(
        _lm_model.np_params(jregistry.get("internlm2-1.8b").smoke), "cpu")
    tapprox.masked_softmax = spy
    try:
        with torch.inference_mode():
            TT.forward(tp, torch.zeros((1, 4), dtype=torch.long), tcfg)
    finally:
        tapprox.masked_softmax = real
    assert seen and set(seen) == {torch.float32}


# ---------------------------------------------------------------------------
# matmul_unrolled and its price
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("m,k,n", [(5, 12, 2), (3, 1, 4), (2, 24, 12)])
def test_matmul_unrolled_bit_equal(m, k, n):
    rng = np.random.default_rng(m * k + n)
    xq = rng.integers(-128, 128, (2, m, k)).astype(np.float32)
    wi = rng.integers(-128, 128, (k, n)).astype(np.float32)
    want = np.asarray(jquant.matmul_unrolled(jnp.asarray(xq), jnp.asarray(wi),
                                             k))
    got = tquant.matmul_unrolled(torch.from_numpy(xq), torch.from_numpy(wi), k)
    assert np.array_equal(got.numpy(), want)
    assert torch.equal(got, torch.from_numpy(xq) @ torch.from_numpy(wi))
    assert tquant._SMALL_MACS == jquant._SMALL_MACS


def test_matmul_unrolled_priced_as_its_product():
    """A chain through ``matmul_unrolled`` costs 2·M·N·K matmul flops, as
    the one product it equals, and nothing of it lands elsewhere."""
    m, k, n = 6, 12, 2
    x = torch.randint(-8, 8, (m, k)).float()
    w = torch.randint(-8, 8, (k, n)).float()
    chain = tcost.program_cost(lambda a, b: tquant.matmul_unrolled(a, b, k),
                               x, w)
    product = tcost.program_cost(lambda a, b: a @ b, x, w)
    assert chain.matmul_flops == product.matmul_flops == 2 * m * n * k
    assert {op for _, op in chain.lines} == {"matmul"}


def test_int_exec_einsum_not_routed_through_the_chain():
    """ROADMAP C13: a contraction under ``_SMALL_MACS`` stays one product
    (no elementwise chain) and equals the reference's unrolled value."""
    rng = np.random.default_rng(0)
    w = rng.normal(0, 0.3, (12, 2)).astype(np.float32)
    x = rng.normal(0, 1, (4, 12)).astype(np.float32)
    jw = jquant.quantize_po2(jnp.asarray(w), 6)
    want = jquant.int_exec_einsum("bd,dc->bc", jnp.asarray(x), jw, x_exp=5)
    tw = tquant.quantize_po2(torch.from_numpy(w), 6)
    rep = tcost.program_cost(
        lambda a: tquant.int_exec_einsum("bd,dc->bc", a, tw, x_exp=5),
        torch.from_numpy(x))
    got = tquant.int_exec_einsum("bd,dc->bc", torch.from_numpy(x), tw, x_exp=5)
    assert np.array_equal(got.numpy(), np.asarray(want))
    assert rep.matmul_flops == 2 * 4 * 2 * 12


# ---------------------------------------------------------------------------
# quantize_po2's stochastic key
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("bits,exp", [(8, 6), (4, 3)])
@pytest.mark.parametrize("seed", [0, 7])
def test_quantize_po2_stochastic_codes_equal(bits, exp, seed):
    w = np.random.default_rng(seed).normal(0, 0.5, (13, 7)).astype(np.float32)
    jq = jquant.quantize_po2(jnp.asarray(w), exp, bits=bits,
                             stochastic_key=jax.random.PRNGKey(seed))
    tq = tquant.quantize_po2(torch.from_numpy(w), exp, bits=bits,
                             stochastic_key=prng.PRNGKey(seed))
    assert np.array_equal(tq.values.numpy(), np.asarray(jq.values))
    assert np.array_equal(tq.int_values().numpy(),
                          np.asarray(jq.int_values()))
    # the key takes precedence over rounding, as in the reference
    tn = tquant.quantize_po2(torch.from_numpy(w), exp, bits=bits,
                             stochastic_key=prng.PRNGKey(seed),
                             rounding="nearest")
    assert torch.equal(tn.values, tq.values)
    floor = tquant.quantize_po2(torch.from_numpy(w), exp, bits=bits)
    assert not torch.equal(floor.int_values(), tq.int_values())


def test_quantize_po2_refuses_unknown_rounding_with_a_key():
    with pytest.raises(ValueError):
        tquant.quantize_po2(torch.zeros(3), 6, rounding="up",
                            stochastic_key=prng.PRNGKey(0))


# ---------------------------------------------------------------------------
# tools/surgeon.main
# ---------------------------------------------------------------------------

def test_surgeon_report_on_reference_params_same_order(capsys):
    """The demo on the reference's own weights (``PRNGKey(0)``): the same
    removal order, and the printed scores of the same size."""
    jcfg = jregistry.get("kwt-1").config.with_(n_layers=4)
    tcfg = tregistry.get("kwt-1").config.with_(n_layers=4)
    jp = jkwt.init_params(jcfg, jax.random.PRNGKey(0))
    from repro.data import pipeline as jpipeline
    jb = [jpipeline.keyword_batch(0, i, batch=32, input_dim=jcfg.input_dim,
                                  n_classes=jcfg.n_classes) for i in range(2)]
    jbase, jscores = jsurgeon.ablation_scores(jp, jcfg, jb, jkwt.loss_fn)
    tp = convert.from_numpy_tree(jax.tree.map(np.asarray, jp), "cpu")
    order = tsurgeon.report(tp, tcfg, tsurgeon.demo_batches(tcfg, "cpu"))
    assert order == jsurgeon.shrink_plan(jscores, keep=1)
    out = capsys.readouterr().out
    assert f"base loss {jbase:.4f}" in out
    assert "shrunk tree: 1 block(s)" in out


def test_surgeon_main_cpu_and_card_default(capsys):
    assert tsurgeon.main(["--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "remove order for depth=1 target:" in out
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tsurgeon.main([])
