"""``repro_torch.qat`` and its STEs against ``repro.qat`` / ``repro.core.approx``.

The same numpy inputs and weights go through the JAX function and its
port, on ``device="cpu"`` (the ``cuda`` modes take their kernels' plain
versions there).  Terms, with the errors measured behind them (this
file's seeds, PyTorch CPU vs XLA:CPU):

* exact (``array_equal`` / ``torch.equal``): fake-quant forward (int8,
  per-channel, int4, a tensor exponent; the inputs' eq-9 cast), the
  clipped-STE gradient and the
  exponent's zero gradient, ``calibrate_exponent``, the STE softmax /
  masked softmax / GELU forward in every LUT mode (in all of them,
  exactly the port's bare pipeline), ``reduce_head``'s
  shapes and grouping, export payloads, ``.npz`` artifacts read by the
  other package and the logits each deploys, the port's own QAT eval ==
  non-executing ``lut`` engine;
* but ``FLOAT_CARRY_ATOL`` 2e-6 where a float row sum is taken — the
  float-carry softmax (mode ``lut``) and the masked kernel path's
  renormalisation — which XLA sums in another order (measured 1.2e-7);
* ``REDUCE_ATOL`` 1e-6 for ``reduce_head``'s means (another summation
  order, measured 1.2e-7; the grouping itself is exact);
* ``STE_GRAD_ATOL`` 1e-6 for the STE gradients against ``jax.grad``
  (the exact op's backward summed in another order; measured 4.8e-7);
* ``LOSS_ATOL`` 1e-5 for ``loss_fn`` (measured 0.0 KWT-Tiny, 4.8e-7
  KWT-1 at 2 layers), the KD loss (3.0e-8) and ``ablation_scores``
  (4.8e-7);
* one QAT step under ``lut`` from the reference's state and batch: loss
  ``LOSS_ATOL`` (measured 6.0e-8), new params and moments ``STEP_ATOL``
  1e-5 (measured at most 1e-7) but the key bias, whose gradient is zero
  in exact arithmetic, so that AdamW turns either package's rounding
  noise into a step of up to lr (measured 9.2e-6, held within 2.2 lr);
  the QAT state exact;
* the QAT eval logits of the port against the reference's 2^-5, one
  activation LSB (measured 2.4e-7).
"""

import importlib
import json
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro import qat as jqat
from repro import runtime as jrt
from repro.configs import registry as jregistry
from repro.configs.base import ShapeSpec as JShape
from repro.core import approx as japprox
from repro.core import quant as jquant
from repro.launch import steps as jsteps
from repro.models import kwt as jkwt
from repro.optim import adamw as jadamw
from repro.qat import distill as jdistill
from repro.tools import surgeon as jsurgeon
from repro_torch import convert
from repro_torch import qat as tqat
from repro_torch import runtime as trt
from repro_torch.configs import registry as tregistry
from repro_torch.configs.base import ShapeSpec
from repro_torch.core import approx as tapprox
from repro_torch.core import quant as tquant
from repro_torch.core.tree import tree_leaves, tree_leaves_sorted
from repro_torch.kernels import ops as tops
from repro_torch.data import pipeline as tpipeline
from repro_torch.launch import steps as tsteps
from repro_torch.models import kwt as tkwt
from repro_torch.optim import adamw as tadamw
from repro_torch.qat import distill as tdistill
from repro_torch.tools import surgeon as tsurgeon

# the packages' ``qat.export`` names the function; the modules by path
jexport = importlib.import_module("repro.qat.export")
texport = importlib.import_module("repro_torch.qat.export")

torch.set_num_threads(1)

STE_GRAD_ATOL = 1e-6
FLOAT_CARRY_ATOL = 2e-6
REDUCE_ATOL = 1e-6
LOSS_ATOL = 1e-5
STEP_ATOL = 1e-5
TINY_LUT_ATOL = 2.0 ** -5

JCFG = jregistry.get("kwt-tiny").config
TCFG = tregistry.get("kwt-tiny").config
HP = dict(lr=1e-3, warmup_steps=2, total_steps=50, weight_decay=0.0)


def _np_params(jcfg, seed=0):
    """Reference-layout parameters, every leaf random, fan-in scaled."""
    shapes = jax.eval_shape(lambda k: jkwt.init_params(jcfg, k),
                            jax.random.PRNGKey(0))
    rng = np.random.default_rng(seed)

    def leaf(s):
        scale = 1.0 / np.sqrt(s.shape[0]) if len(s.shape) > 1 else 0.1
        return rng.normal(0, scale, s.shape).astype(np.float32)

    tree = jax.tree.map(leaf, shapes)
    for bp in tree["blocks"]:
        for ln in ("ln1", "ln2"):
            bp[ln]["scale"] = (1.0 + bp[ln]["scale"]).astype(np.float32)
    return tree


@pytest.fixture(scope="module")
def params():
    npp = _np_params(JCFG)
    return jax.tree.map(jnp.asarray, npp), convert.from_numpy_tree(npp, "cpu")


def _batch(jcfg, b, seed=0, n_classes=None):
    rng = np.random.default_rng(50 + seed)
    return {"mfcc": rng.normal(0, 1.0, (b, *jcfg.input_dim)).astype(np.float32),
            "labels": rng.integers(0, n_classes or jcfg.n_classes, b)
            .astype(np.int32)}


def _tbatch(npb):
    return {"mfcc": torch.from_numpy(npb["mfcc"]),
            "labels": torch.from_numpy(npb["labels"].astype(np.int64))}


def _recipes():
    base = jrt.QuantRecipe.from_config(JCFG)
    return {"int8": base, "per_channel": base.with_(per_channel=True),
            "int4": base.with_(bits=4, weight_exponent=3, per_channel=True)}


def _port_recipe(jrecipe):
    return trt.QuantRecipe.from_dict(jrecipe.to_dict())


def _assert_leaves_equal(jtree, ttree):
    jl = jax.tree.leaves(jtree)
    tl = tree_leaves_sorted(ttree)
    assert len(jl) == len(tl)
    for a, b in zip(jl, tl):
        assert np.array_equal(np.asarray(a), b.detach().numpy())


# ---------------------------------------------------------------------------
# fakequant
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("variant", ["int8", "per_channel", "int4"])
def test_fake_quant_tree_forward_exact(params, variant):
    jp, tp = params
    jr = _recipes()[variant]
    tr = _port_recipe(jr)
    got = tqat.fake_quant_tree(tp, tr)
    _assert_leaves_equal(jqat.fake_quant_tree(jp, jr), got)
    # the PTQ recipe's own dequantised values, bit for bit
    for a, b in zip(tree_leaves(got), tree_leaves(tr.apply(tp))):
        assert torch.equal(a, b)
    # a learned exponent on the device, a 0-dim tensor: the PTQ recipe at
    # that exponent, bit for bit
    e = tr.weight_exponent - 1
    got_e = tqat.fake_quant_tree(tp, tr, exponent=torch.tensor(float(e)))
    for a, b in zip(tree_leaves(got_e),
                    tree_leaves(tr.with_(weight_exponent=e).apply(tp))):
        assert torch.equal(a, b)


def test_fake_quant_skips_norms_and_biases(params):
    _, tp = params
    fq = tqat.fake_quant_tree(tp, trt.QuantRecipe.from_config(TCFG))
    assert fq["proj_b"] is tp["proj_b"] and fq["cls"] is tp["cls"]
    assert not torch.equal(fq["proj_w"], tp["proj_w"])


@pytest.mark.parametrize("variant", ["int8", "per_channel", "int4"])
def test_clipped_ste_gradient_exact(variant):
    jr = _recipes()[variant]
    tr = _port_recipe(jr)
    rng = np.random.default_rng(3)
    w = rng.normal(0, 0.3, (12, 8)).astype(np.float32)
    w[0, :3] = [10.0, -10.0, 0.5]               # saturating, on the grid
    g = rng.normal(0, 1.0, w.shape).astype(np.float32)
    e = 6.0 if variant != "int4" else 3.0

    _, vjp = jax.vjp(lambda v, ee: jqat.fake_quant(v, ee, jr),
                     jnp.asarray(w), jnp.float32(e))
    jgw, jge = vjp(jnp.asarray(g))
    tw = torch.from_numpy(w).requires_grad_(True)
    te = torch.tensor(e, requires_grad=True)
    out = tqat.fake_quant(tw, te, tr)
    tgw, tge = torch.autograd.grad(out, (tw, te), torch.from_numpy(g))
    assert np.array_equal(tgw.numpy(), np.asarray(jgw))
    assert float(tge) == float(jge) == 0.0
    if variant == "int8":
        # the clipped STE: the cotangent where the cast did not saturate
        assert float(tgw[0, 0]) == 0.0 and float(tgw[0, 1]) == 0.0
        assert float(tgw[0, 2]) == g[0, 2]


def test_calibrate_exponent_exact(params):
    jp, tp = params
    jr = jrt.QuantRecipe.from_config(JCFG)
    tr = _port_recipe(jr)
    for scale in (1.0, 1e-6, 300.0):        # inside, and both clip edges
        js = jax.tree.map(lambda x: x * scale, jp)
        ts = convert.from_numpy_tree(jax.tree.map(np.asarray, js), "cpu")
        got = tqat.calibrate_exponent(ts, tr)
        want = jqat.calibrate_exponent(js, jr)
        assert got.dtype == torch.float32 and got.dim() == 0
        assert float(got) == float(want)


# ---------------------------------------------------------------------------
# the STEs of core.approx
# ---------------------------------------------------------------------------

def _scores(shape=(3, 2, 27, 27), seed=4):
    return (np.random.default_rng(seed).normal(0, 2.0, shape)
            .astype(np.float32))


def _causal(n):
    return np.tril(np.ones((n, n), bool))


# port mode -> the reference mode whose forward it must equal; the cuda
# modes take their kernel's plain version on the CPU, which the reference
# realises as its pallas kernel (interpret mode) — for an unmasked softmax
# row of 27 the same bits as its ``lut_fixed`` pipeline (ROADMAP C1), the
# cheaper oracle taken here
SOFTMAX_MODES = {"lut": "lut", "lut_fixed": "lut_fixed", "cuda": "pallas"}
GELU_MODES = {"lut": "lut", "lut_interp": "lut_interp", "cuda": "pallas"}


def _reference_mode(mode, masked):
    return "lut_fixed" if mode == "cuda" and not masked else SOFTMAX_MODES[mode]


def _jax_softmax(kind, mode, x, mask):
    if kind == "softmax":
        return japprox.softmax(x, mode=mode)
    return japprox.masked_softmax(x, None if mask is None else jnp.asarray(mask),
                                  mode=mode)


def _port_softmax(kind, mode, x, mask):
    if kind == "softmax":
        return tapprox.softmax(x, mode=mode)
    return tapprox.masked_softmax(
        x, None if mask is None else torch.from_numpy(mask), mode=mode)


CASES = [("softmax", m, False) for m in SOFTMAX_MODES] + \
    [("masked", m, masked) for m in SOFTMAX_MODES for masked in (False, True)]


@pytest.mark.parametrize("kind,mode,masked", CASES)
def test_ste_softmax_forward_exact(kind, mode, masked):
    x = _scores()
    mask = _causal(27) if masked else None
    want = np.asarray(_jax_softmax(kind, _reference_mode(mode, masked),
                                   jnp.asarray(x), mask))
    tx = torch.from_numpy(x).requires_grad_(True)
    got = _port_softmax(kind, mode, tx, mask)
    assert got.grad_fn is not None          # through the STE Function
    with torch.no_grad():
        bare = _port_softmax(kind, mode, tx, mask)
    assert bare.grad_fn is None and torch.equal(bare, got.detach())
    if mode == "lut" or (mode == "cuda" and masked):
        # a float row sum (the float carry; the masked kernel path's
        # renormalisation): another summation order than XLA's
        assert np.abs(got.detach().numpy() - want).max() <= FLOAT_CARRY_ATOL
    else:
        assert np.array_equal(got.detach().numpy(), want)


@pytest.mark.parametrize("mode", list(GELU_MODES))
def test_ste_gelu_forward_exact(mode):
    x = np.random.default_rng(5).normal(0, 2.0, (5, 27, 24)).astype(np.float32)
    x.reshape(-1)[:4] = [-1.857, 1.595, -10.0, 10.0]
    want = np.asarray(japprox.gelu(jnp.asarray(x), mode=GELU_MODES[mode]))
    tx = torch.from_numpy(x).requires_grad_(True)
    got = tapprox.gelu(tx, mode=mode)
    assert got.grad_fn is not None
    assert np.array_equal(got.detach().numpy(), want)


@pytest.mark.parametrize("kind,mode,masked", CASES)
def test_ste_softmax_gradient(kind, mode, masked):
    """Against ``jax.grad`` of the reference's STE (``STE_GRAD_ATOL``),
    and exactly the gradient of the exact op at the same input."""
    x = _scores(seed=6)
    g = np.random.default_rng(7).normal(0, 1.0, x.shape).astype(np.float32)
    mask = _causal(27) if masked else None
    jmode = "lut_fixed" if mode == "cuda" else mode   # its backward is mode-free
    _, vjp = jax.vjp(lambda v: _jax_softmax(kind, jmode, v, mask),
                     jnp.asarray(x))
    (want,) = vjp(jnp.asarray(g))
    tx = torch.from_numpy(x).requires_grad_(True)
    (got,) = torch.autograd.grad(_port_softmax(kind, mode, tx, mask), tx,
                                 torch.from_numpy(g))
    assert np.abs(got.numpy() - np.asarray(want)).max() <= STE_GRAD_ATOL
    (exact,) = torch.autograd.grad(_port_softmax(kind, "exact", tx, mask), tx,
                                   torch.from_numpy(g))
    assert torch.equal(got, exact)


@pytest.mark.parametrize("mode", list(GELU_MODES))
def test_ste_gelu_gradient(mode):
    x = np.linspace(-3.0, 3.0, 64 * 24, dtype=np.float32).reshape(64, 24)
    g = np.random.default_rng(8).normal(0, 1.0, x.shape).astype(np.float32)
    jmode = "lut" if mode == "cuda" else mode
    _, vjp = jax.vjp(lambda v: japprox.gelu(v, mode=jmode), jnp.asarray(x))
    (want,) = vjp(jnp.asarray(g))
    tx = torch.from_numpy(x).requires_grad_(True)
    (got,) = torch.autograd.grad(tapprox.gelu(tx, mode=mode), tx,
                                 torch.from_numpy(g))
    assert np.abs(got.numpy() - np.asarray(want)).max() <= STE_GRAD_ATOL
    (exact,) = torch.autograd.grad(tapprox.gelu_exact(tx), tx,
                                   torch.from_numpy(g))
    assert torch.equal(got, exact)


def test_ste_generic_wrappers():
    """``ste`` / ``ste_masked`` as the reference spells them."""
    x = torch.from_numpy(_scores((9, 9), 9)).requires_grad_(True)
    mask = torch.from_numpy(_causal(9))
    f = tapprox.ste(lambda v: tapprox.softmax_lut(v, fixed=True),
                    tapprox.softmax_exact)
    y = f(x)
    assert torch.equal(y.detach(), tapprox.softmax_lut(x.detach(), fixed=True))
    (g,) = torch.autograd.grad(y.sum(), x)
    (ge,) = torch.autograd.grad(tapprox.softmax_exact(x).sum(), x)
    assert torch.equal(g, ge)
    fm = tapprox.ste_masked(tapprox._masked_lut, tapprox._masked_exact)
    ym = fm(x, mask)
    (gm,) = torch.autograd.grad((ym * x).sum(), x)
    assert bool(torch.isfinite(gm).all()) and float(gm.abs().max()) > 0


class _CountOps(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.n += 1
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("mode", ["cuda", "lut_fixed"])
def test_serving_path_runs_the_bare_pipeline(mode):
    """Under inference mode the STE is not entered: no graph, no saved
    input, and exactly the ATen ops of the bare pipeline."""
    x = torch.from_numpy(_scores((2, 1, 1, 27, 27)))
    with torch.inference_mode():
        with _CountOps() as c_ste:
            y = tapprox.masked_softmax(x, None, mode=mode)
        with _CountOps() as c_bare:
            want = tapprox._MASKED_PRIMALS[mode](x.to(torch.float32), None)
    assert y.grad_fn is None and torch.equal(y, want)
    assert c_ste.n == c_bare.n


@pytest.mark.parametrize("wrapper", ["lut_softmax", "lut_gelu"])
def test_kernel_wrapper_refuses_to_cut_a_gradient(wrapper):
    """A direct wrapper call on a tensor recording a gradient raises and
    names the STE; with grad mode off, and through the STE, it runs."""
    fn = getattr(tops, wrapper)
    x = torch.from_numpy(_scores((6, 27))).requires_grad_(True)
    with pytest.raises(RuntimeError, match="straight-through estimator"):
        fn(x)
    with torch.no_grad():
        assert fn(x).grad_fn is None
    via = tapprox.softmax(x, mode="cuda") if wrapper == "lut_softmax" else \
        tapprox.gelu(x, mode="cuda")
    (g,) = torch.autograd.grad(via.sum(), x)
    assert bool(torch.isfinite(g).all())


# ---------------------------------------------------------------------------
# distillation pieces, the loss, the surgeon
# ---------------------------------------------------------------------------

def _heads(hw, hb):
    return ({"head_w": jnp.asarray(hw), "head_b": jnp.asarray(hb)},
            {"head_w": torch.from_numpy(hw), "head_b": torch.from_numpy(hb)})


@pytest.mark.parametrize("keyword_classes", [None, [3, 7, 8]])
def test_reduce_head_shapes_and_grouping_exact(keyword_classes):
    """One-hot columns: row c of the reduced head is 1/|group| in the
    column of c's group and 0 in the other, so the grouping is read off
    exactly (every sum holds one 1)."""
    hw = np.eye(40, 35, dtype=np.float32)
    hb = np.arange(35, dtype=np.float32)
    jh, th = _heads(hw, hb)
    want = jdistill.reduce_head(jh, keyword_classes)
    got = tdistill.reduce_head(th, keyword_classes)
    for k in ("head_w", "head_b"):
        assert tuple(got[k].shape) == want[k].shape
    assert np.array_equal(got["head_w"].numpy(), np.asarray(want["head_w"]))
    # the bias means: the same groups, summed in another order
    assert np.abs(got["head_b"].numpy() - np.asarray(want["head_b"])).max() \
        <= REDUCE_ATOL
    with pytest.raises(ValueError):
        tdistill.reduce_head(th, range(35))


def test_reduce_head_values_vs_reference():
    rng = np.random.default_rng(10)
    jh, th = _heads(rng.normal(0, 1, (64, 35)).astype(np.float32),
                    rng.normal(0, 1, (35,)).astype(np.float32))
    want, got = jdistill.reduce_head(jh), tdistill.reduce_head(th)
    for k in ("head_w", "head_b"):
        assert np.abs(got[k].numpy() - np.asarray(want[k])).max() <= REDUCE_ATOL


def test_teacher_config_regrids_input():
    tcfg = tdistill.teacher_config(tregistry.get("kwt-1").config, TCFG)
    assert tcfg.input_dim == TCFG.input_dim and tcfg.patch_dim == (16, 1)
    assert tcfg.softmax_mode == tcfg.act_approx == "exact"
    assert tcfg.n_layers == 12 and tcfg.n_classes == 35


@pytest.mark.parametrize("name", ["kwt-tiny", "kwt-1"])
def test_loss_fn_vs_reference(name):
    je, te = jregistry.get(name), tregistry.get(name)
    jcfg, tcfg = (je.smoke, te.smoke) if name == "kwt-1" else (je.config,
                                                                te.config)
    npp = _np_params(jcfg, 1)
    b = _batch(jcfg, 8)
    want = float(jax.jit(jkwt.loss_fn, static_argnums=2)(
        jax.tree.map(jnp.asarray, npp), b, jcfg))
    got = float(tkwt.loss_fn(convert.from_numpy_tree(npp, "cpu"), _tbatch(b),
                             tcfg))
    assert abs(got - want) <= LOSS_ATOL


@pytest.fixture(scope="module")
def teacher():
    """A 2-layer KWT-1 teacher on the student's grid, random weights,
    its head reduced to 2 classes (both packages)."""
    jt = jdistill.teacher_config(jregistry.get("kwt-1").smoke, JCFG)
    tt = tdistill.teacher_config(tregistry.get("kwt-1").smoke, TCFG)
    npt = _np_params(jt, 2)
    jp = jdistill.reduce_head(jax.tree.map(jnp.asarray, npt))
    tp = tdistill.reduce_head(convert.from_numpy_tree(npt, "cpu"))
    return (jdistill.DistillSpec(jp, jt.with_(n_classes=2)),
            tdistill.DistillSpec(tp, tt.with_(n_classes=2)))


def test_kd_loss_vs_reference(params, teacher):
    jp, tp = params
    jspec, tspec = teacher
    b = _batch(JCFG, 16)
    want = float(jax.jit(jdistill.make_distill_loss(jspec),
                         static_argnums=2)(jp, b, JCFG))
    got = tdistill.make_distill_loss(tspec)(tp, _tbatch(b), TCFG)
    assert abs(float(got) - want) <= LOSS_ATOL


def test_kd_loss_teacher_records_no_graph(params, teacher):
    _, tp = params
    _, tspec = teacher
    loss, grads = tsteps.value_and_grad(
        tdistill.make_distill_loss(tspec), tp, _tbatch(_batch(JCFG, 8)), TCFG)
    assert bool(torch.isfinite(loss))
    assert all(not t.requires_grad for t in tree_leaves(tspec.teacher_params))
    assert all(bool(torch.isfinite(g).all()) for g in tree_leaves(grads))


def test_ablation_scores_and_shrink_vs_reference():
    jcfg = jregistry.get("kwt-1").smoke.with_(n_layers=3)
    tcfg = tregistry.get("kwt-1").smoke.with_(n_layers=3)
    npp = _np_params(jcfg, 3)
    batches = [_batch(jcfg, 8, s, 35) for s in range(2)]
    jloss = jax.jit(jkwt.loss_fn, static_argnums=2)
    jbase, jscores = jsurgeon.ablation_scores(
        jax.tree.map(jnp.asarray, npp), jcfg, batches, jloss)
    tp = convert.from_numpy_tree(npp, "cpu")
    tbase, tscores = tsurgeon.ablation_scores(
        tp, tcfg, [_tbatch(b) for b in batches], tkwt.loss_fn)
    assert abs(tbase - jbase) <= LOSS_ATOL
    assert [i for i, _ in tscores] == [i for i, _ in jscores]
    for (_, a), (_, b) in zip(tscores, jscores):
        assert abs(a - b) <= LOSS_ATOL
    assert tsurgeon.shrink_plan(tscores, 1) == jsurgeon.shrink_plan(jscores, 1)
    shrunk = tsurgeon.shrink_params(tp, tscores, keep=1)
    kept = [i for i, _ in tscores][-1]
    assert len(shrunk["blocks"]) == 1
    assert shrunk["blocks"][0] is tp["blocks"][kept]


# ---------------------------------------------------------------------------
# the QAT step
# ---------------------------------------------------------------------------

def _jax_qat_run(jp, spec, n, b=16):
    step = jax.jit(jsteps.make_train_step(
        JCFG, JShape("t", 26, b, "train"), jadamw.HParams(**HP), n_micro=1,
        qat=spec))
    opt = jadamw.init(jp, jadamw.HParams(**HP))
    qs = jqat.init_qat_state(spec)
    states = [(jp, opt, qs)]
    for i in range(n):
        jp, opt, qs, m = step(jp, opt, qs, _batch(JCFG, b, 100 + i))
        states.append((jp, opt, qs, m))
    return states


@pytest.fixture(scope="module")
def reference_run(params):
    """Three steps of the reference's QAT step under ``lut`` (learned
    exponent), from the module's weights."""
    spec = jqat.QATSpec(jrt.QuantRecipe.from_config(JCFG),
                        jqat.QATConfig(learn_exponent=True))
    return spec, _jax_qat_run(params[0], spec, 3)


def _to_np(tree):
    return jax.tree.map(np.asarray, tree)


def test_qat_step_under_lut_from_reference_state(reference_run):
    """The port's step from the reference's state after two steps and the
    reference's third batch, against the reference's third step."""
    jspec, states = reference_run
    jp, jopt, jqs, _ = states[2]
    jp3, jopt3, jqs3, jm = states[3]
    spec = tqat.QATSpec(_port_recipe(jspec.recipe),
                        tqat.QATConfig(learn_exponent=True))
    step = tsteps.make_train_step(TCFG, ShapeSpec("t", 26, 16, "train"),
                                  tadamw.HParams(**HP), n_micro=1, qat=spec)
    tp = convert.from_numpy_tree(_to_np(jp), "cpu")
    topt = convert.opt_state_from_numpy(_to_np(jopt), "cpu")
    tqs = convert.qat_state_from_numpy(_to_np(jqs), "cpu")
    tp3, topt3, tqs3, tm = step(tp, topt, tqs, _tbatch(_batch(JCFG, 16, 102)))
    assert abs(float(tm["loss"]) - float(jm["loss"])) <= LOSS_ATOL
    # the key bias: a zero gradient, rounding noise normalised by AdamW
    lr = float(tm["lr"])
    for bp_t, bp_j in zip(tp3["blocks"], jp3["blocks"]):
        assert np.abs(bp_t["attn"].pop("bk").numpy()
                      - np.asarray(bp_j["attn"].pop("bk"))).max() <= 2.2 * lr
    for got, want in ((tp3, jp3), (topt3["m"], jopt3["m"]),
                      (topt3["v"], jopt3["v"])):
        for a, b in zip(tree_leaves_sorted(got), jax.tree.leaves(want)):
            assert np.abs(a.numpy() - np.asarray(b)).max() <= STEP_ATOL
    assert int(topt3["step"]) == int(jopt3["step"]) == 3
    assert tqs3["step"].dtype == torch.int32 and int(tqs3["step"]) == 3
    assert float(tqs3["weight_exponent"]) == float(jqs3["weight_exponent"])


def _port_qat(tp, n, backend="lut", b=64, **cfg_kw):
    spec = tqat.QATSpec(trt.QuantRecipe.from_config(TCFG),
                        tqat.QATConfig(backend=backend, **cfg_kw))
    hp = tadamw.HParams(**HP)
    step = tsteps.make_train_step(TCFG, ShapeSpec("t", 26, b, "train"), hp,
                                  n_micro=1, qat=spec)
    opt, qs = tadamw.init(tp, hp), tqat.init_qat_state(spec, "cpu")
    losses = []
    for i in range(n):
        tp, opt, qs, m = step(tp, opt, qs, tpipeline.keyword_batch(
            0, i, batch=b, input_dim=TCFG.input_dim))
        losses.append(float(m["loss"]))
    return spec, tp, qs, losses


@pytest.fixture(scope="module")
def port_trained(params):
    return _port_qat(params[1], 30)


def test_qat_steps_lower_the_loss(port_trained):
    _, _, qs, losses = port_trained
    assert int(qs["step"]) == 30 and all(np.isfinite(losses))
    assert np.mean(losses[-5:]) < np.mean(losses[:5])


def test_port_qat_eval_bit_identical_to_exported_lut_engine(port_trained):
    """The port's own export contract, exact: QAT eval == the
    non-executing ``lut`` engine of the export; the integer-executing plan
    within the reference's 0.35 envelope."""
    spec, tp, qs, _ = port_trained
    ex = tqat.export(tp, spec, qs)
    x = torch.from_numpy(np.random.default_rng(7).normal(
        0, 0.5, (8, *TCFG.input_dim)).astype(np.float32))
    ev = tqat.eval_forward(TCFG, spec, ex.recipe)(tp, x)
    eng = trt.compile_model(TCFG, ex.params, backend="lut", recipe=ex.recipe,
                            integer_exec=False, device="cpu")
    assert torch.equal(ev, eng.forward(x))
    eng2 = trt.compile_model(TCFG, ex.params, backend="lut",
                             integer_exec=False, device="cpu")
    assert torch.equal(ev, eng2.forward(x))
    # the cuda exec config's modes through their plain versions: the same
    ev_k = tqat.eval_forward(TCFG, tqat.QATSpec(spec.recipe, tqat.QATConfig(
        backend="cuda")), ex.recipe)(tp, x)
    assert torch.equal(ev_k, ev)
    eng3 = trt.compile_model(TCFG, ex.params, backend="lut", device="cpu")
    assert eng3.int_exec
    assert float((ev - eng3.forward(x)).abs().max()) < 0.35


def test_qat_eval_vs_reference(params):
    jp, tp = params
    jspec = jqat.QATSpec(jrt.QuantRecipe.from_config(JCFG))
    tspec = tqat.QATSpec(_port_recipe(jspec.recipe))
    x = np.random.default_rng(11).normal(0, 0.5, (8, *JCFG.input_dim)) \
        .astype(np.float32)
    want = np.asarray(jqat.eval_forward(JCFG, jspec)(jp, jnp.asarray(x)))
    got = tqat.eval_forward(TCFG, tspec)(tp, torch.from_numpy(x)).numpy()
    assert np.abs(got - want).max() <= TINY_LUT_ATOL


def test_delayed_start_and_learned_exponent(params):
    _, tp = params
    spec = tqat.QATSpec(trt.QuantRecipe.from_config(TCFG),
                        tqat.QATConfig(start_step=1_000_000))
    qs = tqat.init_qat_state(spec, "cpu")
    for a, b in zip(tree_leaves(tqat.qat_params(tp, spec, qs)),
                    tree_leaves(tp)):
        assert torch.equal(a, b)
    spec, p, qs, _ = _port_qat(tp, 4, b=16, learn_exponent=True,
                               freeze_exponent_step=2)
    assert qs["weight_exponent"].dim() == 0
    ex = tqat.export(p, spec, qs)
    assert ex.recipe.weight_exponent == int(qs["weight_exponent"])
    assert trt.QuantRecipe.from_dict(ex.recipe.to_dict()) == ex.recipe


def test_cuda_qat_refuses_a_cpu_device(params):
    _, tp = params
    spec = tqat.QATSpec(trt.QuantRecipe.from_config(TCFG),
                        tqat.QATConfig(backend="cuda"))
    with pytest.raises(ValueError, match="CUDA device"):
        tqat.init_qat_state(spec, "cpu")
    step = tsteps.make_train_step(TCFG, ShapeSpec("t", 26, 8, "train"),
                                  tadamw.HParams(**HP), qat=spec)
    lut_qs = tqat.init_qat_state(tqat.QATSpec(spec.recipe), "cpu")
    with pytest.raises(ValueError, match="CUDA device"):
        step(tp, tadamw.init(tp, tadamw.HParams(**HP)), lut_qs,
             _tbatch(_batch(JCFG, 8)))


def test_flash_lut_attention_cannot_be_trained(params):
    _, tp = params
    with pytest.raises(NotImplementedError, match="flash-LUT"):
        tsteps.make_train_step(TCFG.with_(attn_impl="flash_lut"),
                               ShapeSpec("t", 26, 8, "train"))
    # a QAT spec pins the backend's attention, the einsum one
    spec = tqat.QATSpec(trt.QuantRecipe.from_config(TCFG))
    assert spec.exec_cfg(TCFG.with_(attn_impl="flash_lut")).attn_impl == "xla"


# ---------------------------------------------------------------------------
# export and the artifact on disk
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("variant", ["int8", "per_channel", "int4"])
def test_export_payloads_exact(params, variant):
    jp, tp = params
    jr = _recipes()[variant]
    jex = jqat.export(jp, jqat.QATSpec(jr))
    tex = tqat.export(tp, tqat.QATSpec(_port_recipe(jr)))
    assert tex.recipe.to_dict() == jex.recipe.to_dict()
    assert tuple(tex.quantized_bytes) == tuple(jex.quantized_bytes)
    jl = jax.tree.leaves(jex.qparams,
                         is_leaf=lambda x: isinstance(x, jquant.QTensor))
    tl = tree_leaves_sorted(tex.qparams)
    assert len(jl) == len(tl)
    for a, b in zip(jl, tl):
        if isinstance(b, tquant.QTensor):
            assert (a.exponent, a.bits, a.logical_shape) == \
                (b.exponent, b.bits, b.logical_shape)
            assert np.array_equal(np.asarray(a.values), b.values.numpy())
            assert a.values.dtype == b.values.numpy().dtype
            assert (a.axis_exponents is None) == (b.axis_exponents is None)
            if b.axis_exponents is not None:
                assert np.array_equal(np.asarray(a.axis_exponents),
                                      b.axis_exponents.numpy())
        else:
            assert np.array_equal(np.asarray(a), b.numpy())


@pytest.mark.parametrize("writer", ["reference", "port"])
@pytest.mark.parametrize("variant", ["int8", "int4"])
def test_npz_artifact_crosses_packages(params, writer, variant):
    """An artifact written by either package loads in the other with the
    same payload bytes, and deploys there exactly as that package's own
    export of the same weights does."""
    jp, tp = params
    jr = _recipes()[variant]
    jex = jqat.export(jp, jqat.QATSpec(jr))
    tex = tqat.export(tp, tqat.QATSpec(_port_recipe(jr)))
    x = np.random.default_rng(12).normal(0, 0.5, (8, *JCFG.input_dim)) \
        .astype(np.float32)
    with tempfile.TemporaryDirectory() as d:
        path = f"{d}/artifact"
        (jexport.save if writer == "reference" else texport.save)(
            path, jex if writer == "reference" else tex)
        with open(path + ".json") as f:
            doc = json.load(f)
        assert doc["recipe"] == jr.to_dict()
        trec, tq = texport.load(path, tex.qparams, device="cpu")
        jrec, jq = jexport.load(path, jex.qparams)
    assert trec.to_dict() == jrec.to_dict() == jr.to_dict()
    for a, b in zip(tree_leaves_sorted(tq), tree_leaves_sorted(tex.qparams)):
        if isinstance(a, tquant.QTensor):
            assert torch.equal(a.values, b.values) and a.exponent == b.exponent
            assert a.logical_shape == b.logical_shape
        else:
            assert torch.equal(a, b)
    for a, b in zip(jax.tree.leaves(jq), jax.tree.leaves(jex.qparams)):
        assert np.array_equal(np.asarray(a), np.asarray(b))
    # the logits each package deploys from the loaded tree: the port's
    # exactly those of its own export (the reference's follow from its
    # payloads, equal above); the reference deploying the port's file
    # within one LSB of the port
    t_own = trt.compile_model(TCFG, tex.params, backend="lut", recipe=tex.recipe,
                              device="cpu").forward(x)
    t_load = trt.compile_model(TCFG, tq, backend="lut", device="cpu").forward(x)
    assert torch.equal(t_load, t_own)
    if writer == "port" and variant == "int8":
        j_load = jrt.compile_model(JCFG, jq, backend="lut").forward(
            jnp.asarray(x))
        assert np.abs(np.asarray(j_load) - t_load.numpy()).max() <= TINY_LUT_ATOL


def test_fake_quant_input_exact():
    x = np.random.default_rng(13).normal(0, 2.0, (4, *JCFG.input_dim)) \
        .astype(np.float32)
    jr = jrt.QuantRecipe.from_config(JCFG)
    want = np.asarray(jqat.fake_quant_input(jnp.asarray(x), jr))
    tx = torch.from_numpy(x).requires_grad_(True)
    got = tqat.fake_quant_input(tx, _port_recipe(jr))
    assert np.array_equal(got.detach().numpy(), want)
    (g,) = torch.autograd.grad(got.sum(), tx)       # clipped STE: 0 or 1
    assert set(g.unique().tolist()) <= {0.0, 1.0}


def test_qat_step_with_quantized_inputs_and_teacher(params, teacher):
    """The options of the step the other tests leave off: the eq-9 input
    cast and KD, together, a few steps on the CPU."""
    _, tp = params
    _, tspec = teacher
    spec = tqat.QATSpec(trt.QuantRecipe.from_config(TCFG),
                        tqat.QATConfig(quantize_inputs=True), distill=tspec)
    hp = tadamw.HParams(**HP)
    step = tsteps.make_train_step(TCFG, ShapeSpec("t", 26, 16, "train"), hp,
                                  qat=spec)
    p, opt, qs = tp, tadamw.init(tp, hp), tqat.init_qat_state(spec, "cpu")
    for i in range(3):
        p, opt, qs, m = step(p, opt, qs, _tbatch(_batch(JCFG, 16, 20 + i)))
        assert bool(torch.isfinite(m["loss"]))
    assert int(qs["step"]) == 3 and float(m["qat_active"]) == 1.0


def test_finetune_qat_selects_the_best_state(params):
    """``finetune_qat`` on the CPU: without ``select_fn`` it returns the
    last state; with one that scores step 0's export highest, step 0's."""
    _, tp = params
    spec = tqat.QATSpec(trt.QuantRecipe.from_config(TCFG))
    p, qs = tqat.finetune_qat(TCFG, tp, spec, 4, batch=16, device="cpu",
                              select_every=2)
    assert int(qs["step"]) == 4
    assert not torch.equal(p["proj_w"], tp["proj_w"])
    first = trt.QuantRecipe.from_config(TCFG).apply(tp)["proj_w"]
    score = lambda deployed: float(torch.equal(deployed["proj_w"], first))  # noqa: E731
    p0, qs0 = tqat.finetune_qat(TCFG, tp, spec, 4, batch=16, device="cpu",
                                select_fn=score, select_every=2)
    assert int(qs0["step"]) == 0 and torch.equal(p0["proj_w"], tp["proj_w"])


def test_shrink_teacher_keeps_the_highest_impact_blocks():
    tcfg = tdistill.teacher_config(tregistry.get("kwt-1").smoke.with_(
        n_layers=3), TCFG)
    tp = convert.from_numpy_tree(_np_params(
        jdistill.teacher_config(jregistry.get("kwt-1").smoke.with_(
            n_layers=3), JCFG), 4), "cpu")
    batches = [_tbatch(_batch(JCFG, 8, s, 35)) for s in range(2)]
    shrunk, scfg = tdistill.shrink_teacher(tp, tcfg, 1, batches)
    _, scores = tsurgeon.ablation_scores(tp, tcfg, batches, tkwt.loss_fn)
    assert scfg.n_layers == 1 and len(shrunk["blocks"]) == 1
    assert shrunk["blocks"][0] is tp["blocks"][scores[-1][0]]
    assert bool(torch.isfinite(tkwt.loss_fn(shrunk, batches[0], scfg)))
