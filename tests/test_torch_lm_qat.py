"""Quantisation-aware training of the LM families in the port against the
reference: one QAT step under ``lut`` against the reference's ``lut``, and
under ``cuda`` (the kernels' plain versions, on the CPU by
``QATSpec(plain_kernels=True)``) against the reference's ``pallas`` (its
kernels in interpret mode), at 16 tokens (rows of at most 64 keys, where
the Pallas softmax and its oracle agree: ROADMAP C1); fake-quant of bf16
stacked per-channel leaves; the export and its ``.npz`` artifact; remat
rerunning the kernels; the launcher.  Float LM training is
tests/test_torch_lm_train.py, whose helpers this file shares.

Tolerances, beside what was measured on this host (``PERF.md`` §6):

* one QAT step from the same params and batch (zero moments) against the
  reference's jitted step: under ``cuda`` the loss ``LOSS_ATOL`` 1e-5
  (measured at most 4.8e-7) and the first moment, which is ``0.1 * clip *
  g`` (so the gradients' parity), within ``0.1 * clip * GRAD_ATOL``
  (gradients measured at most 1.3e-6 apart, granite-moe); under ``lut`` the loss
  ``LUT_LOSS_ATOL`` 1e-4 and the gradients ``LUT_GRAD_ATOL`` 2e-3
  (measured 3.0e-5 and 2.9e-4 on internlm2, 2.5e-5 and 2.6e-4 on hymba,
  where one entry of the float-carry softmax moved a bin; rwkv, which has
  no softmax, 4.8e-7 and 1.3e-6); the new params ``STEP_ATOL`` 1e-5, but
  where the gradient lies within its tolerance of 0 (a first AdamW step
  is about ``lr * sign(g)``), within 2.2 lr; the QAT state exact;
* fake-quant of bf16 leaves (stacked ``[n_layers, ...]``, per-channel
  exponents), its clipped-STE gradient, ``calibrate_exponent`` on an LM
  tree: exact;
* the export: recipe, byte counts and every payload exact; an artifact
  written by one package loads in the other with the same bytes;
* remat: loss and gradients bit-equal with and without; the softmax (and
  whisper's GELU) wrapper called twice a layer with it, once without.
"""

import dataclasses
import importlib
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import qat as jqat
from repro.core import quant as jquant
from repro.qat import fakequant as jfakequant
from repro.runtime import QuantRecipe as JRecipe
from repro_torch import convert
from repro_torch import qat as tqat
from repro_torch.core import quant as tquant
from repro_torch.core.tree import tree_leaves, tree_leaves_sorted
from repro_torch.kernels import ops as tops
from repro_torch.launch import train as ttrain
from repro_torch.qat import fakequant as tfakequant
from repro_torch.qat import train as tqat_train
from repro_torch.runtime import QuantRecipe as TRecipe

from test_torch_lm_train import (GRAD_ATOL, HP, LOSS_ATOL, NOISE_GRAD,
                                 STEP_ATOL, JShape, ShapeSpec, cfgs, jadamw,
                                 jsteps, np_batch, np_params, tadamw, tbatch,
                                 tsteps)

jexport = importlib.import_module("repro.qat.export")
texport = importlib.import_module("repro_torch.qat.export")

torch.set_num_threads(1)

# (arch, the port's backend): cuda is held against the reference's pallas
STEPS = [("internlm2-1.8b", "lut"), ("internlm2-1.8b", "cuda"),
         ("granite-moe-3b-a800m", "cuda"), ("rwkv6-3b", "lut"),
         ("hymba-1.5b", "lut"), ("whisper-large-v3", "cuda")]
REFERENCE_BACKEND = {"lut": "lut", "cuda": "pallas"}
# (loss, gradient) tolerances: cuda against pallas, the same Q8.24
# pipeline, at the float terms; lut's float-carry softmax indexes its
# table by trunc(32 z) of float scores, so a one-ulp difference in a score
# (the products reduce in another order) can move an entry one bin
LUT_LOSS_ATOL, LUT_GRAD_ATOL = 1e-4, 2e-3
QAT_ATOL = {"cuda": (LOSS_ATOL, GRAD_ATOL), "lut": (LUT_LOSS_ATOL,
                                                  LUT_GRAD_ATOL)}


def specs(jcfg, tcfg, backend):
    jspec = jqat.QATSpec(JRecipe.from_config(jcfg), jqat.QATConfig(
        backend=REFERENCE_BACKEND[backend]))
    tspec = tqat.QATSpec(TRecipe.from_dict(jspec.recipe.to_dict()),
                         tqat.QATConfig(backend=backend), plain_kernels=True)
    return jspec, tspec


@pytest.mark.parametrize("name,backend", STEPS)
def test_qat_step_vs_reference(name, backend):
    jcfg, tcfg = cfgs(name)
    jspec, tspec = specs(jcfg, tcfg, backend)
    npp, npb = np_params(jcfg, 11), np_batch(jcfg, step=3)
    jhp = dataclasses.replace(jsteps.hparams_for(jcfg), **HP)
    jstep = jax.jit(jsteps.make_train_step(
        jcfg, JShape("custom", 16, 2, "train"), jhp, n_micro=1, qat=jspec))
    jp = jax.tree.map(jnp.asarray, npp)
    jp2, jo2, jq2, jm = jstep(jp, jadamw.init(jp, jhp),
                              jqat.init_qat_state(jspec),
                              jax.tree.map(jnp.asarray, npb))

    thp = tadamw.HParams(**jhp.__dict__)
    tp = convert.from_numpy_tree(npp, "cpu")
    tstep = tsteps.make_train_step(tcfg, ShapeSpec("custom", 16, 2, "train"),
                                   thp, n_micro=1, qat=tspec)
    tp2, to2, tq2, tm = tstep(tp, tadamw.init(tp, thp),
                              tqat.init_qat_state(tspec, "cpu"), tbatch(npb))
    loss_atol, grad_atol = QAT_ATOL[backend]
    assert abs(float(tm["loss"]) - float(jm["loss"])) <= loss_atol
    # m = (1 - b1) * clip * g after a first step: the gradients' parity
    clip = min(1.0, thp.grad_clip / float(jm["grad_norm"]))
    m_scale = (1 - thp.b1) * clip
    lr = float(jm["lr"])
    for a, b, m, mm in zip(tree_leaves_sorted(tp2), jax.tree.leaves(jp2),
                           tree_leaves_sorted(to2["m"]),
                           jax.tree.leaves(jo2["m"])):
        assert np.abs(m.numpy() - np.asarray(mm)).max() <= m_scale * grad_atol
        d = np.abs(a.numpy().astype(np.float64) - np.asarray(b, np.float64))
        # a gradient within the tolerance of 0 may take either sign
        noise = np.abs(np.asarray(mm)) <= m_scale * max(NOISE_GRAD, grad_atol)
        assert d[~noise].max(initial=0.0) <= STEP_ATOL
        assert d[noise].max(initial=0.0) <= 2.2 * lr
    assert int(tq2["step"]) == int(jq2["step"]) == 1
    assert float(tq2["weight_exponent"]) == float(jq2["weight_exponent"])
    assert float(tm["qat_active"]) == float(jm["qat_active"]) == 1.0


def test_fake_quant_of_bf16_stacked_per_channel_leaves():
    """bf16 shadow weights (the full-width configs' dtype) in the stacked
    layout with per-channel exponents: forward values, the clipped-STE
    gradient (float32 where fake-quant reads the leaf, as the reference's)
    and the learned exponent exact."""
    jcfg, _ = cfgs("internlm2-1.8b", dtype="bfloat16")
    npp = np_params(jcfg, 12)
    npp["blocks"]["mlp"]["w_up"][0, :3] *= 40.0     # saturating weights
    recipe = JRecipe.from_config(jcfg)
    assert recipe.per_channel
    trecipe = TRecipe.from_dict(recipe.to_dict())
    jp = jax.tree.map(lambda a: jnp.asarray(a, jnp.bfloat16), npp)
    tp = _to_bf16(convert.from_numpy_tree(npp, "cpu"))
    rng = np.random.default_rng(13)
    cot = jax.tree.map(lambda a: rng.normal(0, 1, a.shape).astype(np.float32),
                       npp)
    e = jnp.asarray(6.0, jnp.float32)

    def jloss(p):
        fq = jfakequant.fake_quant_tree(p, recipe, exponent=e)
        return sum(jnp.sum(a.astype(jnp.float32) * c) for a, c in zip(
            jax.tree.leaves(fq), jax.tree.leaves(cot)))

    jfq = jfakequant.fake_quant_tree(jp, recipe, exponent=e)
    jg = jax.grad(jloss)(jp)
    tfq = tfakequant.fake_quant_tree(tp, trecipe, exponent=torch.tensor(6.0))
    for a, b in zip(tree_leaves_sorted(tfq), jax.tree.leaves(jfq)):
        assert str(a.dtype) == f"torch.{np.dtype(b.dtype)}"
        assert np.array_equal(a.float().numpy(),
                              np.asarray(b.astype(jnp.float32)))
    tcot = convert.from_numpy_tree(cot, "cpu")

    def tloss(p):
        fq = tfakequant.fake_quant_tree(p, trecipe,
                                        exponent=torch.tensor(6.0))
        return sum((a.float() * c).sum() for a, c in zip(
            tree_leaves_sorted(fq), tree_leaves_sorted(tcot)))

    # the reference's STE gives a bf16 shadow weight a float32 gradient;
    # the QAT step differentiates the float32 view to give the same
    spec = tqat.QATSpec(trecipe)
    _, tg = tsteps.value_and_grad(tloss, tqat_train.grad_view(tp, spec))
    for a, b in zip(tree_leaves_sorted(tg), jax.tree.leaves(jg)):
        assert str(a.dtype) == f"torch.{np.dtype(b.dtype)}"
        assert np.array_equal(a.float().numpy(),
                              np.asarray(b.astype(jnp.float32)))
    assert float(tfakequant.calibrate_exponent(tp, trecipe)) == \
        float(jfakequant.calibrate_exponent(jp, recipe))


def _to_bf16(tree):
    if isinstance(tree, dict):
        return {k: _to_bf16(v) for k, v in tree.items()}
    return tree.to(torch.bfloat16)


@pytest.mark.parametrize("name", ["internlm2-1.8b", "whisper-large-v3"])
def test_export_and_artifact_vs_reference(name):
    jcfg, tcfg = cfgs(name)
    jspec, tspec = specs(jcfg, tcfg, "lut")
    npp = np_params(jcfg, 14)
    jex = jqat.export(jax.tree.map(jnp.asarray, npp), jspec)
    tex = tqat.export(convert.from_numpy_tree(npp, "cpu"), tspec)
    assert tex.recipe.to_dict() == jex.recipe.to_dict()
    assert tuple(tex.quantized_bytes) == tuple(jex.quantized_bytes)
    jl = jax.tree.leaves(jex.qparams,
                         is_leaf=lambda x: isinstance(x, jquant.QTensor))
    tl = tree_leaves_sorted(tex.qparams)
    assert len(jl) == len(tl)
    n_q = 0
    for a, b in zip(jl, tl):
        if isinstance(b, tquant.QTensor):
            n_q += 1
            assert (a.exponent, a.bits) == (b.exponent, b.bits)
            assert np.array_equal(np.asarray(a.values), b.values.numpy())
            assert np.array_equal(np.asarray(a.axis_exponents),
                                  b.axis_exponents.numpy())
        else:
            assert np.array_equal(np.asarray(a), b.numpy())
    assert n_q > 0
    with tempfile.TemporaryDirectory() as d:
        texport.save(f"{d}/port", tex)
        jexport.save(f"{d}/ref", jex)
        jr, jq = jexport.load(f"{d}/port", jex.qparams)
        tr, tq = texport.load(f"{d}/ref", tex.qparams, device="cpu")
    assert jr.to_dict() == tr.to_dict() == tex.recipe.to_dict()
    for a, b in zip(jax.tree.leaves(jq, is_leaf=lambda x: isinstance(
            x, jquant.QTensor)), tree_leaves_sorted(tq)):
        if isinstance(b, tquant.QTensor):
            assert np.array_equal(np.asarray(a.values), b.values.numpy())
        else:
            assert np.array_equal(np.asarray(a), b.numpy())


def test_softplus_lut_gradient_is_the_reference_table_gather():
    """The reference wraps no STE around its LUT softplus: the gradient is
    that of ``where(x > 8, x, -log(table gather))``, 0 inside +-8 and 1
    above, not the exact softplus's."""
    from repro.core import approx as japprox
    from repro_torch.core import approx as tapprox
    x = np.linspace(-12.0, 12.0, 97, dtype=np.float32)
    jv = japprox.softplus(jnp.asarray(x), "lut")
    jg = jax.grad(lambda v: jnp.sum(japprox.softplus(v, "lut")))(
        jnp.asarray(x))
    t = torch.from_numpy(x).requires_grad_(True)
    tv = tapprox.softplus(t, "lut")
    (tg,) = torch.autograd.grad(tv.sum(), t)
    np.testing.assert_allclose(tv.detach().numpy(), np.asarray(jv),
                               rtol=0, atol=1e-6)
    assert np.array_equal(tg.numpy(), np.asarray(jg))
    assert np.array_equal(tg.numpy(), (x > 8).astype(np.float32))


class _Calls:
    """Counts the calls of the two kernel wrappers (their plain versions
    on the CPU)."""

    def __init__(self, monkeypatch):
        self.n = {"lut_softmax": 0, "lut_gelu": 0}
        for name in self.n:
            fn = getattr(tops, name)

            def counted(*a, _fn=fn, _name=name, **kw):
                self.n[_name] += 1
                return _fn(*a, **kw)

            monkeypatch.setattr(tops, name, counted)

    def take(self):
        out, self.n = self.n, {k: 0 for k in self.n}
        return out


@pytest.mark.parametrize("name", ["internlm2-1.8b", "granite-moe-3b-a800m",
                                  "whisper-large-v3"])
def test_remat_reruns_the_kernels_and_changes_no_bit(name, monkeypatch):
    """Under remat the backward reruns each checkpointed layer's forward,
    the STEs included: the softmax (and whisper's GELU) wrapper is called
    twice a layer, and the loss and gradients do not move."""
    jcfg, tcfg = cfgs(name)
    npp, npb = np_params(jcfg, 15), tbatch(np_batch(jcfg))
    tp = convert.from_numpy_tree(npp, "cpu")
    calls = _Calls(monkeypatch)
    got = {}
    for remat in (False, True):
        cfg = tcfg.with_(remat=remat)
        _, spec = specs(jcfg, cfg, "cuda")
        qs = tqat.init_qat_state(spec, "cpu")
        got[remat] = tsteps.value_and_grad(
            tqat_train.make_qat_loss(cfg, spec), tp, npb,
            qs["weight_exponent"], qs["step"] >= 0) + (calls.take(),)
    (l0, g0, c0), (l1, g1, c1) = got[False], got[True]
    layers = tcfg.n_layers
    per_layer = {"dense": 1, "moe": 2}.get(tcfg.family)
    want_sm = layers * per_layer if per_layer else \
        tcfg.n_enc_layers + 2 * layers
    want_ge = tcfg.n_enc_layers + layers if tcfg.family == "encdec" else 0
    assert c0 == {"lut_softmax": want_sm, "lut_gelu": want_ge}
    assert c1 == {"lut_softmax": 2 * want_sm, "lut_gelu": 2 * want_ge}
    assert torch.equal(l0, l1)
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(g0),
                                                 tree_leaves(g1)))


@pytest.mark.parametrize("name", ["internlm2-1.8b", "granite-moe-3b-a800m",
                                  "rwkv6-3b", "hymba-1.5b",
                                  "whisper-large-v3", "qwen2.5-14b"])
def test_lm_qat_launcher_on_the_cpu(name):
    """``--qat --qat-backend cuda --device cpu`` on an LM smoke config: the
    kernels' plain versions, finite losses, the export at the end."""
    run = ttrain.main(["--arch", name, "--smoke", "--steps", "2",
                       "--global-batch", "2", "--seq-len", "16",
                       "--device", "cpu", "--qat", "--qat-backend", "cuda"])
    assert len(run.losses) == 2 and all(np.isfinite(run.losses))
    assert run.qat_spec.plain_kernels and run.export is not None
    assert run.export.quantized_bytes[0] > 0
    assert int(run.qstate["step"]) == 2
    assert run.opt_state["m"]["embed"].__class__ is (
        dict if name == "qwen2.5-14b" else torch.Tensor)


def test_lm_qat_refuses_a_teacher_and_kwt_keeps_refusing_cuda_on_the_cpu():
    with pytest.raises(SystemExit):
        ttrain.main(["--arch", "internlm2-1.8b", "--smoke", "--steps", "1",
                     "--device", "cpu", "--qat", "--distill-teacher-arch",
                     "kwt-1"])
    with pytest.raises(ValueError, match="CUDA device"):
        ttrain.main(["--arch", "kwt-tiny", "--qat", "--qat-backend", "cuda",
                     "--steps", "1", "--device", "cpu"])
    spec = tqat.QATSpec(TRecipe(), tqat.QATConfig(backend="cuda"))
    with pytest.raises(ValueError, match="CUDA device"):
        spec.check_device(torch.device("cpu"))
