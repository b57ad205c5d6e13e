"""The port's training infrastructure against the reference's:
``optim.adamw``, ``launch.steps``, ``data.pipeline``,
``checkpoint.manager`` and ``launch.train``, on ``device="cpu"``.

Terms, with the errors measured behind them (this file's seeds, PyTorch
CPU vs XLA:CPU):

* exact: a checkpoint of float params and AdamW state written by either
  package and restored by the other; a QTensor tree's checkpoint round
  trip in the port (stored dtypes kept), and one written by the
  reference;
* the int8 moment codec: the port's scale is an exact power of two,
  the reference's within ``Q8_SCALE_RTOL`` 1e-6 of it (XLA:CPU's ``exp2``
  is not exact at every integer: 2^-15 comes out 3.0517593e-05; measured
  6.0e-7), so an int8 value may differ by one where it sits on a rounding
  edge (measured: one value, by one);
* ``SCHEDULE_RTOL`` 1e-6 for the learning-rate schedule (measured 3.6e-7);
* ``ADAMW_ATOL`` 1e-6 for one ``adamw.update`` from the same state, f32
  and int8 moments, stacked or not (measured 6.0e-8 on the params, 5.6e-9
  on f32 moments; int8 moments as for the codec);
* one train step under ``float`` from the reference's AdamW state:
  ``LOSS_ATOL`` 1e-5 (measured 4.8e-7), ``GRAD_ATOL`` 1e-5 (measured
  3.3e-7) and ``STEP_ATOL`` 1e-5 for the new params (measured 1.2e-7) —
  but the key bias, whose gradient is exactly zero in exact arithmetic,
  so that AdamW turns either package's rounding noise into a step of up
  to lr (measured 0.044 lr, held within 2.2 lr);
* behaviour: ``keyword_batch`` is deterministic, skippable and has its
  class structure; the launcher's crash-and-resume on the CPU ends where
  an uninterrupted run does, bit for bit; a KWT-Tiny the port trains on
  its own data reaches >= 0.75 on the reference's ``gsc_eval_set`` fold.
"""

import os
import subprocess
import sys
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import manager as jmanager
from repro.configs import registry as jregistry
from repro.core import quant as jquant
from repro.data import pipeline as jpipeline
from repro.models import kwt as jkwt
from repro.optim import adamw as jadamw
from repro_torch import convert
from repro_torch import runtime as trt
from repro_torch.checkpoint import manager as tmanager
from repro_torch.configs import registry as tregistry
from repro_torch.configs.base import ShapeSpec
from repro_torch.core import quant as tquant
from repro_torch.core.tree import tree_leaves, tree_leaves_sorted
from repro_torch.data import pipeline as tpipeline
from repro_torch.launch import steps as tsteps
from repro_torch.launch import train as ttrain
from repro_torch.optim import adamw as tadamw

torch.set_num_threads(1)

SCHEDULE_RTOL = 1e-6
Q8_SCALE_RTOL = 1e-6
ADAMW_ATOL = 1e-6
LOSS_ATOL = 1e-5
GRAD_ATOL = 1e-5
STEP_ATOL = 1e-5

MODELS = {"kwt-tiny": False, "kwt-1": True}     # name -> use the smoke config

# the reference's update, compiled once per tree structure (its eager
# dispatch compiles every op of every leaf on the first call)
jupdate = jax.jit(jadamw.update, static_argnames=("hp", "scan_stacked"))


def _cfgs(name):
    je, te = jregistry.get(name), tregistry.get(name)
    return (je.smoke, te.smoke) if MODELS[name] else (je.config, te.config)


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


def _batch(jcfg, b, seed=0):
    rng = np.random.default_rng(70 + seed)
    return {"mfcc": rng.normal(0, 1.0, (b, *jcfg.input_dim)).astype(np.float32),
            "labels": rng.integers(0, jcfg.n_classes, b).astype(np.int32)}


def _tbatch(npb):
    return {"mfcc": torch.from_numpy(npb["mfcc"]),
            "labels": torch.from_numpy(npb["labels"].astype(np.int64))}


def _max_diff(ttree, jtree):
    return max(float(np.abs(a.detach().numpy().astype(np.float64)
                            - np.asarray(b).astype(np.float64)).max())
               for a, b in zip(tree_leaves_sorted(ttree), jax.tree.leaves(jtree)))


# ---------------------------------------------------------------------------
# optim.adamw
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("hp_kw", [dict(warmup_steps=5, total_steps=40),
                                   dict(warmup_steps=0, total_steps=10,
                                        min_lr_ratio=0.0, lr=3e-3)])
def test_schedule_vs_reference(hp_kw):
    steps = np.arange(0, 60, dtype=np.int32)
    want = np.asarray(jadamw.schedule(jnp.asarray(steps),
                                      jadamw.HParams(**hp_kw)))
    got = tadamw.schedule(torch.from_numpy(steps), tadamw.HParams(**hp_kw))
    np.testing.assert_allclose(got.numpy(), want, rtol=SCHEDULE_RTOL, atol=0)


def test_q8_codec_vs_reference():
    rng = np.random.default_rng(1)
    for scale in (1e-3, 1.0, 250.0):
        x = (rng.normal(0, scale, (33, 7))).astype(np.float32)
        x[0, 0] = 0.5 * scale      # an exact .5 tie on most scales
        jenc = jadamw._q8_encode(jnp.asarray(x))
        tenc = tadamw._q8_encode(torch.from_numpy(x))
        # the port's scale is the exact power of two the codec intends;
        # XLA:CPU's exp2 misses some (2^-15 comes out 3.0517593e-05)
        e = float(torch.log2(tenc["scale"]))
        assert e == round(e)
        assert abs(float(tenc["scale"]) / float(jenc["scale"]) - 1) <= \
            Q8_SCALE_RTOL
        assert np.abs(tenc["q"].numpy().astype(int)
                      - np.asarray(jenc["q"]).astype(int)).max() <= 1
        # at the same scale, the same integers
        want_q = np.clip(np.round(x / float(tenc["scale"])), -127, 127)
        assert np.array_equal(tenc["q"].numpy(), want_q.astype(np.int8))
        assert torch.equal(tadamw._q8_decode(tenc),
                           tenc["q"].to(torch.float32) * tenc["scale"])


def _opt_trees(int8, stacked):
    """A stacked-layer tree, or KWT-Tiny's.  With int8 moments the
    reference's ``init`` gives every leaf under ``"blocks"`` a per-slice
    scale, which only the stacked (scan) update can read, so the unstacked
    int8 case takes KWT-Tiny's tree without its blocks."""
    rng = np.random.default_rng(2)
    if stacked:
        params = {"blocks": {"w": rng.normal(0, 1, (3, 6, 5)),
                             "b": rng.normal(0, 1, (3, 5))},
                  "head": rng.normal(0, 1, (5, 2))}
    else:
        params = _np_params(jregistry.get("kwt-tiny").config, 3)
        if int8:
            del params["blocks"]
    params = jax.tree.map(lambda a: np.asarray(a, np.float32), params)
    grads = [jax.tree.map(lambda a: rng.normal(0, 0.5, a.shape)
                          .astype(np.float32), params) for _ in range(2)]
    return params, grads


@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("stacked", [False, True])
def test_adamw_update_vs_reference(int8, stacked):
    """Two updates: the second from the reference's state after the first
    (nonzero moments), in both packages."""
    hp_kw = dict(lr=1e-2, warmup_steps=1, total_steps=20, int8_moments=int8)
    jhp, thp = jadamw.HParams(**hp_kw), tadamw.HParams(**hp_kw)
    params, grads = _opt_trees(int8, stacked)
    jp = jax.tree.map(jnp.asarray, params)
    js = jadamw.init(jp, jhp)
    jp, js, _ = jupdate(jax.tree.map(jnp.asarray, grads[0]), js, jp, jhp,
                        scan_stacked=stacked)
    tp = convert.from_numpy_tree(jax.tree.map(np.asarray, jp), "cpu")
    ts = convert.opt_state_from_numpy(jax.tree.map(np.asarray, js), "cpu")
    jp2, js2, jm = jupdate(jax.tree.map(jnp.asarray, grads[1]), js, jp,
                           jhp, scan_stacked=stacked)
    tp2, ts2, tm = tadamw.update(convert.from_numpy_tree(grads[1], "cpu"), ts,
                                 tp, thp, scan_stacked=stacked)
    assert _max_diff(tp2, jp2) <= ADAMW_ATOL
    assert abs(float(tm["lr"]) - float(jm["lr"])) <= 1e-9
    assert abs(float(tm["grad_norm"]) - float(jm["grad_norm"])) <= 1e-5
    assert int(ts2["step"]) == int(js2["step"]) == 2
    if int8:
        for key in ("m", "v"):
            tl, jl = tree_leaves_sorted(ts2[key]), jax.tree.leaves(js2[key])
            for tq, tsc, jq, jsc in zip(tl[0::2], tl[1::2], jl[0::2], jl[1::2]):
                assert tuple(tsc.shape) == jsc.shape      # per slice if stacked
                np.testing.assert_allclose(tsc.numpy(), np.asarray(jsc),
                                           rtol=Q8_SCALE_RTOL, atol=0)
                assert np.abs(tq.numpy().astype(int)
                              - np.asarray(jq).astype(int)).max() <= 1
    else:
        assert _max_diff(ts2["m"], js2["m"]) <= ADAMW_ATOL
        assert _max_diff(ts2["v"], js2["v"]) <= ADAMW_ATOL


def test_global_norm_vs_reference():
    params, grads = _opt_trees(False, False)
    want = float(jadamw.global_norm(jax.tree.map(jnp.asarray, grads[0])))
    got = float(tadamw.global_norm(convert.from_numpy_tree(grads[0], "cpu")))
    assert abs(got - want) <= 1e-6 * want


# ---------------------------------------------------------------------------
# launch.steps
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", list(MODELS))
def test_float_train_step_vs_reference(name):
    """Loss, grads and new params of one step under ``float``."""
    jcfg, tcfg = _cfgs(name)
    npp = _np_params(jcfg, 4)
    b = _batch(jcfg, 8)
    jp = jax.tree.map(jnp.asarray, npp)
    vg = jax.jit(jax.value_and_grad(jkwt.loss_fn), static_argnums=2)
    hp_kw = dict(lr=1e-3, warmup_steps=1, total_steps=10)
    jhp = jadamw.HParams(**hp_kw)
    # the state after a first step on another batch: AdamW's first update
    # is g / (|g| + eps), ill-conditioned where a gradient is near 0
    _, g0 = vg(jp, _batch(jcfg, 8, 1), jcfg)
    _, js = jupdate(g0, jadamw.init(jp, jhp), jp, jhp,
                    scan_stacked=jcfg.scan_layers)[:2]
    jloss, jgrads = vg(jp, b, jcfg)
    jp2, _, _ = jupdate(jgrads, js, jp, jhp, scan_stacked=jcfg.scan_layers)

    tp = convert.from_numpy_tree(npp, "cpu")
    loss, grads = tsteps.value_and_grad(
        lambda p, bb: tsteps._loss(tcfg)(p, bb, tcfg), tp, _tbatch(b))
    assert abs(float(loss) - float(jloss)) <= LOSS_ATOL
    assert _max_diff(grads, jgrads) <= GRAD_ATOL
    thp = tadamw.HParams(**hp_kw)
    step = tsteps.make_train_step(tcfg, ShapeSpec("t", 26, 8, "train"), thp)
    ts = convert.opt_state_from_numpy(jax.tree.map(np.asarray, js), "cpu")
    tp2, ts2, m = step(tp, ts, _tbatch(b))
    assert float(m["loss"]) == float(loss)
    assert int(ts2["step"]) == 2
    # The key bias has an exactly zero gradient (a softmax row does not
    # change when the same q.bk is added to all its scores): both packages
    # hold rounding noise there, which AdamW normalises to a step of up to
    # lr.  Every other leaf is held to STEP_ATOL.
    for bp_t, bp_j, g_t, g_j in zip(tp2["blocks"], jp2["blocks"],
                                    grads["blocks"], jgrads["blocks"]):
        assert float(g_t["attn"]["bk"].abs().max()) <= 1e-6
        assert float(jnp.abs(g_j["attn"]["bk"]).max()) <= 1e-6
        lr = float(m["lr"])
        assert np.abs(bp_t["attn"].pop("bk").numpy()
                      - np.asarray(bp_j["attn"].pop("bk"))).max() <= 2.2 * lr
    assert _max_diff(tp2, jp2) <= STEP_ATOL
    # the caller's tree is untouched (updates are out of place)
    assert all(torch.equal(a, torch.from_numpy(np.asarray(b_)))
               for a, b_ in zip(tree_leaves_sorted(tp), jax.tree.leaves(npp)))


def test_microbatches_accumulate_in_float32():
    _, tcfg = _cfgs("kwt-tiny")
    tp = convert.from_numpy_tree(_np_params(jregistry.get("kwt-tiny").config, 5),
                                 "cpu")
    b = _tbatch(_batch(jregistry.get("kwt-tiny").config, 16))
    fn = lambda p, bb: tsteps._loss(tcfg)(p, bb, tcfg)     # noqa: E731
    l1, g1 = tsteps.accumulate(fn, tp, b, 1)
    l2, g2 = tsteps.accumulate(fn, tp, b, 2)
    halves = [tsteps.value_and_grad(fn, tp, mb)[0]
              for mb in tsteps.split_micro(b, 2)]
    assert float(l2) == float(torch.stack(halves).mean())
    assert abs(float(l2) - float(l1)) <= 1e-6
    assert max(float((a - c).abs().max()) for a, c in
               zip(tree_leaves(g1), tree_leaves(g2))) <= 1e-6


def test_later_items_raise_and_name_them():
    _, tcfg = _cfgs("kwt-tiny")
    shape = ShapeSpec("t", 26, 8, "train")
    with pytest.raises(NotImplementedError, match="queue A item 4"):
        tsteps.make_train_step(tcfg, shape, sync_mesh=object())
    assert tsteps.microbatches(tcfg, shape) == 1
    with pytest.raises(NotImplementedError, match="queue A item 3"):
        tsteps.model_module(tcfg.with_(family="dense"))
    for argv in (["--data", "2"], ["--compressed-grads"]):
        with pytest.raises(NotImplementedError, match="queue A item 4"):
            ttrain.main(["--device", "cpu", "--steps", "1"] + argv)
    assert tsteps.hparams_for(tcfg).int8_moments is False


# ---------------------------------------------------------------------------
# data.pipeline
# ---------------------------------------------------------------------------

def test_keyword_batch_deterministic_and_skippable():
    a = tpipeline.keyword_batch(0, 5, batch=8)
    b = tpipeline.keyword_batch(0, 5, batch=8)
    c = tpipeline.keyword_batch(0, 6, batch=8)
    d = tpipeline.keyword_batch(1, 5, batch=8)
    assert torch.equal(a["mfcc"], b["mfcc"]) and torch.equal(a["labels"],
                                                             b["labels"])
    assert not torch.equal(a["mfcc"], c["mfcc"])
    assert not torch.equal(a["mfcc"], d["mfcc"])
    assert a["mfcc"].shape == (8, 16, 26) and a["mfcc"].dtype == torch.float32
    assert a["labels"].dtype == torch.int64
    assert set(a["labels"].tolist()) <= {0, 1}
    k1 = tpipeline.keyword_batch(3, 2, batch=4, input_dim=(40, 98),
                                 n_classes=35)
    assert k1["mfcc"].shape == (4, 40, 98) and int(k1["labels"].max()) < 35


def _ridge_rows(batch):
    """Per sample, the frequency band of the time-averaged ridge."""
    return batch["mfcc"].mean(dim=-1).argmax(dim=-1).to(torch.float32)


def test_keyword_batch_class_structure():
    """Binary: class 1's ridge lies above class 0's.  Fine-grained: class
    c carries class c % 2's primary ridge, so coarsened labels are
    separable the same way, and classes 0/1 coincide with the binary
    task's (no secondary ridge)."""
    b = tpipeline.keyword_batch(0, 0, batch=512)
    pos = _ridge_rows(b)
    lab = b["labels"]
    assert float(pos[lab == 1].mean()) > float(pos[lab == 0].mean()) + 1.5
    fine = tpipeline.keyword_batch(0, 1, batch=1024, n_classes=35)
    # the same draws without variants: classes 0/1 identical
    assert set(fine["labels"].tolist()) == set(range(35))
    coarse = fine["labels"] % 2
    profile = fine["mfcc"].mean(dim=-1)
    base = profile[fine["labels"] < 2]
    assert float(profile[coarse == 1].argmax(-1).float().mean()) > \
        float(profile[coarse == 0].argmax(-1).float().mean())
    assert base.shape[0] > 0


def test_gsc_eval_set_is_a_disjoint_fold():
    ev = tpipeline.gsc_eval_set(0, n=100, batch=32)
    assert len(ev) == 4
    assert torch.equal(ev[0]["mfcc"],
                       tpipeline.keyword_batch(10_000, 0, batch=32)["mfcc"])
    assert not torch.equal(ev[0]["mfcc"],
                           tpipeline.keyword_batch(0, 0, batch=32)["mfcc"])


# ---------------------------------------------------------------------------
# checkpoint.manager
# ---------------------------------------------------------------------------

def test_checkpoint_qtensor_tree_roundtrip():
    """Packed QTensor trees round-trip at their stored dtypes; the static
    exponent / bits / shape come from the restore target."""
    w = torch.from_numpy((0.3 * np.random.default_rng(0).normal(size=(9, 5)))
                         .astype(np.float32))
    tree = {"w4": tquant.quantize_po2(w, 4, bits=4),
            "w8": tquant.quantize_po2(w, 6, bits=8),
            "pc": trt.QuantRecipe(per_channel=True)._quantize_leaf(w),
            "norm": torch.ones(5)}
    target = {k: (v if isinstance(v, tquant.QTensor) else torch.zeros(5))
              for k, v in tree.items()}
    target = {**target, "w4": tquant.QTensor(
        torch.zeros_like(tree["w4"].values), 4, bits=4, logical_shape=(9, 5))}
    with tempfile.TemporaryDirectory() as d:
        tmanager.save(d, 2, tree)
        assert tmanager.is_complete(d, 2) and tmanager.latest_step(d) == 2
        out = tmanager.restore(d, 2, target)
    assert out["w4"].values.dtype == torch.uint8
    assert out["w4"].values.numel() == (9 * 5 + 1) // 2
    assert out["w4"].bits == 4 and out["w4"].shape == (9, 5)
    assert out["w8"].values.dtype == torch.int8
    assert out["pc"].axis_exponents.dtype == torch.int8
    for k in ("w4", "w8", "pc"):
        assert torch.equal(out[k].dequantize(), tree[k].dequantize())
    assert torch.equal(out["norm"], tree["norm"])


def test_checkpoint_qtensor_tree_from_the_reference():
    """The same packed tree written by the reference restores in the port
    (one QTensor is two arrays there: values, then axis exponents)."""
    w = jnp.asarray((0.3 * np.random.default_rng(1).normal(size=(9, 5)))
                    .astype(np.float32))
    from repro.runtime.recipe import QuantRecipe as JRecipe
    tree = {"pc": JRecipe(per_channel=True)._quantize_leaf(w),
            "w4": jquant.quantize_po2(w, 4, bits=4)}
    tw = torch.from_numpy(np.asarray(w))
    like = {"pc": trt.QuantRecipe(per_channel=True)._quantize_leaf(tw),
            "w4": tquant.quantize_po2(tw, 4, bits=4)}
    with tempfile.TemporaryDirectory() as d:
        jmanager.save(d, 1, tree)
        out = tmanager.restore(d, 1, like)
    for k in tree:
        assert np.array_equal(out[k].values.numpy(), np.asarray(tree[k].values))
        assert out[k].values.dtype == like[k].values.dtype
    assert np.array_equal(out["pc"].axis_exponents.numpy(),
                          np.asarray(tree["pc"].axis_exponents))


def _train_state(int8):
    """KWT-Tiny's params and AdamW state after one update; with int8
    moments the stacked tree of ``_opt_trees`` (see there)."""
    npp, _ = _opt_trees(int8, stacked=int8)
    jp = jax.tree.map(jnp.asarray, npp)
    jhp = jadamw.HParams(int8_moments=int8, warmup_steps=1, total_steps=5)
    grads = jax.tree.map(lambda a: 0.1 * a, jp)
    _, js, _ = jupdate(grads, jadamw.init(jp, jhp), jp, jhp, scan_stacked=int8)
    return jp, js, tadamw.HParams(int8_moments=int8)


@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("writer", ["reference", "port"])
def test_checkpoint_of_params_and_adamw_state_crosses_packages(writer, int8):
    jp, js, thp = _train_state(int8)
    tp = convert.from_numpy_tree(jax.tree.map(np.asarray, jp), "cpu")
    ts = convert.opt_state_from_numpy(jax.tree.map(np.asarray, js), "cpu")
    with tempfile.TemporaryDirectory() as d:
        if writer == "reference":
            jmanager.save(d, 3, jp)
            jmanager.save(d + "/opt", 3, js)
            got_p = tmanager.restore(d, 3, tp)
            got_s = tmanager.restore(d + "/opt", 3, tadamw.init(tp, thp))
            pairs = ((got_p, jp), (got_s, js))
            for got, want in pairs:
                tl, jl = tree_leaves_sorted(got), jax.tree.leaves(want)
                assert len(tl) == len(jl)
                for a, b in zip(tl, jl):
                    assert a.dtype == torch.from_numpy(np.asarray(b)).dtype
                    assert np.array_equal(a.numpy(), np.asarray(b))
        else:
            tmanager.save(d, 3, tp)
            tmanager.save(d + "/opt", 3, ts, blocking=False).join()
            got_p = jmanager.restore(d, 3, jax.tree.map(jnp.zeros_like, jp))
            got_s = jmanager.restore(d + "/opt", 3,
                                     jax.tree.map(jnp.zeros_like, js))
            for got, want in ((got_p, tp), (got_s, ts)):
                for a, b in zip(jax.tree.leaves(got), tree_leaves_sorted(want)):
                    assert np.asarray(a).dtype == b.numpy().dtype
                    assert np.array_equal(np.asarray(a), b.numpy())


def test_checkpoint_ignores_incomplete_and_tmp():
    with tempfile.TemporaryDirectory() as d:
        tmanager.save(d, 1, {"a": torch.ones(3)})
        os.makedirs(os.path.join(d, "step_00000009.tmp-abcd"))
        os.makedirs(os.path.join(d, "step_00000007"))       # no manifest
        os.makedirs(os.path.join(d, "step_garbage"))
        assert tmanager.latest_step(d) == 1
        assert not tmanager.is_complete(d, 7)
        with pytest.raises(ValueError):
            tmanager.restore(d, 1, {"a": torch.zeros(4)})
    assert tmanager.latest_step("/nonexistent/dir") is None


# ---------------------------------------------------------------------------
# launch.train
# ---------------------------------------------------------------------------

def test_straggler_monitor_flags_slow_steps():
    mon = ttrain.StragglerMonitor(alpha=0.5, threshold=2.0)
    assert not mon.observe(0, 0.01)
    assert not mon.observe(1, 0.012)
    assert mon.observe(2, 0.1)
    assert mon.flagged and mon.flagged[0][0] == 2


def test_launcher_needs_a_device_unless_cpu_is_asked_for(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ttrain.main(["--arch", "kwt-tiny", "--qat", "--qat-backend", "lut",
                     "--steps", "2", "--global-batch", "4"])
    with pytest.raises(ValueError, match="CUDA device"):
        ttrain.main(["--arch", "kwt-tiny", "--qat", "--qat-backend", "cuda",
                     "--steps", "2", "--device", "cpu"])


def test_launcher_crash_and_resume_on_cpu():
    """QAT with a KD teacher and a learned exponent, checkpoints every 3
    steps, a crash at step 7: the rerun resumes from step 6 (the newest
    step complete in every tree) and ends bit for bit where an
    uninterrupted run does."""
    args = ["--arch", "kwt-tiny", "--qat", "--qat-backend", "lut",
            "--qat-learn-exponent", "--distill-teacher-arch", "kwt-1",
            "--distill-teacher-steps", "2", "--steps", "10",
            "--global-batch", "8", "--device", "cpu", "--seed", "3"]
    with tempfile.TemporaryDirectory() as d:
        ck = ["--ckpt-dir", d, "--ckpt-every", "3"]
        with pytest.raises(RuntimeError, match="injected failure"):
            ttrain.main(args + ck + ["--fail-at-step", "7"])
        assert tmanager.latest_step(d) == 6
        assert tmanager.latest_step(d + "/opt") == 6
        assert tmanager.latest_step(d + "/qat") == 6
        resumed = ttrain.main(args + ck)
    full = ttrain.main(args)
    assert resumed.resumed_from == 6 and full.resumed_from is None
    assert len(resumed.losses) == 4 and len(full.losses) == 10
    assert resumed.losses == full.losses[6:]
    for a, b in zip(tree_leaves(resumed.params), tree_leaves(full.params)):
        assert torch.equal(a, b)
    for a, b in zip(tree_leaves(resumed.opt_state), tree_leaves(full.opt_state)):
        assert torch.equal(a, b)
    assert int(resumed.qstate["step"]) == 10
    assert torch.equal(resumed.qstate["weight_exponent"],
                       full.qstate["weight_exponent"])
    assert resumed.export.recipe == full.export.recipe


def test_port_trained_kwt_tiny_reaches_075_on_the_reference_eval_fold():
    """QAT under ``lut`` on the port's own data, exported and deployed on
    the integer-executing ``lut`` plan, scored on the reference's
    ``gsc_eval_set`` fold fed as numpy."""
    run = ttrain.main(["--arch", "kwt-tiny", "--qat", "--qat-backend", "lut",
                       "--steps", "200", "--global-batch", "64",
                       "--device", "cpu"])
    cfg = run.cfg
    ex = run.export
    eng = trt.compile_model(cfg, ex.params, backend="lut", recipe=ex.recipe,
                            device="cpu")
    correct = total = 0
    for b in jpipeline.gsc_eval_set(0, n=512, input_dim=cfg.input_dim):
        logits = eng.forward(np.array(b["mfcc"]))
        correct += int((logits.argmax(-1).numpy() == np.asarray(b["labels"]))
                       .sum())
        total += logits.shape[0]
    assert correct / total >= 0.75, correct / total


def test_port_modules_import_without_jax_or_the_reference():
    code = (
        "import sys\n"
        "for name in ('jax', 'jaxlib', 'repro'):\n"
        "    sys.modules[name] = None\n"
        "import repro_torch.qat, repro_torch.optim.adamw, "
        "repro_torch.data.pipeline, repro_torch.checkpoint.manager, "
        "repro_torch.tools.surgeon, repro_torch.launch.train, "
        "repro_torch.qat.distill\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.') "
        "or m == 'repro' or m.startswith('repro.')]\n"
        "assert all(sys.modules[m] is None for m in bad), bad\n"
        "print('ok')\n")
    src = os.path.join(os.path.dirname(os.path.dirname(__file__)), "src")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env={**os.environ, "PYTHONPATH": src},
                         timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr
