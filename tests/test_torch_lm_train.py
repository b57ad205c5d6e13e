"""LM training in the port against the reference: the token batches, the
loss and its gradients for every LM family, one float train step (AdamW,
int8 moments included), microbatch accumulation, remat, the step
builders' meta specs and the launcher (crash and resume, the loss
falling).  The same numpy weights and batches go through both packages on
``device="cpu"``.  QAT on the LM families is tests/test_torch_lm_qat.py.

Tolerances, beside what was measured on this host (PyTorch CPU against
XLA:CPU, jax 0.9.0; ``PERF.md`` §6):

* ``lm_batch`` tokens and labels, ``_whisper_batch`` tokens: bit-equal;
  the whisper frames are ``jax.random.normal`` draws, within the PRNG
  twin's ``NORMAL_RTOL`` 1e-5 / ``NORMAL_ATOL`` 1e-6
  (``tests/test_torch_data.py``; measured 5.2e-6 relative);
* ``loss_fn``: ``LOSS_ATOL`` 1e-5 on losses of about 6 (measured at most
  9.5e-7 over the six smoke configs, the mask branch included);
* its gradients: ``GRAD_ATOL`` 2e-5 on gradients of up to about 1
  (measured at most 3.2e-6, rwkv6-3b's wkv scan; 1.0e-6 with a mask);
* one AdamW step from the reference's state after a first step: new
  params and float32 moments ``STEP_ATOL`` 1e-5 (measured at most 1.9e-7
  and 7.1e-9), but where the reference's gradient is rounding noise (at most
  ``NOISE_GRAD`` 1e-6 in magnitude: a key bias, whose gradient is zero in
  exact arithmetic), where AdamW turns either package's noise into a step
  of up to lr: held within 2.2 lr.  int8 moments (qwen2.5-14b): the
  loss, the gradients and the port's AdamW on the reference's gradients
  against the reference's AdamW on the same gradients (new params
  ``STEP_ATOL``; codes within one step, scales within ``Q8_SCALE_RTOL``:
  XLA:CPU's ``exp2``; new params measured 4.8e-7 apart), since where a
  code underflows to 0 AdamW's update is ill-conditioned (``_check_step``:
  the two full steps' params are 0.0071 apart on this seed);
* microbatches (2) against the reference's ``lax.scan``: the same terms;
* remat: the port's remat on against off bit-equal (one thread: the
  CPU's ``index_put_``, the embedding's backward, sums duplicate rows in
  thread order); the port with remat against the reference with remat,
  ``LOSS_ATOL`` / ``GRAD_ATOL`` (measured 4.8e-7 / 7.2e-7);
* shapes and dtypes of ``params_shape``, ``input_specs`` and
  ``decode_state_shape`` of every full-width LM config: equal to
  ``jax.eval_shape``'s, nothing allocated (meta tensors).
"""

import argparse
import contextlib
import dataclasses
import io
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jregistry
from repro.configs.base import ShapeSpec as JShape
from repro.data import pipeline as jpipeline
from repro.launch import steps as jsteps
from repro.launch import train as jtrain
from repro.optim import adamw as jadamw
from repro_torch import convert
from repro_torch.checkpoint import manager as tmanager
from repro_torch.configs import registry as tregistry
from repro_torch.configs.base import ShapeSpec
from repro_torch.core.tree import tree_leaves, tree_leaves_sorted
from repro_torch.data import pipeline as tpipeline
from repro_torch.launch import steps as tsteps
from repro_torch.launch import train as ttrain
from repro_torch.optim import adamw as tadamw

torch.set_num_threads(1)

LM = ["internlm2-1.8b", "granite-moe-3b-a800m", "rwkv6-3b", "hymba-1.5b",
      "whisper-large-v3", "qwen2.5-14b"]
LOSS_ATOL = 1e-5
GRAD_ATOL = 2e-5
STEP_ATOL = 1e-5
NOISE_GRAD = 1e-6
Q8_SCALE_RTOL = 1e-5
NORMAL_RTOL, NORMAL_ATOL = 1e-5, 1e-6
HP = dict(lr=1e-3, warmup_steps=1, total_steps=10)


def np_params(jcfg, seed=0):
    """Reference-layout parameters of any LM family with every leaf
    random: matrices fan-in scaled (stacked leaves by their per-layer
    fan-in), biases small, norm scales around 1."""
    mod = jsteps.model_module(jcfg)
    shapes = jax.eval_shape(lambda k: mod.init_params(jcfg, k),
                            jax.random.PRNGKey(0))
    rng = np.random.default_rng(seed)

    def leaf(path, s):
        names = [getattr(k, "key", "") for k in path]
        stacked = names[0] in ("blocks", "enc_blocks", "dec_blocks")
        per = s.shape[1:] if stacked else s.shape
        if "scale" in names or names[-1] in ("q_norm", "k_norm"):
            return rng.normal(1.0, 0.1, s.shape).astype(np.float32)
        scale = 1.0 / np.sqrt(per[0]) if len(per) > 1 else 0.1
        return rng.normal(0, scale, s.shape).astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


def np_batch(jcfg, b=2, s=16, step=0):
    """The launcher's batch for ``step`` (the reference's draws)."""
    if jcfg.family == "encdec":
        ns = argparse.Namespace(seed=0, global_batch=b, seq_len=s)
        batch = jtrain._whisper_batch(ns, jcfg, step)
    else:
        batch = jpipeline.lm_batch(0, step, global_batch=b, seq_len=s,
                                   vocab_size=jcfg.vocab_size)
    return {k: np.asarray(v) for k, v in batch.items()}


def tbatch(npb):
    return {k: torch.from_numpy(v.copy()) for k, v in npb.items()}


def cfgs(name, **kw):
    return (jregistry.get(name).smoke.with_(**kw),
            tregistry.get(name).smoke.with_(**kw))


def max_diff(ttree, jtree):
    return max(float(np.abs(a.detach().numpy().astype(np.float64)
                            - np.asarray(b).astype(np.float64)).max())
               for a, b in zip(tree_leaves_sorted(ttree), jax.tree.leaves(jtree)))


def port_vg(tcfg, tp, batch):
    return tsteps.value_and_grad(
        lambda p, bb: tsteps._loss(tcfg)(p, bb, tcfg), tp, batch)


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed,step,b,s,vocab", [
    (0, 0, 4, 16, 256), (3, 7, 2, 64, 92544), (1, 123, 8, 33, 49155)])
def test_lm_batch_bit_equal_to_the_reference(seed, step, b, s, vocab):
    want = jpipeline.lm_batch(seed, step, global_batch=b, seq_len=s,
                              vocab_size=vocab)
    got = tpipeline.lm_batch(seed, step, global_batch=b, seq_len=s,
                             vocab_size=vocab)
    for k in ("tokens", "labels"):
        assert got[k].dtype == torch.int32
        assert np.array_equal(got[k].numpy(), np.asarray(want[k]))
    assert torch.equal(got["tokens"][:, 1:], got["labels"][:, :-1])


@pytest.mark.parametrize("step", [0, 5])
def test_whisper_batch_vs_reference(step):
    jcfg, tcfg = cfgs("whisper-large-v3")
    ns = argparse.Namespace(seed=2, global_batch=3, seq_len=12)
    want = jtrain._whisper_batch(ns, jcfg, step)
    got = ttrain._whisper_batch(ns, tcfg, step)
    for k in ("tokens", "labels"):
        assert np.array_equal(got[k].numpy(), np.asarray(want[k]))
    assert got["frames"].shape == (3, tcfg.enc_seq, tcfg.d_model)
    np.testing.assert_allclose(got["frames"].numpy(), np.asarray(want["frames"]),
                               rtol=NORMAL_RTOL, atol=NORMAL_ATOL)


# ---------------------------------------------------------------------------
# loss_fn and its gradients
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", LM)
def test_loss_and_gradients_vs_reference(name):
    jcfg, tcfg = cfgs(name)
    npp, npb = np_params(jcfg), np_batch(jcfg)
    jl, jg = jax.value_and_grad(jsteps._loss(jcfg))(
        jax.tree.map(jnp.asarray, npp), jax.tree.map(jnp.asarray, npb), jcfg)
    tl, tg = port_vg(tcfg, convert.from_numpy_tree(npp, "cpu"), tbatch(npb))
    assert abs(float(tl) - float(jl)) <= LOSS_ATOL
    assert max_diff(tg, jg) <= GRAD_ATOL


@pytest.mark.parametrize("mask_dtype", [np.float32, np.bool_])
def test_loss_mask_branch_vs_reference(mask_dtype):
    """``sum(nll * mask) / max(sum(mask), 1)``, an all-zero mask too."""
    jcfg, tcfg = cfgs("internlm2-1.8b")
    npp, npb = np_params(jcfg, 1), np_batch(jcfg, step=2)
    mask = (np.random.default_rng(4).random(npb["tokens"].shape) < 0.6)
    for m in (mask, np.zeros_like(mask)):
        b = dict(npb, mask=m.astype(mask_dtype))
        jl, jg = jax.value_and_grad(jsteps._loss(jcfg))(
            jax.tree.map(jnp.asarray, npp), jax.tree.map(jnp.asarray, b), jcfg)
        tl, tg = port_vg(tcfg, convert.from_numpy_tree(npp, "cpu"), tbatch(b))
        assert abs(float(tl) - float(jl)) <= LOSS_ATOL
        assert max_diff(tg, jg) <= GRAD_ATOL
    assert float(tl) == 0.0


# ---------------------------------------------------------------------------
# train steps
# ---------------------------------------------------------------------------

def _reference_two_steps(jcfg, npp, n_micro=1, b=4):
    """The reference's step on batch 1, then on batch 2 from its state."""
    jhp = dataclasses.replace(jsteps.hparams_for(jcfg), **HP)
    shape = JShape("custom", 16, b, "train")
    step = jax.jit(jsteps.make_train_step(jcfg, shape, jhp, n_micro=n_micro))
    jp = jax.tree.map(jnp.asarray, npp)
    jp1, js1, _ = step(jp, jadamw.init(jp, jhp),
                       jax.tree.map(jnp.asarray, np_batch(jcfg, b, step=1)))
    b2 = np_batch(jcfg, b, step=2)
    jp2, js2, jm = step(jp1, js1, jax.tree.map(jnp.asarray, b2))
    _, jg = jax.value_and_grad(jsteps._loss(jcfg))(
        jp1, jax.tree.map(jnp.asarray, b2), jcfg)
    return jhp, (jp1, js1), (jp2, js2, jm), jg, b2


def _check_step(tp2, ts2, tm, jp2, js2, jm, jg, int8):
    """The port's step against the reference's: the loss and the gradient
    norm; the new params (but where the reference's gradient is rounding
    noise, within 2.2 lr); the moments.  With int8 moments the new params
    are not held element by element: where a moment's code underflows to 0
    (v below half its slice's scale), AdamW's ``m / (sqrt(v) + eps)`` is
    ill-conditioned, and the gradients' rounding differences (within
    ``GRAD_ATOL``) move such updates by up to 0.03 on this seed;
    ``_check_adamw_on_reference_grads`` holds the optimizer instead."""
    assert abs(float(tm["loss"]) - float(jm["loss"])) <= LOSS_ATOL
    assert abs(float(tm["grad_norm"]) - float(jm["grad_norm"])) <= \
        1e-5 * float(jm["grad_norm"])
    assert int(ts2["step"]) == int(js2["step"])
    if int8:
        return
    _check_new_params(tp2, jp2, jg, float(jm["lr"]))
    assert max_diff(ts2["m"], js2["m"]) <= STEP_ATOL
    assert max_diff(ts2["v"], js2["v"]) <= STEP_ATOL


def _check_new_params(tp2, jp2, jg, lr):
    for a, b, g in zip(tree_leaves_sorted(tp2), jax.tree.leaves(jp2),
                       jax.tree.leaves(jg)):
        d = np.abs(a.numpy().astype(np.float64) - np.asarray(b, np.float64))
        noise = np.abs(np.asarray(g)) <= NOISE_GRAD
        assert d[~noise].max(initial=0.0) <= STEP_ATOL
        assert d[noise].max(initial=0.0) <= 2.2 * lr


def _check_adamw_on_reference_grads(tp, ts, thp, jg, jstate, jhp,
                                    scan_stacked):
    """The port's AdamW and the reference's, both fed the reference's
    gradients ``jg`` from the state ``jstate``: new params within
    ``STEP_ATOL``; int8 moments' codes within one, scales within
    ``Q8_SCALE_RTOL``."""
    jp2, js2, _ = jadamw.update(jg, jstate[1], jstate[0], jhp,
                                scan_stacked=scan_stacked)
    tg = convert.from_numpy_tree(jax.tree.map(np.asarray, jg), "cpu")
    tp2, ts2, _ = tadamw.update(tg, ts, tp, thp, scan_stacked=scan_stacked)
    assert max_diff(tp2, jp2) <= STEP_ATOL
    for key in ("m", "v"):
        tl, jl = tree_leaves_sorted(ts2[key]), jax.tree.leaves(js2[key])
        assert len(tl) == len(jl)
        for tq, tsc, jq, jsc in zip(tl[0::2], tl[1::2], jl[0::2], jl[1::2]):
            assert tuple(tsc.shape) == jsc.shape
            np.testing.assert_allclose(tsc.numpy(), np.asarray(jsc),
                                       rtol=Q8_SCALE_RTOL, atol=0)
            assert np.abs(tq.numpy().astype(int)
                          - np.asarray(jq).astype(int)).max() <= 1


@pytest.mark.parametrize("name", ["internlm2-1.8b", "qwen2.5-14b"])
def test_float_train_step_vs_reference(name):
    """One AdamW step of the port from the reference's state after a
    first step (nonzero moments; qwen2.5-14b's are int8): loss, new params
    and moments."""
    jcfg, tcfg = cfgs(name)
    npp = np_params(jcfg, 2)
    jhp, (jp1, js1), (jp2, js2, jm), jg, b2 = _reference_two_steps(jcfg, npp)
    assert jhp.int8_moments == (name == "qwen2.5-14b")
    thp = dataclasses.replace(tsteps.hparams_for(tcfg), **HP)
    assert thp == tadamw.HParams(**jhp.__dict__)
    tp = convert.from_numpy_tree(jax.tree.map(np.asarray, jp1), "cpu")
    ts = convert.opt_state_from_numpy(jax.tree.map(np.asarray, js1), "cpu")
    step = tsteps.make_train_step(tcfg, ShapeSpec("custom", 16, 4, "train"),
                                  thp)
    tp2, ts2, tm = step(tp, ts, tbatch(b2))
    _check_step(tp2, ts2, tm, jp2, js2, jm, jg, jhp.int8_moments)
    _, tg = port_vg(tcfg, tp, tbatch(b2))
    assert max_diff(tg, jg) <= GRAD_ATOL
    if jhp.int8_moments:
        _check_adamw_on_reference_grads(tp, ts, thp, jg, (jp1, js1), jhp,
                                        jcfg.scan_layers)


def test_microbatches_against_the_reference_scan():
    """``n_micro=2``: the port's loop of float32 accumulation against the
    reference's ``lax.scan``, from the same state."""
    jcfg, tcfg = cfgs("internlm2-1.8b")
    npp = np_params(jcfg, 3)
    jhp, (jp1, js1), (jp2, js2, jm), jg, b2 = _reference_two_steps(
        jcfg, npp, n_micro=2)
    thp = dataclasses.replace(tsteps.hparams_for(tcfg), **HP)
    tp = convert.from_numpy_tree(jax.tree.map(np.asarray, jp1), "cpu")
    ts = convert.opt_state_from_numpy(jax.tree.map(np.asarray, js1), "cpu")
    step = tsteps.make_train_step(tcfg, ShapeSpec("custom", 16, 4, "train"),
                                  thp, n_micro=2)
    tp2, ts2, tm = step(tp, ts, tbatch(b2))
    _check_step(tp2, ts2, tm, jp2, js2, jm, jg, False)


@pytest.mark.parametrize("name", LM[:5])
def test_remat_changes_no_bit(name):
    """``cfg.remat``: each layer of the training forward checkpointed; the
    loss and every gradient bit-equal to the step without it, and a pass
    that records no graph does not checkpoint at all."""
    _, tcfg = cfgs(name)
    jcfg = jregistry.get(name).smoke
    npp, npb = np_params(jcfg, 5), tbatch(np_batch(jcfg))
    tp = convert.from_numpy_tree(npp, "cpu")
    l0, g0 = port_vg(tcfg.with_(remat=False), tp, npb)
    calls = []
    orig = torch.utils.checkpoint.checkpoint

    def counting(*a, **kw):
        calls.append(kw.get("use_reentrant"))
        return orig(*a, **kw)

    torch.utils.checkpoint.checkpoint = counting
    try:
        l1, g1 = port_vg(tcfg.with_(remat=True), tp, npb)
        n_layers = len(calls)
        with torch.no_grad():
            tsteps._loss(tcfg)(tp, npb, tcfg.with_(remat=True))
    finally:
        torch.utils.checkpoint.checkpoint = orig
    want = tcfg.n_layers + getattr(tcfg, "n_enc_layers", 0)
    assert n_layers == len(calls) == want and set(calls) == {False}
    assert torch.equal(l0, l1)
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(g0),
                                                 tree_leaves(g1)))


@pytest.mark.parametrize("name", ["internlm2-1.8b", "whisper-large-v3"])
def test_remat_against_the_reference_with_remat(name):
    jcfg, tcfg = cfgs(name, remat=True)
    npp, npb = np_params(jcfg, 6), np_batch(jcfg)
    jl, jg = jax.value_and_grad(jsteps._loss(jcfg))(
        jax.tree.map(jnp.asarray, npp), jax.tree.map(jnp.asarray, npb), jcfg)
    tl, tg = port_vg(tcfg, convert.from_numpy_tree(npp, "cpu"), tbatch(npb))
    assert abs(float(tl) - float(jl)) <= LOSS_ATOL
    assert max_diff(tg, jg) <= GRAD_ATOL


# ---------------------------------------------------------------------------
# steps: tables, meta specs, prefill / decode steps, item 4
# ---------------------------------------------------------------------------

def test_tables_and_hparams_are_the_reference():
    assert tsteps.MICROBATCHES == jsteps.MICROBATCHES
    assert tsteps.INT8_MOMENT_ARCHS == jsteps.INT8_MOMENT_ARCHS
    for name in jregistry.ARCHS:
        je, te = jregistry.get(name), tregistry.get(name)
        assert tsteps.hparams_for(te.config) == tadamw.HParams(
            **jsteps.hparams_for(je.config).__dict__)
        assert tsteps.hparams_for(te.smoke).int8_moments == \
            jsteps.hparams_for(je.smoke).int8_moments
        for js in je.shapes:
            ts = ShapeSpec(js.name, js.seq_len, js.global_batch, js.kind)
            assert tsteps.microbatches(te.config, ts) == \
                jsteps.microbatches(je.config, js)


def _spec(t):
    return tuple(t.shape), str(t.dtype).replace("torch.", "")


def _jspec(s):
    return tuple(s.shape), str(np.dtype(s.dtype))


FULL_LM = [n for n in jregistry.ARCHS if not n.startswith("kwt")]


@pytest.mark.parametrize("name", FULL_LM)
def test_meta_specs_of_every_full_width_config(name):
    je, te = jregistry.get(name), tregistry.get(name)
    jcfg, tcfg = je.config, te.config
    tp = tsteps.params_shape(tcfg)
    jp = jsteps.params_shape(jcfg)
    tl, jl = tree_leaves_sorted(tp), jax.tree.leaves(jp)
    assert [_spec(t) for t in tl] == [_jspec(s) for s in jl]
    assert {t.device.type for t in tl} == {"meta"}
    for js in je.shapes:
        ts = ShapeSpec(js.name, js.seq_len, js.global_batch, js.kind)
        ti, ji = tsteps.input_specs(tcfg, ts), jsteps.input_specs(jcfg, js)
        assert sorted(ti) == sorted(ji)
        assert {k: _spec(v) for k, v in ti.items()} == \
            {k: _jspec(v) for k, v in ji.items()}
    dshape = next(s for s in je.shapes if s.kind == "decode")
    ts = ShapeSpec(dshape.name, dshape.seq_len, dshape.global_batch, "decode")
    td = tsteps.decode_state_shape(tcfg, ts)
    jd = jsteps.decode_state_shape(jcfg, dshape)
    assert [_spec(t) for t in tree_leaves_sorted(td["layers"])] == \
        [_jspec(s) for s in jax.tree.leaves(jd["layers"])]
    assert {t.device.type for t in tree_leaves(td["layers"])} == {"meta"}
    assert td["index"] == 0 and jd["index"].shape == ()


@pytest.mark.parametrize("name", ["internlm2-1.8b", "whisper-large-v3"])
def test_prefill_and_decode_steps_vs_reference(name):
    jcfg, tcfg = cfgs(name)
    npp = np_params(jcfg, 7)
    shape = JShape("p", 8, 2, "prefill")
    tshape = ShapeSpec("p", 8, 2, "prefill")
    rng = np.random.default_rng(8)
    batch = {"tokens": rng.integers(0, jcfg.vocab_size, (2, 8)).astype(np.int32)}
    if jcfg.family == "encdec":
        batch["frames"] = rng.normal(0, 1, (2, jcfg.enc_seq, jcfg.d_model)
                                     ).astype(np.float32)
    jmod = jsteps.model_module(jcfg)
    jst = jmod.init_decode_state(jcfg, 2, 12)
    jlog, jst = jsteps.make_prefill_step(jcfg, shape)(
        jax.tree.map(jnp.asarray, npp), jst, jax.tree.map(jnp.asarray, batch))
    tp = convert.from_numpy_tree(npp, "cpu")
    tst = tsteps.model_module(tcfg).init_decode_state(tcfg, 2, 12,
                                                      device="cpu")
    tlog, tst = tsteps.make_prefill_step(tcfg, tshape)(tp, tst, tbatch(batch))
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), atol=1e-4)
    tok = np.asarray(jlog).argmax(-1).astype(np.int32)
    jlog2, _ = jsteps.make_decode_step(jcfg, shape)(
        jax.tree.map(jnp.asarray, npp), jst, {"token": jnp.asarray(tok)})
    tlog2, tst = tsteps.make_decode_step(tcfg, tshape)(
        tp, tst, {"token": torch.from_numpy(tok)})
    np.testing.assert_allclose(tlog2.numpy(), np.asarray(jlog2), atol=1e-4)
    assert tst["index"] == 9


def test_mesh_pieces_lower_and_price():
    """The specs and the step program run (held leaf for leaf against the
    reference's in tests/test_torch_specs.py); lowering and pricing a
    program run too: the cost decomposition has the reference's
    components and multipliers on a one-device mesh, and a component
    lowers on meta tensors with no collective."""
    from jax.sharding import PartitionSpec as JP

    from repro.launch import mesh as jmesh
    from repro_torch.launch import mesh as tmesh
    jcfg = jregistry.get("internlm2-1.8b").config
    tcfg = tregistry.get("internlm2-1.8b").config
    shape = ShapeSpec("train_4k", 4096, 256, "train")
    host = tmesh.HostMesh()
    assert tsteps.seq_axis_for(tcfg, shape) is None
    assert tsteps.dp_for(shape, host) == ("data",)
    assert tsteps.microbatches(tcfg, shape, host) == 2 == \
        tsteps.microbatches(tcfg, shape)
    for got, want in ((tsteps.batch_pspec(tcfg, shape, ("data",)),
                       jsteps.batch_pspec(jcfg, shape, ("data",))),
                      (tsteps.param_pspecs(tcfg), jsteps.param_pspecs(jcfg)),
                      (tsteps.decode_state_pspecs(tcfg, ("data",)),
                       jsteps.decode_state_pspecs(jcfg, ("data",)))):
        flat = jax.tree.leaves(want, is_leaf=lambda x: isinstance(x, JP))
        assert [tuple(s) for s in flat] == \
            [tuple(s) for s in tree_leaves_sorted(got)]
    prog = tsteps.build_step_program(tcfg, shape, host)
    assert prog.name == "internlm2-1.8b:train_4k:train"
    comps = tsteps.cost_programs(tcfg, shape, host)
    want = jsteps.cost_programs(jcfg, JShape("train_4k", 4096, 256, "train"),
                                jmesh.make_host_mesh(1, 1))
    assert [(c.name, c.multiplier) for c in comps] == \
        [(c.name, c.multiplier) for c in want] == \
        [("block_fwdbwd", 48), ("outside_fwdbwd", 2), ("optimizer", 1.0)]
    block = tsteps.lower_program(comps[0], host)
    assert block.collectives() == {}
    assert block.cost_analysis()["flops"] > 0
    assert block.memory_analysis().argument_size_in_bytes == sum(
        t.numel() * t.element_size() for a in comps[0].args
        for t in tree_leaves_sorted(a))


# ---------------------------------------------------------------------------
# launch.train on an LM
# ---------------------------------------------------------------------------

LAUNCH = ["--arch", "internlm2-1.8b", "--smoke", "--steps", "8",
          "--global-batch", "4", "--seq-len", "16", "--device", "cpu"]


def test_lm_launcher_crash_and_resume():
    """Checkpoints every 2 steps, a crash at step 5: the rerun resumes from
    step 4 and ends bit for bit where an uninterrupted run does (the
    reference's own test holds its runs within 1e-5)."""
    with tempfile.TemporaryDirectory() as d:
        ck = ["--ckpt-dir", d, "--ckpt-every", "2"]
        with pytest.raises(RuntimeError, match="injected failure"):
            ttrain.main(LAUNCH + ck + ["--fail-at-step", "5"])
        assert tmanager.latest_step(d) == 4
        resumed = ttrain.main(LAUNCH + ck)
    full = ttrain.main(LAUNCH)
    assert resumed.resumed_from == 4 and resumed.losses == full.losses[4:]
    for a, b in zip(tree_leaves(resumed.params), tree_leaves(full.params)):
        assert torch.equal(a, b)
    for a, b in zip(tree_leaves(resumed.opt_state), tree_leaves(full.opt_state)):
        assert torch.equal(a, b)


def test_lm_launcher_loss_falls():
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        run = ttrain.main(["--arch", "internlm2-1.8b", "--smoke", "--steps",
                           "30", "--global-batch", "8", "--seq-len", "32",
                           "--device", "cpu"])
    lines = [ln for ln in buf.getvalue().splitlines() if ln.startswith("step")]
    assert len(lines) == len(run.losses) == 30
    assert run.losses[-1] < run.losses[0] - 0.1
    assert run.cfg == tregistry.get("internlm2-1.8b").smoke


@pytest.mark.parametrize("name", ["granite-moe-3b-a800m", "rwkv6-3b",
                                  "hymba-1.5b", "whisper-large-v3"])
def test_lm_launcher_runs_every_family(name):
    run = ttrain.main(["--arch", name, "--smoke", "--steps", "3",
                       "--global-batch", "2", "--seq-len", "16",
                       "--device", "cpu"])
    assert len(run.losses) == 3 and all(np.isfinite(run.losses))
    assert run.qat_spec is None and run.export is None


def test_lm_launcher_needs_a_device_unless_cpu_is_asked_for(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ttrain.main(["--arch", "internlm2-1.8b", "--smoke", "--steps", "1"])
