"""The KWT example twins (``repro_torch.examples``: quickstart, stream_kws,
quantize_eval, train_kws_qat) against the reference's ``examples/*.py``.

Each twin's reporting part gets the reference's weights (trained by the
reference's own loop, carried across as numpy) and is held to the
numbers the reference computes from them at the same arguments; each
twin's training loop, started from the reference's init, is held to the
reference's loop over a few steps; each twin's ``main`` runs with
``--device cpu`` at arguments where the reference's example exits 0 and
raises without a card when ``--device`` is not given.  The reference's
``main`` is not run (it compiles for 17–47 s an example here): its
functions are, at the same arguments, or its loop written out.

Terms, beside what was measured on this host (PERF.md §6):

* accuracies, ROM bytes, the Table V rows, fired hops: exact on the
  integer plans (``lut``, ``cuda``), and on ``float`` every sample's
  argmax equal, so the accuracy too;
* the detector's scores ``SCORE_ATOL`` 1e-5 (a float32 softmax of the
  same logits, measured 0.0), so equal as printed (``%.2f``);
* the LM losses ``LOSS_ATOL`` 1e-5;
* a training loop over a few steps from the same init: ``TRAIN_ATOL``
  1e-4 on every leaf but the key bias, whose gradient is zero in exact
  arithmetic, so that AdamW turns either package's rounding noise into a
  step of up to lr (held within 2.2 lr a step, as tests/test_torch_qat.py
  does); measured below 1e-5 on the other leaves.
"""

import importlib.util
import pathlib
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import qat as jqat
from repro import runtime as jrt
from repro.configs import registry as jregistry
from repro.core import calibrate as jcalibrate
from repro.data import pipeline as jpipeline
from repro.launch import stream_serve as jstream_serve
from repro.models import kwt as jkwt
from repro.models import transformer as JT
from repro.optim import adamw as jadamw
from repro.qat import distill as jdistill
from repro.stream import detector as jdet
from repro.stream import engine as jengine
from repro.stream import features as jfeatures
from repro_torch import convert
from repro_torch import qat as tqat
from repro_torch import runtime as trt
from repro_torch.configs import registry as tregistry
from repro_torch.core.tree import tree_leaves_sorted
from repro_torch.data import pipeline as tpipeline
from repro_torch.examples import quantize_eval, quickstart, stream_kws
from repro_torch.examples import train_kws_qat
from repro_torch.examples._common import plan
from repro_torch.stream import features as tfeatures

torch.set_num_threads(1)

SCORE_ATOL = 1e-5
LOSS_ATOL = 1e-5
TRAIN_ATOL = 1e-4
KEY_BIAS_LRS = 2.2
CPU = torch.device("cpu")
ROOT = pathlib.Path(__file__).resolve().parents[1]

JTINY = jregistry.get("kwt-tiny").config
TTINY = tregistry.get("kwt-tiny").config


def _ref_example(name):
    """The reference's ``examples/<name>.py`` as a module (its ``main`` is
    not called)."""
    spec = importlib.util.spec_from_file_location(
        f"ref_example_{name}", ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _port(tree):
    return convert.from_numpy_tree(jax.tree.map(np.asarray, tree), "cpu")


def _hp(steps):
    return dict(lr=3e-3, warmup_steps=20, total_steps=steps, weight_decay=0.0)


def _ref_train(jcfg, params, steps):
    """The loop of the reference's quickstart and quantize_eval."""
    hp = jadamw.HParams(**_hp(steps))
    state = jadamw.init(params, hp)

    @jax.jit
    def step(params, state, batch):
        loss, grads = jax.value_and_grad(jkwt.loss_fn)(params, batch, jcfg)
        params, state, _ = jadamw.update(grads, state, params, hp,
                                         scan_stacked=False)
        return params, state, loss

    for i in range(steps):
        batch = jpipeline.keyword_batch(0, i, batch=64,
                                        input_dim=jcfg.input_dim,
                                        n_classes=jcfg.n_classes)
        params, state, _ = step(params, state, batch)
    return params


def _lrs(steps, n, warmup=20, lr=3e-3):
    """The learning rates of the first ``n`` steps' updates."""
    hp = jadamw.HParams(**{**_hp(steps), "warmup_steps": warmup, "lr": lr})
    return [float(jadamw.schedule(jnp.asarray(i + 1), hp)) for i in range(n)]


def _assert_trained_close(tp, jp, lrs):
    """Leaves within TRAIN_ATOL; the key bias within 2.2 lr a step."""
    got, want = tree_leaves_sorted(tp), jax.tree.leaves(jp)
    assert len(got) == len(want)
    paths = [jax.tree_util.keystr(p) for p, _ in
             jax.tree_util.tree_flatten_with_path(jp)[0]]
    for path, g, w in zip(paths, got, want):
        tol = KEY_BIAS_LRS * sum(lrs) if "'bk'" in path else TRAIN_ATOL
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w),
                                   rtol=0, atol=tol, err_msg=path)


@pytest.fixture(scope="module")
def ref_init():
    return jkwt.init_params(JTINY, jax.random.PRNGKey(0))


@pytest.fixture(scope="module")
def ref_trained(ref_init):
    """KWT-Tiny after the reference's 5 steps (quickstart --steps 5)."""
    return _ref_train(JTINY, ref_init, 5)


def _ref_accuracy_and_preds(eng, n):
    preds, labels = [], []
    for b in jpipeline.gsc_eval_set(0, n=n, input_dim=eng.cfg.input_dim):
        preds.append(np.asarray(jnp.argmax(eng.forward(b["mfcc"]), -1)))
        labels.append(np.asarray(b["labels"]))
    p, y = np.concatenate(preds), np.concatenate(labels)
    return float(np.mean(p == y)), p


def _port_preds(eng, n):
    return np.concatenate([
        eng.forward(b["mfcc"]).argmax(-1).numpy()
        for b in tpipeline.gsc_eval_set(0, n=n, input_dim=eng.cfg.input_dim)])


# ---------------------------------------------------------------------------
# quickstart
# ---------------------------------------------------------------------------

def test_quickstart_train_loop_matches_reference(ref_init, ref_trained):
    got = quickstart.train(TTINY, _port(ref_init), 5, CPU, log=lambda s: None)
    _assert_trained_close(got, ref_trained, _lrs(5, 5))


@pytest.mark.parametrize("backend,ref_backend", [("lut", "lut"),
                                                 ("cuda", "pallas")])
def test_quickstart_report_on_reference_weights(ref_trained, backend,
                                                ref_backend, capsys):
    """The staircase at ``--steps 5 --eval-n 64``: each stage's accuracy
    the reference's (argmax per sample on the float ones), the ROM bytes
    and the plan line."""
    n = 64
    want_f, jpf = _ref_accuracy_and_preds(
        jrt.compile_model(JTINY, ref_trained, backend="float"), n)
    eng_q = jrt.compile_model(JTINY, ref_trained, backend="float",
                              recipe=jrt.QuantRecipe.from_config(JTINY))
    want_q, jpq = _ref_accuracy_and_preds(eng_q, n)
    eng_h = jrt.compile_model(JTINY, ref_trained, backend=ref_backend)
    want_h, _ = _ref_accuracy_and_preds(eng_h, n)
    tp = _port(ref_trained)
    got = quickstart.report(TTINY, tp, backend, n, CPU)
    assert got["float"] == want_f and got["ptq"] == want_q
    assert got["backend"] == want_h
    assert got["rom_bytes"] == eng_q.rom_bytes == 1500
    out = capsys.readouterr().out
    assert f"[1] float32 accuracy:            {want_f:.3f}" in out
    assert f"[2] int8 PTQ (w=2^6, Table V):   {want_q:.3f}  (1500 packed" \
        in out
    assert f"    accuracy:                    {want_h:.3f}  " in out
    assert "rom 1500 B, lut 2688 B, w=2^6/x=2^5 int8 nearest int-exec" in out
    # the float stages: every sample's argmax
    assert np.array_equal(_port_preds(plan(TTINY, tp, "float", CPU), n), jpf)
    assert np.array_equal(_port_preds(plan(
        TTINY, tp, "float", CPU, recipe=trt.QuantRecipe.from_config(TTINY)),
        n), jpq)


def test_quickstart_main_cpu_and_card_default(capsys):
    assert quickstart.main(["--steps", "5", "--eval-n", "64",
                            "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "parameters: 1646 (paper Table IV: 1646)" in out
    assert "[3] Engine[lut] kwt-tiny on cpu" in out
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            quickstart.main(["--steps", "1"])


# ---------------------------------------------------------------------------
# stream_kws
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def stream_trained():
    """The reference's ``train_params`` at stream_kws's defaults (150
    steps, seed 0)."""
    return jstream_serve.train_params(JTINY, jfeatures.FrontendConfig(),
                                      150, 0)


def _ref_stream(params, backend, hops=400, k=2, seed=0):
    """The reference's stream loop (``examples/stream_kws.py``)."""
    fcfg, dcfg = jfeatures.FrontendConfig(), jdet.DetectorConfig()
    eng = jrt.compile_model(JTINY, params, backend=backend)
    cfg, p = eng.exec_cfg, eng.params
    audio, truth = jpipeline.keyword_event_stream(
        seed + 1, 0, n_hops=hops, hop_len=fcfg.hop_len)
    state = jengine.init_stream_state(cfg, fcfg, 1)
    dstate = jdet.detector_init(dcfg, 1)

    @jax.jit
    def step(params, state, dstate, chunk):
        state, logits = jengine.stream_step(params, state, chunk, cfg, fcfg)
        dstate, events = jdet.detector_step(
            dstate, jengine.posteriors(logits), dcfg,
            warm=jengine.warm(state))
        return state, dstate, events

    fired, scores = [], []
    for h in range(0, hops, k):
        chunk = jnp.asarray(audio[None, h * fcfg.hop_len:
                                  h * fcfg.hop_len + k * fcfg.hop_len])
        state, dstate, ev = step(p, state, dstate, chunk)
        if bool(ev["fired"][0]):
            fired.append(h + k)
            scores.append(float(ev["score"][0]))
    return fired, scores, truth


def test_stream_kws_report_on_reference_weights(stream_trained, capsys):
    """Fired hops and scores of the default stream on ``lut`` (the
    reference's own run: 4 keywords, fired at hops 42, 134, 266, 384,
    score 0.80, 4/4 hit)."""
    fired, scores, truth = _ref_stream(stream_trained, "lut")
    got = stream_kws.report(TTINY, _port(stream_trained), "lut", 400, 2, 0,
                            CPU)
    assert got["rc"] == 0 and got["truth"] == truth
    assert got["fired"] == fired and got["hits"] == len(truth) > 0
    np.testing.assert_allclose(got["scores"], scores, rtol=0, atol=SCORE_ATOL)
    out = capsys.readouterr().out
    assert f"detected {len(fired)} events; {len(truth)}/{len(truth)} " \
        "keywords hit" in out
    for hop, score in zip(fired, scores):
        assert f"(hop {hop}, score {score:.2f})" in out


def test_stream_kws_train_loop_matches_reference():
    fcfg = jfeatures.FrontendConfig()
    init = jkwt.init_params(JTINY, jax.random.PRNGKey(3))
    want = jstream_serve.train_params(JTINY, fcfg, 3, 3)
    got = stream_kws.train_params(TTINY, tfeatures.FrontendConfig(), 3, 3,
                                  CPU, init=_port(init))
    _assert_trained_close(got, want, _lrs(3, 3, warmup=2))


def test_stream_kws_main_cpu_and_card_default(capsys):
    """The reference's defaults on ``lut``, where its example exits 0."""
    assert stream_kws.main(["--backend", "lut", "--device", "cpu"]) == 0
    assert "streaming demo complete." in capsys.readouterr().out
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            stream_kws.main(["--train-steps", "1"])


# ---------------------------------------------------------------------------
# quantize_eval
# ---------------------------------------------------------------------------

def test_quantize_eval_kwt_rows_on_reference_weights(ref_trained, capsys):
    """The Table V rows at ``--steps 5``: accuracy and bytes per pair."""
    batches = [(b["mfcc"], b["labels"]) for b in jpipeline.gsc_eval_set(
        0, n=512, input_dim=JTINY.input_dim, n_classes=JTINY.n_classes)]
    want = jcalibrate.sweep_scale_factors(
        lambda p, x: jkwt.forward(p, x, JTINY), ref_trained, batches,
        pairs=quantize_eval.PAIRS)
    got = quantize_eval.report_kwt(TTINY, _port(ref_trained), CPU)
    assert [(r.weight_exponent, r.input_exponent, r.accuracy,
             r.quantized_bytes) for r in got] == \
        [(r.weight_exponent, r.input_exponent, r.accuracy, r.quantized_bytes)
         for r in want]
    out = capsys.readouterr().out
    assert "2^6 ( 64), 2^5 ( 32), " in out


def test_quantize_eval_train_loop_matches_reference(ref_init, ref_trained):
    got = quantize_eval.train(TTINY, _port(ref_init), 5, CPU,
                              log=lambda line: None)
    _assert_trained_close(got, ref_trained, _lrs(5, 5))


def test_quantize_eval_lm_losses_on_reference_weights(capsys):
    """The LM branch on the internlm2 smoke config: the float loss and
    the ``lut_float`` loss at each weight exponent, with the engine's
    params (embed and head packed) fed to ``loss_fn``."""
    name = "internlm2-1.8b"
    jcfg, tcfg = jregistry.get(name).smoke, tregistry.get(name).smoke
    jp = JT.init_params(jcfg, jax.random.PRNGKey(0))
    batch = jpipeline.lm_batch(0, 0, global_batch=4, seq_len=32,
                               vocab_size=jcfg.vocab_size)
    want = {"float": float(JT.loss_fn(jp, batch, jcfg))}
    for wexp in quantize_eval.LM_WEXPS:
        eng = jrt.compile_model(jcfg, jp, backend="lut_float",
                                recipe=jrt.QuantRecipe.from_config(
                                    jcfg, weight_exponent=wexp))
        want[wexp] = float(JT.loss_fn(eng.params, batch, eng.exec_cfg))
    got = quantize_eval.report_lm(name, tcfg, _port(jp), CPU)
    assert set(got) == set(want)
    for k in want:
        assert abs(got[k] - want[k]) <= LOSS_ATOL, k
    assert f"{name}: float loss {want['float']:.4f}" in capsys.readouterr().out


def test_quantize_eval_main_cpu_and_card_default(capsys):
    assert quantize_eval.main(["--steps", "5", "--device", "cpu"]) == 0
    assert quantize_eval.main(["--arch", "internlm2-1.8b",
                               "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "weights, inputs, accuracy, int8 bytes   (paper Table V)" in out
    assert "  w=2^7: quantised+LUT loss " in out
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            quantize_eval.main(["--steps", "1"])


# ---------------------------------------------------------------------------
# train_kws_qat
# ---------------------------------------------------------------------------

QAT_ARGV = ["--steps", "5", "--qat-steps", "2", "--eval-n", "64"]


@pytest.fixture(scope="module")
def ref_qat():
    """The reference's float baseline (5 steps) and its QAT run (2 steps
    with the example's selection fold), as ``examples/train_kws_qat.py``
    makes them."""
    ref = _ref_example("train_kws_qat")
    fparams = jdistill.train_teacher(JTINY, 5, seed=0, lr=3e-3)
    recipe = jrt.QuantRecipe.from_config(JTINY, bits=8)
    spec = jqat.QATSpec(recipe, jqat.QATConfig(backend="lut"))
    qparams, qstate = jqat.finetune_qat(
        JTINY, fparams, spec, 2, seed=0,
        select_fn=ref.make_eval(JTINY, spec.exec_cfg(JTINY), 5, 256))
    ex = jqat.export(qparams, spec, qstate)
    accs = {
        "float": ref.accuracy(jrt.compile_model(JTINY, fparams,
                                                backend="float"), 64),
        "ptq": ref.accuracy(jrt.compile_model(JTINY, fparams, backend="lut",
                                              recipe=recipe), 64),
        "qat": ref.accuracy(jrt.compile_model(JTINY, ex.params,
                                              backend="lut",
                                              recipe=ex.recipe), 64)}
    return types.SimpleNamespace(fparams=fparams, qparams=qparams,
                                 qstate=qstate, accs=accs)


def test_train_kws_qat_report_on_reference_weights(ref_qat, capsys):
    """Float, PTQ and QAT accuracies of the reference's weights at the
    reference's arguments (QAT: the reference's own QAT weights, through
    ``qat_fn``), and the export contract on them."""
    args = train_kws_qat.parser().parse_args(QAT_ARGV + ["--device", "cpu"])

    def ref_qat_fn(cfg, fparams, recipe, args, device, distill):
        spec = tqat.QATSpec(recipe, tqat.QATConfig(backend="lut"))
        qstate = {k: torch.from_numpy(np.array(v))
                  for k, v in ref_qat.qstate.items()}
        return _port(ref_qat.qparams), spec, qstate

    got = train_kws_qat.report(TTINY, _port(ref_qat.fparams), args, CPU,
                               qat_fn=ref_qat_fn)
    assert got["rc"] == 0
    assert {k: got[k] for k in ("float", "ptq", "qat")} == ref_qat.accs
    out = capsys.readouterr().out
    assert "[4] export parity: QAT eval logits BIT-IDENTICAL" in out


def test_train_kws_qat_loops_match_reference(ref_init, ref_qat):
    """The float loop from the reference's init, and the QAT fine-tune
    from the reference's float weights, against the reference's."""
    args = train_kws_qat.parser().parse_args(QAT_ARGV + ["--device", "cpu"])
    fparams = train_kws_qat.train_float(TTINY, args, CPU,
                                        init=_port(ref_init))
    _assert_trained_close(fparams, ref_qat.fparams,
                          _lrs(10, 5, warmup=2))
    recipe = train_kws_qat.recipe_for(TTINY, _port(ref_qat.fparams), 8)
    qparams, _, qstate = train_kws_qat.train_qat(
        TTINY, _port(ref_qat.fparams), recipe, args, CPU)
    _assert_trained_close(qparams, ref_qat.qparams,
                          _lrs(10, 2, warmup=2, lr=1e-3))
    assert int(qstate["step"]) == int(ref_qat.qstate["step"])


@pytest.mark.parametrize("extra", [["--check-backends"],
                                   ["--qat-backend", "cuda", "--bits", "4"]])
def test_train_kws_qat_main_cpu(extra, tmp_path, capsys):
    """``--steps 5 --qat-steps 2 --eval-n 64``: the reference exits 1 here
    on its flaky export check (ROADMAP C2); the twin holds the contract
    and exits 0, through the artifact's save/load round trip too."""
    argv = QAT_ARGV + extra + ["--export-path", str(tmp_path / "art"),
                               "--device", "cpu"]
    assert train_kws_qat.main(argv) == 0
    out = capsys.readouterr().out
    assert "reloaded packed artifact BIT-IDENTICAL" in out
    assert "qat demo complete." in out
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            train_kws_qat.main(["--steps", "1"])
