"""The serving-cell and LM example twins (``repro_torch.examples``:
cell_soak, cell_flight_drill, serve_batched, train_lm) against the
reference's ``examples/*.py``.

As in tests/test_torch_examples_kws.py: each twin's reporting part runs
on the reference's weights and is held to the reference's numbers at the
same arguments, each training loop from the reference's init to the
reference's loop, and each ``main`` runs with ``--device cpu`` at
arguments where the reference's example exits 0, and raises without a
card when ``--device`` is not given.  The reference's ``main`` runs only
where it is cheap (``launch.serve.main`` and ``launch.train.main`` on the
smoke configs).

Terms, beside what was measured on this host (PERF.md §6):

* the soak's hop ledger (45 hops of 3 streams at ``--hops 12``, drawn
  from a numpy seed), swaps and generation: exact; the post-swap probe
  logits of the reference's swapped-in artifact: exact (the ``lut`` plan
  is an integer pipeline);
* the drill: one dump, ``shed_spike``, 13 hops in the trace, as the
  reference's own run prints;
* the served tokens: exact, request by request, on ``float`` and
  ``lut_float``;
* the LM losses as printed (``%.4f``) and the weights after the steps
  within ``TRAIN_ATOL`` 1e-4 (measured below 1e-5); the soak's boot
  artifact from the reference's init: every code equal.
"""

import contextlib
import importlib.util
import io
import pathlib
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import runtime as jrt
from repro.configs import registry as jregistry
from repro.launch import serve as jserve
from repro.launch import stream_serve as jstream_serve
from repro.launch import train as jtrain
from repro.models import kwt as jkwt
from repro.models import transformer as JT
from repro.stream import features as jfeatures
from repro_torch import convert
from repro_torch import runtime as trt
from repro_torch.configs import registry as tregistry
from repro_torch.core import quant as tquant
from repro_torch.core.tree import tree_leaves_sorted
from repro_torch.examples import cell_flight_drill, cell_soak
from repro_torch.examples import serve_batched, train_lm
from repro_torch.launch import serve as tserve
from repro_torch.launch import train as ttrain
from repro_torch.models import transformer as TT
from repro_torch.stream import features as tfeatures

torch.set_num_threads(1)

TRAIN_ATOL = 1e-4
CPU = torch.device("cpu")
ROOT = pathlib.Path(__file__).resolve().parents[1]
JSMOKE = jregistry.get("kwt-tiny").smoke
TSMOKE = tregistry.get("kwt-tiny").smoke
SOAK_ARGV = ["--streams", "3", "--slots", "2", "--hops", "12",
             "--train-steps", "2", "--qat-steps", "1"]
SOAK_HOPS = 45          # the reference's run at SOAK_ARGV: soak_done hops=45


def _ref_example(name):
    spec = importlib.util.spec_from_file_location(
        f"ref_example_{name}", ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _port(tree):
    return convert.from_numpy_tree(jax.tree.map(np.asarray, tree), "cpu")


def _codes(tree):
    return [leaf.int_values().numpy() if isinstance(leaf, tquant.QTensor)
            else leaf.detach().numpy() for leaf in tree_leaves_sorted(tree)]


def _ref_codes(tree):
    return [np.asarray(leaf.int_values()) if hasattr(leaf, "int_values")
            else np.asarray(leaf) for leaf in
            jax.tree.leaves(tree, is_leaf=lambda x: hasattr(x, "int_values"))]


# ---------------------------------------------------------------------------
# cell_soak
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def ref_soak():
    """The reference's boot and published artifacts at SOAK_ARGV, made by
    its own ``qat_artifact`` from its ``train_params``."""
    ref = _ref_example("cell_soak")
    fcfg = jfeatures.FrontendConfig()
    fparams = jstream_serve.train_params(JSMOKE, fcfg, 2, 0)
    ex1, fparams = ref.qat_artifact(JSMOKE, fparams, 1, 0)
    ex2, _ = ref.qat_artifact(JSMOKE, fparams, 1, 1)
    return ex1, ex2


def test_cell_soak_on_reference_artifacts(ref_soak, capsys):
    ex1, ex2 = ref_soak
    args = cell_soak.parser().parse_args(SOAK_ARGV + ["--device", "cpu"])
    published = []

    def publish():
        published.append(True)
        return _port(ex2.qparams), int(ex2.quantized_bytes[0])

    got = cell_soak.soak(TSMOKE, _port(ex1.qparams), publish, args, CPU)
    assert got["rc"] == 0, got["failures"]
    assert published == [True]
    assert got["hops"] == got["offered_hops"] == SOAK_HOPS
    assert got["swaps"] == 1 and got["generation"] == 1
    probe = np.zeros((1,) + tuple(JSMOKE.input_dim), np.float32)
    want = jrt.compile_model(JSMOKE, ex2.qparams, backend="lut").forward(
        jnp.asarray(probe))
    assert np.array_equal(got["probe_logits"].numpy(), np.asarray(want))
    assert "soak_done" in capsys.readouterr().out


def test_cell_soak_train_matches_reference(ref_soak):
    """The boot artifact from the reference's init: train_params (2 steps)
    then one QAT step and the export, every packed code equal."""
    ex1, _ = ref_soak
    args = cell_soak.parser().parse_args(SOAK_ARGV + ["--device", "cpu"])
    init = _port(jkwt.init_params(JSMOKE, jax.random.PRNGKey(0)))
    qparams1, _ = cell_soak.train(TSMOKE, tfeatures.FrontendConfig(), args,
                                  CPU, init=init)
    got, want = _codes(qparams1), _ref_codes(ex1.qparams)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        if g.dtype.kind == "f":
            np.testing.assert_allclose(g, w, rtol=0, atol=TRAIN_ATOL)
        else:
            assert np.array_equal(g, w)


def test_cell_soak_main_cpu_and_card_default(capsys):
    assert cell_soak.main(SOAK_ARGV + ["--device", "cpu"]) == 0
    out = capsys.readouterr().out
    done = re.search(r"event=soak_done .*", out).group(0)
    assert f"hops={SOAK_HOPS} swaps=1 generation=1 failures=0" in done
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            cell_soak.main(SOAK_ARGV)


# ---------------------------------------------------------------------------
# cell_flight_drill
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("backend", ["lut", "cuda"])
def test_flight_drill_on_reference_weights(backend, tmp_path, capsys):
    """At ``--hops 12`` on the reference's init: one dump, shed_spike, a
    named stage, the trace of the last 13 hops (the reference's run)."""
    tp = _port(jkwt.init_params(JSMOKE, jax.random.PRNGKey(0)))
    got = cell_flight_drill.drill(TSMOKE, tp, backend, 12, str(tmp_path), CPU)
    assert got["rc"] == 0, got["failures"]
    art = got["artifact"]
    assert len(got["dumps"]) == 1
    assert got["dumps"][0].endswith("flight_000_shed_spike.json")
    assert art["reason"] == "shed_spike" and art["window_hops"] == 13
    assert art["attribution"]["slowest_stage"] in ("featurise", "embed",
                                                   "encode")
    assert "trace holds the last 13 hops" in capsys.readouterr().out


def test_flight_drill_main_cpu_and_card_default(tmp_path):
    assert cell_flight_drill.main(["--hops", "12", "--dump-dir",
                                   str(tmp_path), "--device", "cpu"]) == 0
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            cell_flight_drill.main(["--dump-dir", str(tmp_path)])


# ---------------------------------------------------------------------------
# serve_batched
# ---------------------------------------------------------------------------

SERVE_BASE = ["--arch", "internlm2-1.8b", "--smoke", "--requests", "8",
              "--slots", "4", "--max-len", "48"]


@pytest.mark.parametrize("backend", ["float", "lut_float"])
def test_serve_batched_tokens_on_reference_weights(backend, monkeypatch):
    """The served tokens of each request, the reference's weights in
    both: ``launch.serve.main`` of each package at the twin's command."""
    argv = SERVE_BASE + ["--backend", backend]
    with contextlib.redirect_stdout(io.StringIO()):
        want = jserve.main(argv)
    jcfg = jregistry.get("internlm2-1.8b").smoke
    tp = _port(JT.init_params(jcfg, jax.random.PRNGKey(0)))

    def build_engine(cfg, backend, seed, device, *, attention=None):
        return trt.compile_model(cfg, tp, backend=backend, device=device,
                                 attention=attention)

    monkeypatch.setattr(tserve, "build_engine", build_engine)
    with contextlib.redirect_stdout(io.StringIO()):
        got = tserve.main(argv + ["--device", "cpu"])
    assert sorted(got) == sorted(want)
    for rid in want:
        assert list(got[rid]) == [int(t) for t in want[rid]], rid
    assert sum(len(v) for v in got.values()) == 117


def test_serve_batched_main_cpu_and_card_default(capsys):
    assert serve_batched.main(["--device", "cpu"]) == 0
    out = capsys.readouterr().out
    done = re.findall(r"event=serve_done ts=\S+ requests=8 tokens=(\d+) "
                      r".*?backend=(\w+)", out)
    assert done == [("117", "float"), ("117", "lut_float")]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            serve_batched.main([])


# ---------------------------------------------------------------------------
# train_lm
# ---------------------------------------------------------------------------

def test_train_lm_loop_matches_reference(monkeypatch):
    """``--steps 3`` on the reference's init: the losses as printed and
    the weights after the steps."""
    args = train_lm.parser().parse_args(["--steps", "3", "--device", "cpu"])
    argv = train_lm.launcher_argv(args)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        jparams = jtrain.main(argv[:-2])
    want = re.findall(r"loss (\d+\.\d{4})", buf.getvalue())
    jcfg = jregistry.get("granite-8b").smoke
    init = _port(JT.init_params(jcfg, jax.random.PRNGKey(0)))
    monkeypatch.setattr(TT, "init_params", lambda cfg, gen, device: init)
    with contextlib.redirect_stdout(io.StringIO()):
        res = ttrain.main(argv)
    assert [f"{v:.4f}" for v in res.losses] == want and len(want) == 3
    got, ref = tree_leaves_sorted(res.params), jax.tree.leaves(jparams)
    assert len(got) == len(ref)
    for g, w in zip(got, ref):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w),
                                   rtol=0, atol=TRAIN_ATOL)


def test_train_lm_main_cpu_and_card_default(tmp_path, capsys):
    assert train_lm.main(["--steps", "3", "--ckpt-dir", str(tmp_path),
                          "--device", "cpu"]) == 0
    assert "training complete." in capsys.readouterr().out
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            train_lm.main(["--steps", "1"])


def test_train_lm_hundred_m_puts_the_entry_back(monkeypatch):
    """``--hundred-m`` stands the 110 M config in for granite-8b's smoke
    config during the run only: later callers of the registry see the
    smoke config again (the launcher stubbed: 110 M steps on the CPU)."""
    seen = []
    smoke = tregistry.get("granite-8b").smoke
    monkeypatch.setattr(ttrain, "main", lambda argv: seen.append(
        (argv, tregistry.get("granite-8b").smoke)))
    assert train_lm.main(["--hundred-m", "--steps", "1",
                          "--device", "cpu"]) == 0
    (argv, cfg), = seen
    assert "256" in argv and cfg.n_layers == 12 and cfg.d_model == 768
    assert cfg == train_lm.hundred_m_config()
    assert tregistry.get("granite-8b").smoke == smoke
