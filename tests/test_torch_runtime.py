"""The slice as a whole: ``repro_torch.runtime.compile_model(...).forward``
against ``repro.runtime.compile_model(...).forward`` on converted params.

Stated tolerances, with the errors measured behind them (4 weight seeds x
batch 1/8/64, this file's generator, PyTorch CPU vs XLA:CPU):

* ``float``: atol 1e-4.  Measured max 6.0e-7 (KWT-Tiny), 1.5e-6 (KWT-1 at
  2 layers) — reduction order in LayerNorm and the float products.
* ``lut`` / ``lut_float`` on KWT-Tiny: 2^-5 on any logit — one activation
  LSB, which a one-ulp LayerNorm difference in front of
  ``floor(x*32 + 0.5)`` could flip.  Measured: ``lut`` 0.0 (bit-identical
  in all 12 runs), ``lut_float`` 7.2e-7.
* ``lut`` / ``lut_float`` on KWT-1 at 2 layers: most runs are
  bit-identical (``lut``) or within 1.5e-6 (``lut_float``); where an LSB
  or a LUT bin does flip, the second layer amplifies it: measured worst
  0.068 on the logits of ONE sample of 64.  Stated: every logit within
  0.25, and at most 2 samples of a batch further than 1e-4 apart.
"""

import pathlib
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import runtime as jrt
from repro.configs import registry as jregistry
from repro.models import kwt as jkwt
from repro.runtime import recipe as jrecipe
from repro_torch import convert
from repro_torch import runtime as trt
from repro_torch.configs import registry as tregistry
from repro_torch.core import quant as tquant
from repro_torch.core import tree as ttree
from repro_torch.runtime import recipe as trecipe

torch.set_num_threads(1)


FLOAT_ATOL = 1e-4
TINY_LUT_ATOL = 2.0 ** -5
KWT1_LUT_ATOL = 0.25
KWT1_LUT_MAX_MOVED_SAMPLES = 2

MODELS = {"kwt-tiny": False, "kwt-1": True}     # name -> use smoke_config()


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


_CACHE = {}


def _setup(name, seed=0):
    key = (name, seed)
    if key not in _CACHE:
        je, te = jregistry.get(name), tregistry.get(name)
        jcfg, tcfg = (je.smoke, te.smoke) if MODELS[name] else \
            (je.config, te.config)
        npp = _np_params(jcfg, seed)
        _CACHE[key] = (jcfg, tcfg, jax.tree.map(jnp.asarray, npp),
                       convert.from_numpy_tree(npp, "cpu"))
    return _CACHE[key]


def _mfcc(cfg, batch, seed=0):
    rng = np.random.default_rng(100 + seed + batch)
    return rng.normal(0, 0.5, (batch, *cfg.input_dim)).astype(np.float32)


def _check_logits(name, backend, got, want):
    diff = np.abs(got - want)
    if backend == "float":
        assert diff.max() <= FLOAT_ATOL, diff.max()
    elif name == "kwt-tiny":
        assert diff.max() <= TINY_LUT_ATOL, diff.max()
    else:
        assert diff.max() <= KWT1_LUT_ATOL, diff.max()
        moved = int((diff.max(axis=-1) > 1e-4).sum())
        assert moved <= KWT1_LUT_MAX_MOVED_SAMPLES, moved


# ---------------------------------------------------------------------------
# the slice end to end
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", list(MODELS))
@pytest.mark.parametrize("backend", ["float", "lut_float", "lut"])
@pytest.mark.parametrize("batch", [1, 8, 64])
def test_forward_matches_reference(name, backend, batch):
    jcfg, tcfg, jp, tp = _setup(name)
    x = _mfcc(jcfg, batch)
    want = np.asarray(jrt.compile_model(jcfg, jp, backend=backend)
                      .forward(jnp.asarray(x)))
    eng = trt.compile_model(tcfg, tp, backend=backend, device="cpu")
    got = eng.forward(torch.from_numpy(x))
    assert got.dtype == torch.float32 and got.device.type == "cpu"
    assert tuple(got.shape) == (batch, tcfg.n_classes) == want.shape
    assert np.all(np.isfinite(got.numpy()))
    _check_logits(name, backend, got.numpy(), want)
    # numpy in is accepted too, and gives the same bits
    assert torch.equal(eng.forward(x), got)


@pytest.mark.parametrize("seed", [1, 3])
def test_lut_forward_second_seeds_within_stated_tolerance(seed):
    """Seeds whose KWT-1 run does move one sample (see the module text)."""
    for name in MODELS:
        jcfg, tcfg, jp, tp = _setup(name, seed)
        x = _mfcc(jcfg, 64, seed)
        want = np.asarray(jrt.compile_model(jcfg, jp, backend="lut")
                          .forward(jnp.asarray(x)))
        got = trt.compile_model(tcfg, tp, backend="lut", device="cpu") \
            .forward(torch.from_numpy(x)).numpy()
        _check_logits(name, "lut", got, want)


def test_port_lut_plan_is_what_the_kernel_plan_must_reproduce():
    """The reference's ``lut`` logits equal its ``pallas`` (kernel) logits,
    so the port's ``lut`` plan on the CPU — held against the reference
    above — is what the ``cuda`` plan has to reproduce on the card."""
    jcfg, tcfg, jp, tp = _setup("kwt-tiny")
    x = _mfcc(jcfg, 8)
    jl = np.asarray(jrt.compile_model(jcfg, jp, backend="lut")
                    .forward(jnp.asarray(x)))
    jk = np.asarray(jrt.compile_model(jcfg, jp, backend="pallas")
                    .forward(jnp.asarray(x)))
    assert np.array_equal(jl, jk)
    tl = trt.compile_model(tcfg, tp, backend="lut", device="cpu").forward(x)
    assert np.abs(tl.numpy() - jk).max() <= TINY_LUT_ATOL
    # the kernel modes themselves, taken through the plain versions on the
    # CPU, give the lut plan's bits: the wrappers pass the same operands
    eng = trt.compile_model(tcfg, tp, backend="lut", device="cpu")
    kcfg = eng.exec_cfg.with_(softmax_mode="cuda", act_approx="cuda")
    from repro_torch.models import kwt as tkwt
    with torch.inference_mode():
        tk = tkwt.forward(eng.params, torch.from_numpy(x), kcfg)
    assert torch.equal(tk, tl)


@pytest.mark.parametrize("name", list(MODELS))
@pytest.mark.parametrize("backend", ["float", "lut"])
def test_embed_then_encode_is_forward(name, backend):
    jcfg, tcfg, _, tp = _setup(name)
    x = torch.from_numpy(_mfcc(jcfg, 4))
    eng = trt.compile_model(tcfg, tp, backend=backend, device="cpu")
    two_step = eng.encode_window(eng.embed_frames(x.transpose(1, 2)))
    assert torch.equal(two_step, eng.forward(x))


# ---------------------------------------------------------------------------
# recipes, residency, byte counts
# ---------------------------------------------------------------------------

RECIPES = {
    "int8": dict(),
    "int4": dict(bits=4, weight_exponent=2),
    "int8_per_channel": dict(per_channel=True),
    "int4_per_channel_floor": dict(bits=4, weight_exponent=2, per_channel=True,
                                   rounding="floor"),
}


@pytest.mark.parametrize("name", list(MODELS))
@pytest.mark.parametrize("recipe", list(RECIPES))
def test_quantised_tree_and_byte_counts_equal_reference(name, recipe):
    jcfg, tcfg, jp, tp = _setup(name)
    jr = jrt.QuantRecipe.from_config(jcfg, **RECIPES[recipe])
    tr = trt.QuantRecipe.from_config(tcfg, **RECIPES[recipe])
    assert tr.to_dict() == jr.to_dict()
    assert trt.QuantRecipe.from_dict(tr.to_dict()) == tr
    jq, tq = jr.quantize(jp), tr.quantize(tp)
    jleaves = jax.tree.leaves(jq, is_leaf=lambda x: hasattr(x, "exponent"))
    for jl, tl in zip(jleaves, ttree.tree_leaves(tq)):
        if hasattr(jl, "exponent"):
            assert np.array_equal(tl.values.numpy(), np.asarray(jl.values))
            assert tl.stored_bytes == jl.stored_bytes
            if jl.axis_exponents is not None:
                assert np.array_equal(tl.axis_exponents.numpy(),
                                      np.asarray(jl.axis_exponents))
        else:
            assert np.array_equal(tl.numpy(), np.asarray(jl))
    assert tr.quantized_bytes(tp) == jr.quantized_bytes(jp)
    for backend in ("float", "lut_float", "lut"):
        je = jrt.compile_model(jcfg, jp, backend=backend, recipe=jr)
        te = trt.compile_model(tcfg, tp, backend=backend, recipe=tr,
                               device="cpu")
        assert (te.rom_bytes, te.lut_bytes, te.param_bytes, te.int_resident,
                te.int_exec) == (je.rom_bytes, je.lut_bytes, je.param_bytes,
                                 je.int_resident, je.int_exec)
    if name == "kwt-tiny" and recipe in ("int8", "int4"):
        assert te.rom_bytes == {"int8": 1500, "int4": 750}[recipe]


def test_default_plans_byte_counts_and_describe():
    for name in MODELS:
        jcfg, tcfg, jp, tp = _setup(name)
        for backend in ("float", "lut_float", "lut"):
            je = jrt.compile_model(jcfg, jp, backend=backend)
            te = trt.compile_model(tcfg, tp, backend=backend, device="cpu")
            assert (te.rom_bytes, te.lut_bytes, te.param_bytes,
                    te.int_resident) == (je.rom_bytes, je.lut_bytes,
                                         je.param_bytes, je.int_resident)
            line = te.describe()
            assert line.startswith(f"Engine[{backend}] {tcfg.name} on cpu")
            assert f"rom {te.rom_bytes} B" in line
            assert te.backend_name == backend


def test_po2_fake_quant_and_calibrated_match_reference():
    rng = np.random.default_rng(5)
    w = rng.normal(0, 0.4, (24, 12)).astype(np.float32)
    w[:, 3] *= 40.0                       # one channel that must shift down
    for per_channel in (False, True):
        for rounding in ("nearest", "floor"):
            want = jrecipe.po2_fake_quant(jnp.asarray(w), 6, bits=8,
                                          rounding=rounding,
                                          per_channel=per_channel)
            got = trecipe.po2_fake_quant(torch.from_numpy(w), 6, bits=8,
                                         rounding=rounding,
                                         per_channel=per_channel)
            for g, w_ in zip(got, want):
                if w_ is None:
                    assert g is None
                else:
                    assert np.array_equal(g.numpy(), np.asarray(w_))
    jcfg, tcfg, jp, tp = _setup("kwt-tiny")
    assert trt.QuantRecipe.from_config(tcfg).calibrated(tp) == \
        trt.QuantRecipe.from_dict(
            jrt.QuantRecipe.from_config(jcfg).calibrated(jp).to_dict())


def test_prequantised_reference_tree_deploys_as_is():
    """A tree quantised by the reference, carried across as numpy, is
    deployed without re-quantisation and reports the artifact's recipe."""
    jcfg, tcfg, jp, _ = _setup("kwt-tiny")
    jr = jrt.QuantRecipe.from_config(jcfg, bits=4, weight_exponent=2,
                                     per_channel=True)
    jq = jr.quantize(jp)
    tq = convert.from_numpy_tree(jax.tree.map(np.asarray, jq), "cpu")
    x = _mfcc(jcfg, 8)
    je = jrt.compile_model(jcfg, jq, backend="lut")
    te = trt.compile_model(tcfg, tq, backend="lut", device="cpu")
    assert te.recipe.to_dict() == je.recipe.to_dict()
    assert (te.rom_bytes, te.param_bytes) == (je.rom_bytes, je.param_bytes)
    assert te.int_exec and te.int_resident
    got = te.forward(x).numpy()
    want = np.asarray(je.forward(jnp.asarray(x)))
    assert np.abs(got - want).max() <= TINY_LUT_ATOL


@pytest.mark.parametrize("integer_resident,integer_exec",
                         [(False, None), (True, False), (True, True)])
def test_residency_overrides_match_reference(integer_resident, integer_exec):
    jcfg, tcfg, jp, tp = _setup("kwt-tiny")
    x = _mfcc(jcfg, 8)
    je = jrt.compile_model(jcfg, jp, backend="lut",
                           integer_resident=integer_resident,
                           integer_exec=integer_exec)
    te = trt.compile_model(tcfg, tp, backend="lut", device="cpu",
                           integer_resident=integer_resident,
                           integer_exec=integer_exec)
    assert (te.int_resident, te.int_exec) == (je.int_resident, je.int_exec)
    assert all(isinstance(leaf, torch.Tensor)
               for leaf in ttree.tree_leaves(te.live_params())) == (not te.int_exec)
    got = te.forward(x).numpy()
    want = np.asarray(je.forward(jnp.asarray(x)))
    assert np.abs(got - want).max() <= TINY_LUT_ATOL
    if integer_resident and not integer_exec:
        # resident, not executing: same values as dequantise-first
        first = trt.compile_model(tcfg, tp, backend="lut", device="cpu",
                                  integer_resident=False)
        assert torch.equal(te.forward(x), first.forward(x))
        assert any(isinstance(leaf, tquant.QTensor)
                   for leaf in ttree.tree_leaves(te.params))


# ---------------------------------------------------------------------------
# backends and the device rule
# ---------------------------------------------------------------------------

def test_backend_registry_and_flags():
    assert set(trt.available_backends()) == {"float", "lut_float", "lut", "cuda"}
    for name in ("float", "lut_float", "lut"):
        jb, tb = jrt.get_backend(name), trt.get_backend(name)
        assert (tb.quantize, tb.uses_lut, tb.uses_kernels, tb.int_resident,
                tb.int_exec, tb.softmax_mode, tb.act_approx) == \
            (jb.quantize, jb.uses_lut, jb.uses_kernels, jb.int_resident,
             jb.int_exec, jb.softmax_mode, jb.act_approx)
    jb, tb = jrt.get_backend("pallas"), trt.get_backend("cuda")
    assert (tb.quantize, tb.uses_lut, tb.uses_kernels, tb.int_resident,
            tb.int_exec) == (jb.quantize, jb.uses_lut, jb.uses_kernels,
                             jb.int_resident, jb.int_exec)
    cfg = tregistry.get("kwt-tiny").config
    pinned = tb.configure(cfg)
    assert (pinned.softmax_mode, pinned.act_approx) == ("cuda", "cuda")
    with pytest.raises(KeyError, match="float"):
        trt.get_backend("pallas")


def test_cuda_backend_on_cpu_device_raises():
    _, tcfg, _, tp = _setup("kwt-tiny")
    with pytest.raises(ValueError, match="CUDA device"):
        trt.compile_model(tcfg, tp, backend="cuda", device="cpu")


def test_no_device_means_the_card_and_raises_without_one():
    _, tcfg, _, tp = _setup("kwt-tiny")
    if torch.cuda.is_available():
        assert trt.compile_model(tcfg, tp, backend="lut").device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            trt.compile_model(tcfg, tp, backend="lut")
        with pytest.raises(RuntimeError, match="CUDA"):
            trt.compile_model(tcfg, tp, backend="cuda")


def test_compile_model_turns_tf32_off():
    _, tcfg, _, tp = _setup("kwt-tiny")
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    trt.compile_model(tcfg, tp, backend="float", device="cpu")
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False


@pytest.mark.parametrize("call", ["stream_step", "prefill", "decode_step",
                                  "flash_lut", "taps"])
def test_later_slices_raise_not_implemented(call):
    _, tcfg, _, tp = _setup("kwt-tiny")
    eng = trt.compile_model(tcfg, tp, backend="float", device="cpu")
    with pytest.raises(NotImplementedError):
        if call == "stream_step":
            eng.stream_step(None, None, None)
        elif call == "prefill":
            eng.prefill(None, None)
        elif call == "decode_step":
            eng.decode_step(None, None)
        elif call == "flash_lut":
            trt.compile_model(tcfg, tp, backend="lut", attention="flash_lut",
                              device="cpu")
        else:
            trt.compile_model(tcfg, tp, backend="lut", taps=True, device="cpu")


# ---------------------------------------------------------------------------
# the port stands alone
# ---------------------------------------------------------------------------

def test_port_imports_neither_jax_nor_the_reference_package():
    root = pathlib.Path(__file__).resolve().parents[1]
    files = sorted((root / "src" / "repro_torch").rglob("*.py"))
    files.append(root / "chip_smoke.py")
    assert len(files) > 20 and all(f.exists() for f in files)
    bad = re.compile(r"^\s*(import\s+jax|from\s+jax|import\s+repro(\s|\.|$)|"
                     r"from\s+repro(\s|\.))", re.M)
    hits = [f"{f.relative_to(root)}: {m.group(0).strip()}"
            for f in files for m in bad.finditer(f.read_text())]
    assert hits == []

