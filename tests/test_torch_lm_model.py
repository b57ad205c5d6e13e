"""The dense decoder-only LMs in the port against the reference: configs
and registry, parameter layout (the moe, rwkv and hybrid configs' too;
their logits are tests/test_torch_moe.py's, test_torch_rwkv.py's and
test_torch_hybrid.py's), and for the five dense smoke configs the
logits of ``forward``, ``prefill`` and ``decode_step`` under the port's
``float``, ``lut`` and ``cuda`` plans against the reference's ``float``,
``lut`` and ``pallas`` plans (the ``cuda`` plan through its kernels'
plain versions on the CPU, the reference's in interpret mode), on the same
numpy weights and tokens.  Keys stay at most 64 long, where the Pallas
softmax and its oracle agree (ROADMAP C1).

Tolerances, beside what was measured on this host (PERF.md §6):

* ``float``: the float stages reduce in another order under PyTorch than
  under XLA:CPU: atol 1e-4 on logits of scale ~4 (measured at most
  3.5e-6 over the five configs);
* ``lut`` and ``cuda``: the same integer pipeline: bit-equal (measured
  0.0 on every config).  A one-ulp difference upstream of an eq-9
  activation quantiser (RoPE's sin and cos, RMSNorm's rsqrt) could move
  one activation LSB; on these weights and tokens none moves;
* decode == forward within the reference's own ``rel < 1e-4``
  (``tests/test_models.py``), in the port alone, on every plan (measured
  0.0: the decode's products see the same rows).
"""

import dataclasses
import importlib.util
import json
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import runtime as jrt
from repro.configs import registry as jregistry
from repro.models import transformer as JT
from repro_torch import convert
from repro_torch import runtime as trt
from repro_torch.configs import registry as tregistry
from repro_torch.core import quant as tquant
from repro_torch.kernels import ops as tops
from repro_torch.launch import steps as tsteps
from repro_torch.models import transformer as TT

torch.set_num_threads(1)

DENSE = ["internlm2-1.8b", "granite-8b", "qwen2.5-14b", "chameleon-34b",
         "nemotron-4-340b"]
MOE = ["granite-moe-3b-a800m", "deepseek-moe-16b"]   # tests/test_torch_moe.py
# tests/test_torch_rwkv.py and tests/test_torch_hybrid.py
RECURRENT = ["rwkv6-3b", "hymba-1.5b"]
PLANS = {"float": "float", "lut": "lut", "cuda": "pallas"}
FLOAT_ATOL = 1e-4
DECODE_REL = 1e-4


def np_params(jcfg, seed=0):
    """Reference-layout LM parameters with every leaf random: matrices
    fan-in scaled (stacked block leaves by their per-layer fan-in), biases
    small, norm scales around 1 (the reference's zeros and ones would hide
    a dropped bias or scale)."""
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


def _setup(name, seed=0):
    jcfg, tcfg = jregistry.get(name).smoke, tregistry.get(name).smoke
    npp = np_params(jcfg, seed)
    return jcfg, tcfg, jax.tree.map(jnp.asarray, npp), \
        convert.from_numpy_tree(npp, "cpu")


def _tokens(cfg, b=2, s=16, seed=1):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (b, s)).astype(np.int32)


def _compile(tcfg, tp, plan, **kw):
    return trt.compile_model(tcfg, tp, backend=plan, device="cpu",
                             plain_kernels=plan == "cuda", **kw)


# ---------------------------------------------------------------------------
# configs, registry, params
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(jregistry.ASSIGNED))
def test_lm_config_equals_reference(name):
    je, te = jregistry.get(name), tregistry.get(name)
    for jc, tc in ((je.config, te.config), (je.smoke, te.smoke)):
        assert dataclasses.asdict(jc) == dataclasses.asdict(tc)
        for prop in ("resolved_head_dim", "padded_vocab", "is_attention_free",
                     "subquadratic"):
            assert getattr(tc, prop) == getattr(jc, prop)
    assert [dataclasses.asdict(s) for s in te.shapes] == \
        [dataclasses.asdict(s) for s in je.shapes]
    assert [s.is_decode for s in te.shapes] == [s.is_decode for s in je.shapes]
    assert te.skips == je.skips


def test_registry_resolves_every_reference_name():
    assert sorted(tregistry.ARCHS) == sorted(jregistry.ARCHS)
    assert tregistry.ASSIGNED == jregistry.ASSIGNED
    assert sorted(tregistry.DENSE) == sorted(DENSE)


@pytest.mark.parametrize("name", ["whisper-large-v3"])
def test_other_lm_families_raise_and_name_their_item(name):
    """The encdec family has its own module (tests/test_torch_encdec.py):
    ``model_module`` returns it and it builds the tree, while the
    decoder-only module refuses the family and names the one to use."""
    from repro_torch.models import encdec as TE
    cfg = tregistry.get(name).smoke
    assert tsteps.model_module(cfg) is TE
    tp = TE.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    assert sorted(tp) == ["dec_blocks", "embed", "enc_blocks", "ln_dec",
                          "ln_enc"]
    assert tp["enc_blocks"]["attn"]["wq"].shape[0] == cfg.n_enc_layers
    with pytest.raises(ValueError, match="models.encdec"):
        TT.init_params(cfg, torch.Generator(), "cpu")


@pytest.mark.parametrize("name", DENSE + MOE + RECURRENT)
def test_init_params_layout_matches_reference(name):
    jcfg, tcfg = jregistry.get(name).smoke, tregistry.get(name).smoke
    shapes = jax.eval_shape(lambda k: JT.init_params(jcfg, k),
                            jax.random.PRNGKey(0))
    tp = TT.init_params(tcfg, torch.Generator().manual_seed(0), "cpu")
    back = convert.to_numpy_tree(tp)
    assert jax.tree.structure(back) == jax.tree.structure(shapes)
    assert jax.tree.map(lambda a: a.shape, back) == \
        jax.tree.map(lambda a: a.shape, shapes)
    again = TT.init_params(tcfg, torch.Generator().manual_seed(0), "cpu")
    assert all(np.array_equal(a, b) for a, b in
               zip(jax.tree.leaves(back),
                   jax.tree.leaves(convert.to_numpy_tree(again))))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            TT.init_params(tcfg, torch.Generator())


# ---------------------------------------------------------------------------
# the five dense configs against the reference's plans
# ---------------------------------------------------------------------------

def _check(got, want, plan, what):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, what
    if plan == "float":
        np.testing.assert_allclose(got, want, rtol=0, atol=FLOAT_ATOL,
                                   err_msg=what)
    else:
        assert np.array_equal(got, want), \
            f"{what}: max abs {np.abs(got - want).max()}"


@pytest.mark.parametrize("name", DENSE)
@pytest.mark.parametrize("plan", list(PLANS))
def test_lm_plan_matches_reference_plan(name, plan):
    jcfg, tcfg, jp, tp = _setup(name)
    toks = _tokens(tcfg)
    je = jrt.compile_model(jcfg, jp, backend=PLANS[plan])
    te = _compile(tcfg, tp, plan)
    assert te.int_exec == je.int_exec
    _check(te.forward(toks).numpy(), je.forward(jnp.asarray(toks)), plan,
           f"{name} {plan} forward")
    js = je.init_decode_state(2, 32)
    jl, js = je.prefill(jnp.asarray(toks[:, :-1]), js)
    jd, _ = je.decode_step(jnp.asarray(toks[:, -1]), js)
    ts = te.init_decode_state(2, 32)
    tl, ts = te.prefill(toks[:, :-1], ts)
    assert ts["index"] == 15
    td, ts = te.decode_step(toks[:, -1], ts)
    assert ts["index"] == 16
    _check(tl.numpy(), jl, plan, f"{name} {plan} prefill")
    _check(td.numpy(), jd, plan, f"{name} {plan} decode_step")


@pytest.mark.parametrize("name", DENSE)
@pytest.mark.parametrize("plan", list(PLANS))
def test_decode_matches_forward(name, plan):
    """The reference's own check (tests/test_models.py), in the port: the
    last token decoded against a cache of the prompt equals the last
    position of the teacher-forced forward."""
    _, tcfg, _, tp = _setup(name, seed=2)
    eng = _compile(tcfg, tp, plan)
    toks = _tokens(tcfg, seed=3)
    ref = eng.forward(toks)[:, -1]
    state = eng.init_decode_state(2, 32)
    _, state = eng.prefill(toks[:, :-1], state)
    lg, _ = eng.decode_step(toks[:, -1], state)
    rel = float((lg - ref).abs().max()) / float(ref.abs().max())
    assert rel < DECODE_REL


def test_cuda_plan_differs_from_lut_by_the_masked_renormalisation():
    """By design (the reference's pallas branch): masked lanes enter the
    kernel's softmax at the clip bin and are zeroed and renormalised after
    it, where ``lut_fixed`` excludes them; unmasked rows are equal."""
    _, tcfg, _, tp = _setup("internlm2-1.8b")
    toks = _tokens(tcfg)
    lut = _compile(tcfg, tp, "lut").forward(toks)
    cuda = _compile(tcfg, tp, "cuda").forward(toks)
    assert not torch.equal(lut, cuda)
    assert float((lut - cuda).abs().max()) < 0.5        # measured 0.079
    # position 0 sees one key: a row with one lane, equal either way
    assert torch.equal(lut[:, 0], cuda[:, 0])


def test_pad_logits_are_masked():
    cfg = tregistry.get("internlm2-1.8b").smoke.with_(vocab_size=250)
    tp = TT.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    toks = np.zeros((1, 3), np.int32)
    with torch.inference_mode():
        lg = TT.forward(tp, torch.from_numpy(toks), cfg)
    assert lg.shape == (1, 3, 256)
    assert bool((lg[..., 250:] == -1e30).all())
    assert bool((lg[..., :250] > -1e29).all())


def test_forward_no_blocks_matches_reference():
    jcfg, tcfg, jp, tp = _setup("qwen2.5-14b")
    toks = _tokens(tcfg)
    with torch.inference_mode():
        got = TT.forward_no_blocks(tp, torch.from_numpy(toks), tcfg)
    want = JT.forward_no_blocks(jp, jnp.asarray(toks), jcfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=FLOAT_ATOL)


# ---------------------------------------------------------------------------
# the LM plan: partial residency, the kernels it reaches, entry points
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("plan", ["lut", "cuda"])
def test_lm_partial_residency_matches_reference(plan):
    """Embed and head stay packed, bit-equal to the reference's payloads
    and per-channel exponents; the blocks are dequantised float32."""
    jcfg, tcfg, jp, tp = _setup("internlm2-1.8b")
    je = jrt.compile_model(jcfg, jp, backend=PLANS[plan])
    te = _compile(tcfg, tp, plan)
    assert te.int_exec and te.exec_cfg.int_exec
    for key in ("embed", "lm_head"):
        tq, jq = te.params[key], je.params[key]
        assert isinstance(tq, tquant.QTensor)
        assert np.array_equal(tq.values.numpy(), np.asarray(jq.values))
        assert np.array_equal(tq.axis_exponents.numpy(),
                              np.asarray(jq.axis_exponents))
        assert tq.exponent == jq.exponent
    wq = te.params["blocks"]["attn"]["wq"]
    assert isinstance(wq, torch.Tensor) and wq.dtype == torch.float32
    np.testing.assert_array_equal(
        wq.numpy(), np.asarray(je.params["blocks"]["attn"]["wq"]))
    assert te.quantized_bytes == tquant.tree_quantized_bytes(
        trt.QuantRecipe.from_config(tcfg).quantize(tp))
    assert te.recipe.per_channel


def test_cuda_plan_reaches_the_kernels_once_per_layer_and_head():
    """On the card the cuda plan launches the softmax kernel once per layer
    and the int8 matmul once (the head) per call; on the CPU the wrappers
    take the plain versions and count nothing."""
    _, tcfg, _, tp = _setup("internlm2-1.8b")
    eng = _compile(tcfg, tp, "cuda")
    tops.reset_launch_counts()
    eng.forward(_tokens(tcfg))
    assert tops.launch_counts() == {k: 0 for k in tops.launch_counts()}
    assert eng.exec_cfg.softmax_mode == "cuda"
    assert "plain versions on the cpu" in eng.describe()


def test_cuda_plan_on_the_cpu_needs_the_explicit_request():
    _, tcfg, _, tp = _setup("internlm2-1.8b")
    with pytest.raises(ValueError, match="CUDA device"):
        trt.compile_model(tcfg, tp, backend="cuda", device="cpu")


def test_flash_lut_lm_forward_close_to_sdpa():
    """attention="flash_lut": causal GQA through the flash-LUT attention's
    plain version (the kernel on the card) in every layer of a forward.
    On the CPU the plain version takes one LUT softmax over all keys, as
    sdpa's ``lut`` mode does (measured 0.0 apart); the kernel's online
    softmax rescales per key tile, hence the bound."""
    _, tcfg, _, tp = _setup("internlm2-1.8b")
    toks = _tokens(tcfg)
    flash = _compile(tcfg, tp, "lut_float", attention="flash_lut")
    xla = _compile(tcfg, tp, "lut_float")
    assert flash.exec_cfg.attn_impl == "flash_lut"
    d = float((flash.forward(toks) - xla.forward(toks)).abs().max())
    assert d < 0.05
    # prefill and decode carry a validity bound: they keep sdpa
    s = flash.init_decode_state(2, 32)
    a, _ = flash.prefill(toks, s)
    b, _ = xla.prefill(toks, xla.init_decode_state(2, 32))
    assert torch.equal(a, b)


@pytest.mark.parametrize("call", ["embed_frames", "encode_window",
                                  "stream_step"])
def test_lm_engine_rejects_kwt_entry_points(call):
    _, tcfg, _, tp = _setup("internlm2-1.8b")
    eng = _compile(tcfg, tp, "float")
    with pytest.raises(NotImplementedError, match=call):
        if call == "stream_step":
            eng.stream_step(None, None, None)
        else:
            getattr(eng, call)(torch.zeros(1, 2, 3))


def test_kwt_engine_rejects_lm_entry_points():
    cfg = tregistry.get("kwt-tiny").config
    from repro_torch.models import kwt
    eng = trt.compile_model(cfg, kwt.init_params(
        cfg, torch.Generator().manual_seed(0), "cpu"), device="cpu")
    for call in ("init_decode_state", "prefill", "decode_step"):
        with pytest.raises(NotImplementedError, match=call):
            if call == "init_decode_state":
                eng.init_decode_state(1, 4)
            else:
                getattr(eng, call)(np.zeros((1, 1), np.int32), {})


def test_merge_decode_state_builds_new_tensors():
    _, tcfg, _, tp = _setup("internlm2-1.8b")
    eng = _compile(tcfg, tp, "float")
    old, new = eng.init_decode_state(2, 8), eng.init_decode_state(2, 8)
    new["layers"]["k"] += 1
    merged = TT.merge_decode_state(old, new, np.array([False, True]))
    assert merged["index"].tolist() == [0, 0]
    merged["layers"]["k"][:, 0] += 5           # no alias of either input
    assert float(old["layers"]["k"].abs().sum()) == 0.0
    assert float(new["layers"]["k"][:, 0].max()) == 1.0


@pytest.mark.parametrize("plan", ["lut", "cuda"])
def test_bf16_integer_plan_prefills_where_the_reference_raises(plan):
    """ROADMAP C6: under an integer-executing plan the blocks are the
    dequantised float32 view, so at ``dtype="bfloat16"`` the keys come out
    float32 against a bf16 cache; the reference's scalar-index cache write
    (``lax.dynamic_update_slice``) raises on the mixed dtypes.  The port
    caches in the dtype the blocks compute in (``transformer.kv_dtype``:
    float32 here), so a decode step attends over what ``forward`` does and
    decode == forward holds as at float32 (a bf16 cache read 0.019 here).
    The full-width configs are bf16."""
    jcfg = jregistry.get("internlm2-1.8b").smoke.with_(dtype="bfloat16")
    tcfg = tregistry.get("internlm2-1.8b").smoke.with_(dtype="bfloat16")
    jp = JT.init_params(jcfg, jax.random.PRNGKey(0))
    toks = _tokens(tcfg)
    je = jrt.compile_model(jcfg, jp, backend=PLANS[plan])
    with pytest.raises(TypeError, match="dynamic_update_slice"):
        je.prefill(jnp.asarray(toks), je.init_decode_state(2, 16))
    tp = TT.init_params(tcfg, torch.Generator().manual_seed(0), "cpu")
    eng = _compile(tcfg, tp, plan)
    state = eng.init_decode_state(2, toks.shape[1])
    assert state["layers"]["k"].dtype == torch.float32
    _, state = eng.prefill(toks[:, :-1], state)
    lg, _ = eng.decode_step(toks[:, -1], state)
    ref = eng.forward(toks)[:, -1]
    assert lg.dtype == ref.dtype and bool(torch.isfinite(lg).all())
    assert torch.equal(lg.argmax(-1), ref.argmax(-1))
    assert float((lg - ref).abs().max() / ref.abs().max()) < 1e-4


def test_decode_gap_tool_takes_the_smoke_plans_apart(capsys):
    """``tools/lm_decode_gap.py`` (the decode-against-forward diagnosis run
    on the card) on the CPU at smoke size: one row a plan, each per-lane
    step equal to the scalar one, and decode == forward on every plan,
    bf16 activations included (a bf16 cache read 0.019 on ``lut``)."""
    path = pathlib.Path(__file__).resolve().parents[1] / "tools" / \
        "lm_decode_gap.py"
    spec = importlib.util.spec_from_file_location("lm_decode_gap", path)
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    assert tool.main(["--smoke", "--device", "cpu"]) == 0
    rows = [json.loads(line) for line in capsys.readouterr().out.splitlines()]
    assert [r["plan"] for r in rows][:2] == ["cuda", "cuda [float32]"]
    assert len(rows) == 11
    assert all(r["per_lane_equal"] and r["argmax_equal"] for r in rows)
    assert [r["rel"] for r in rows] == [0.0] * 11


def test_lm_plan_pricing_walks_the_forward():
    """``perf.engine_cost`` prices an LM plan as one ``encode`` stage of
    its forward (tests/test_torch_perf.py holds it against the
    reference's): the products of 8 tokens, the softmax and the head's
    requant among its lines, and no launch counted by the walk."""
    from repro_torch import perf
    _, tcfg, _, tp = _setup("internlm2-1.8b")
    eng = _compile(tcfg, tp, "lut")
    tops.reset_launch_counts()
    rep = perf.engine_cost(eng)
    assert set(rep.by_stage()) == {"encode"}
    assert {"matmul", "softmax", "requant", "norm"} <= \
        {op for _, op in rep.lines}
    assert rep.matmul_flops == perf.engine_cost(
        _compile(tcfg, tp, "float")).matmul_flops > 0
    assert tops.launch_counts() == {k: 0 for k in tops.launch_counts()}
