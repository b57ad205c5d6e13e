"""The encdec family (whisper-large-v3) in the port against the reference,
on the CPU: the parameter tree, ``sinusoid``, the cross-attention, the
encoder and decoder blocks, ``encode``, ``decode_train``, ``loss_fn`` and
its gradient, and ``prefill`` + ``decode_step``, on the same numpy weights
and inputs, at module level under each plan's ``exec_cfg`` (ROADMAP C11:
the reference runs this family only so).  Plans are paired plan with
plan: the port's ``float`` / ``lut_float`` / ``lut`` with the reference's
same-named plan, the port's ``cuda`` (its kernels' plain versions on the
CPU) with the reference's ``pallas`` (its kernels in interpret mode).
The engine, ``launch.steps`` and ``launch.serve`` are held to the
reference's planning and to the port's C11 refusals.

Tolerances, beside what was measured here (PyTorch CPU against XLA:CPU,
PERF.md §6):

* ``sinusoid``: ``SIN_ATOL`` 2.5e-4, two ulps of a float32 angle near
  1500 rad (2^-13 each): both take the float32 product of a position and
  a frequency, and the frequencies' ``exp`` rounds apart by an ulp in 54
  of 640 entries at d 1280; measured 1.22e-4 at d 1280, 3.8e-6 at d 64.
* blocks, memories, logits and the loss: the float stages reduce in
  another order under PyTorch than under XLA:CPU.  ``FLOAT_ATOL`` 1e-5
  on every plan: measured at most 1.3e-6 (memories), 9.5e-7 (logits),
  with no LUT bin moved.  These plans run float weights (C11), so a
  product one ulp apart could move a LUT bin; moving one GELU bin of one
  hidden unit moves these logits by 6.0e-3 to 1.9e-2 (measured, one bin
  in each of the four MLPs), so ``LUT_ATOL`` 1e-3 on the LUT plans'
  logits says that no bin moved.
* the reference walks its layers under ``lax.scan`` (``scan_layers``):
  XLA compiles the layer body as one program and rounds its float stages
  otherwise than its own op-by-op layers, and at ``enc_seq`` 80 on
  ``lut`` and ``pallas`` that moves a bin (measured 0.0168 on the memory,
  0.0195 on the logits, between the reference's scanned and unrolled
  encoders).  The port walks the layers in a Python loop, as the
  reference does at ``scan_layers=False``; the model-level comparisons
  pair with that, and the scanned reference is held within one bin,
  ``BIN_ATOL`` 0.025 (``test_scanned_reference_moves_at_most_a_bin``).
* the loss 1e-5 (measured 0.0); its gradient ``GRAD_ATOL`` 1e-5
  (measured 1.2e-7).
* decode == forward: the reference's own 1e-3 (``tests/test_models.py``),
  every plan, in both packages (measured at most 6.0e-7).
* flash-LUT encoder: at ``enc_seq`` 16 (one key tile) ``FLOAT_ATOL``
  (measured 7.2e-7); at ``enc_seq`` 132, where ``fit_block(132, 128) = 4``
  is the card's key tile at 1500 (33 tiles; ``fit_block(n, 128)`` is ``n``
  for every ``n`` <= 128), the plain tiled version against the Pallas
  kernel in interpret mode on a layer's real q/k/v, the terms of
  tests/test_torch_attention.py: all within 0.05, 99 % within 2e-5
  (measured 7.5e-4, 99.91 %); the whole encoder with the kernel's tiles in
  the plain version, ``ATTN_TIGHT_ATOL`` 0.01 (measured 2.6e-4).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import runtime as jrt
from repro.configs import registry as jregistry
from repro.core import quant as jquant
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models import encdec as JE
from repro.runtime import backends as jbe
from repro_torch import convert
from repro_torch import runtime as trt
from repro_torch.configs import registry as tregistry
from repro_torch.core import quant as tquant
from repro_torch.core.tree import tree_leaves_sorted, tree_map
from repro_torch.kernels import ops as tops
from repro_torch.launch import serve as tserve
from repro_torch.launch import steps as tsteps
from repro_torch.models import encdec as TE
from repro_torch.models import layers as TL
from repro_torch.runtime import backends as tbe

torch.set_num_threads(1)

NAME = "whisper-large-v3"
PLANS = {"float": "float", "lut_float": "lut_float", "lut": "lut",
         "cuda": "pallas"}
SIN_ATOL = 2.5e-4
FLOAT_ATOL = 1e-5
LUT_ATOL = 1e-3
BIN_ATOL = 0.025
GRAD_ATOL = 1e-5
DECODE_ATOL = 1e-3
ATTN_ATOL, ATTN_LUT_ATOL, ATTN_SHARE = 2e-5, 0.05, 0.99
ATTN_TIGHT_ATOL = 0.01
B, S, MAX_LEN = 2, 8, 16
# narrow variants of the smoke config: a vocabulary with pad ids, more
# encoder than decoder layers, another head split
VARIANTS = {"smoke": {}, "padded_vocab": {"vocab_size": 250},
            "deep_encoder": {"n_enc_layers": 3, "n_layers": 1},
            "heads_8x8": {"n_heads": 8, "n_kv_heads": 8, "head_dim": 8}}


def np_params(jcfg, seed=0):
    """Reference-layout parameters with every leaf random: matrices
    fan-in scaled (stacked block leaves by their per-layer fan-in),
    biases small, LayerNorm scales around 1 (the reference's zeros and
    ones would hide a dropped bias or scale)."""
    shapes = jax.eval_shape(lambda k: JE.init_params(jcfg, k),
                            jax.random.PRNGKey(0))
    rng = np.random.default_rng(seed)

    def leaf(path, s):
        names = [getattr(k, "key", "") for k in path]
        per = s.shape[1:] if names[0] in ("enc_blocks", "dec_blocks") \
            else s.shape
        if "scale" in names:
            return rng.normal(1.0, 0.1, s.shape).astype(np.float32)
        scale = 1.0 / np.sqrt(per[0]) if len(per) > 1 else 0.1
        return rng.normal(0, scale, s.shape).astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


def _cfgs(scan_layers=False, **kw):
    """The reference's config walks its layers unrolled, as the port does,
    unless ``scan_layers`` (see the module docstring)."""
    return (jregistry.get(NAME).smoke.with_(scan_layers=scan_layers, **kw),
            tregistry.get(NAME).smoke.with_(**kw))


def _setup(seed=0, scan_layers=False, **kw):
    jcfg, tcfg = _cfgs(scan_layers, **kw)
    npp = np_params(jcfg, seed)
    return jcfg, tcfg, jax.tree.map(jnp.asarray, npp), \
        convert.from_numpy_tree(npp, "cpu")


def _inputs(cfg, b=B, s=S, seed=1):
    rng = np.random.default_rng(seed)
    frames = rng.normal(size=(b, cfg.enc_seq, cfg.d_model)).astype(np.float32)
    toks = rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)
    return frames, toks


def _exec_cfgs(jcfg, tcfg, plan, attention="xla"):
    """The plan's exec_cfg in each package: ``configure``, as
    ``compile_model`` pins it (the reference's kernels in interpret
    mode)."""
    return (jbe.get_backend(PLANS[plan]).configure(
                jcfg, interpret=True, attention=attention),
            tbe.get_backend(plan).configure(tcfg, attention=attention))


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _close(got, want, atol, what):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, what
    np.testing.assert_allclose(got, want, rtol=0, atol=atol, err_msg=what)


def _layer(tree, i=0):
    return tree_map(lambda a: a[i], tree)


# ---------------------------------------------------------------------------
# params, positions
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("variant", list(VARIANTS))
def test_param_tree_matches_reference(variant):
    """Leaf names, shapes and dtypes in ``jax.tree.leaves`` order; the
    port's draw is seeded and deterministic."""
    jcfg, tcfg = _cfgs(**VARIANTS[variant])
    shapes = jax.eval_shape(lambda k: JE.init_params(jcfg, k),
                            jax.random.PRNGKey(0))
    tp = TE.init_params(tcfg, torch.Generator().manual_seed(0), "cpu")
    back = convert.to_numpy_tree(tp)
    assert jax.tree.structure(back) == jax.tree.structure(shapes)
    want = [(s.shape, np.dtype(s.dtype)) for s in jax.tree.leaves(shapes)]
    got = [(tuple(t.shape), np.dtype(str(t.dtype).split(".")[1]))
           for t in tree_leaves_sorted(tp)]
    assert got == want
    assert "bk" not in tp["dec_blocks"]["cross_attn"]
    again = TE.init_params(tcfg, torch.Generator().manual_seed(0), "cpu")
    assert all(torch.equal(a, b) for a, b in
               zip(tree_leaves_sorted(tp), tree_leaves_sorted(again)))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            TE.init_params(tcfg, torch.Generator())


@pytest.mark.parametrize("d", [64, 1280])
def test_sinusoid_matches_reference(d):
    """Positions 0 .. 1500 (whisper's ``enc_seq``) and offsets, as prefill
    and decode take them."""
    pos = np.arange(1501)
    want = np.asarray(JE.sinusoid(jnp.asarray(pos), d))
    got = TE.sinusoid(torch.from_numpy(pos), d)
    assert got.dtype == torch.float32
    _close(got, want, SIN_ATOL, f"sinusoid d={d}")
    # the same positions as a prefill's offset and a decode step's
    assert torch.equal(TE.sinusoid(torch.tensor([7]), d), got[7:8])


# ---------------------------------------------------------------------------
# blocks
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("plan", list(PLANS))
def test_cross_attention_matches_reference(plan):
    """With the encoder memory, and with its cached keys and values
    (which must be what the memory call returned)."""
    jcfg, tcfg, jp, tp = _setup()
    jc, tc = _exec_cfgs(jcfg, tcfg, plan)
    rng = np.random.default_rng(3)
    x = rng.normal(size=(B, 5, tcfg.d_model)).astype(np.float32)
    mem = rng.normal(size=(B, tcfg.enc_seq, tcfg.d_model)).astype(np.float32)
    jb, tb = _layer(jp["dec_blocks"])["cross_attn"], \
        _layer(tp["dec_blocks"])["cross_attn"]
    jo, jkv = JE.apply_cross_attention(jb, jnp.asarray(x), jc,
                                       memory=jnp.asarray(mem))
    with torch.inference_mode():
        to, tkv = TE.apply_cross_attention(tb, _t(x), tc, memory=_t(mem))
        tc_out, same = TE.apply_cross_attention(tb, _t(x), tc, mem_kv=tkv)
    _close(to, jo, FLOAT_ATOL, f"{plan} cross-attention, memory")
    for key in ("k", "v"):
        assert tuple(tkv[key].shape) == (B, tcfg.enc_seq, tcfg.n_heads,
                                         tcfg.resolved_head_dim)
        _close(tkv[key], jkv[key], FLOAT_ATOL, f"{plan} mem_kv {key}")
    assert same is tkv and torch.equal(tc_out, to)
    jc_out, _ = JE.apply_cross_attention(
        jb, jnp.asarray(x), jc, mem_kv={k: jnp.asarray(v.numpy())
                                        for k, v in tkv.items()})
    _close(tc_out, jc_out, FLOAT_ATOL, f"{plan} cross-attention, mem_kv")


@pytest.mark.parametrize("plan", list(PLANS))
def test_enc_block_matches_reference(plan):
    jcfg, tcfg, jp, tp = _setup()
    jc, tc = _exec_cfgs(jcfg, tcfg, plan)
    x = np.random.default_rng(4).normal(
        size=(B, tcfg.enc_seq, tcfg.d_model)).astype(np.float32)
    want = JE.apply_enc_block(_layer(jp["enc_blocks"], 1), jnp.asarray(x), jc)
    with torch.inference_mode():
        got = TE.apply_enc_block(_layer(tp["enc_blocks"], 1), _t(x), tc)
    _close(got, want, FLOAT_ATOL, f"{plan} encoder block")


@pytest.mark.parametrize("plan", list(PLANS))
def test_dec_block_matches_reference(plan):
    """Teacher-forced, then against a cache: a prefill of 5 tokens that
    computes the cross keys and values, then one token that reads them."""
    jcfg, tcfg, jp, tp = _setup()
    jc, tc = _exec_cfgs(jcfg, tcfg, plan)
    rng = np.random.default_rng(5)
    x = rng.normal(size=(B, 6, tcfg.d_model)).astype(np.float32)
    mem = rng.normal(size=(B, tcfg.enc_seq, tcfg.d_model)).astype(np.float32)
    jb, tb = _layer(jp["dec_blocks"]), _layer(tp["dec_blocks"])
    want, js = JE.apply_dec_block(jb, jnp.asarray(x), jc,
                                  positions=jnp.arange(6),
                                  memory=jnp.asarray(mem))
    assert js is None
    with torch.inference_mode():
        got, ts = TE.apply_dec_block(tb, _t(x), tc, positions=torch.arange(6),
                                     memory=_t(mem))
    assert ts is None
    _close(got, want, FLOAT_ATOL, f"{plan} decoder block, teacher-forced")
    # cached: prefill 5, then the 6th token
    jkv = JE.L.init_kv_cache(jc, B, MAX_LEN)
    jy, js = JE.apply_dec_block(jb, jnp.asarray(x[:, :5]), jc,
                                positions=jnp.arange(5),
                                memory=jnp.asarray(mem),
                                state={"kv": jkv, "cross": None},
                                cache_index=0)
    jy1, js = JE.apply_dec_block(jb, jnp.asarray(x[:, 5:]), jc,
                                 positions=5 + jnp.arange(1), state=js,
                                 cache_index=5)
    tkv = TL.init_kv_cache(tc, B, MAX_LEN)
    with torch.inference_mode():
        ty, ts = TE.apply_dec_block(tb, _t(x[:, :5]), tc,
                                    positions=torch.arange(5),
                                    memory=_t(mem),
                                    state={"kv": tkv, "cross": None},
                                    cache_index=0)
        assert ts["kv"] is tkv
        ty1, ts = TE.apply_dec_block(tb, _t(x[:, 5:]), tc,
                                     positions=5 + torch.arange(1), state=ts,
                                     cache_index=5)
    _close(ty, jy, FLOAT_ATOL, f"{plan} decoder block, prefill")
    _close(ty1, jy1, FLOAT_ATOL, f"{plan} decoder block, decode")
    _close(ty1[:, 0], want[:, 5], FLOAT_ATOL, f"{plan} decode vs forward")
    for key in ("k", "v"):
        _close(ts["kv"][key], js["kv"][key], FLOAT_ATOL, f"{plan} self {key}")
        _close(ts["cross"][key], js["cross"][key], FLOAT_ATOL,
               f"{plan} cross {key}")


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("variant", list(VARIANTS))
def test_encode_and_decode_train_match_reference(variant):
    jcfg, tcfg, jp, tp = _setup(**VARIANTS[variant])
    frames, toks = _inputs(tcfg)
    jm = JE.encode(jp, jnp.asarray(frames), jcfg)
    jl = JE.decode_train(jp, jm, jnp.asarray(toks), jcfg)
    with torch.inference_mode():
        tm = TE.encode(tp, _t(frames), tcfg)
        tl = TE.decode_train(tp, tm, _t(toks), tcfg)
    _close(tm, jm, FLOAT_ATOL, f"{variant} memory")
    assert tl.shape == (B, S, tcfg.padded_vocab)
    _close(tl, jl, FLOAT_ATOL, f"{variant} logits")
    if tcfg.padded_vocab != tcfg.vocab_size:
        assert bool((tl[..., tcfg.vocab_size:] == -1e30).all())


def test_loss_and_gradient_match_reference():
    """``loss_fn``'s value and its float gradient with respect to every
    leaf (the train step itself is queue A item 4's LM training)."""
    jcfg, tcfg, jp, tp = _setup()
    frames, toks = _inputs(tcfg)
    labels = np.random.default_rng(9).integers(
        0, tcfg.vocab_size, toks.shape).astype(np.int32)
    jb = {"frames": jnp.asarray(frames), "tokens": jnp.asarray(toks),
          "labels": jnp.asarray(labels)}
    jl, jg = jax.value_and_grad(JE.loss_fn)(jp, jb, jcfg)
    tb = {"frames": _t(frames), "tokens": _t(toks), "labels": _t(labels)}
    tl, tg = tsteps.value_and_grad(
        lambda p, b: TE.loss_fn(p, b, tcfg), tp, tb)
    assert abs(float(tl) - float(jl)) <= FLOAT_ATOL
    got = tree_leaves_sorted(tg)
    want = jax.tree.leaves(jg)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        _close(g, w, GRAD_ATOL, "loss gradient")
    assert float(sum(g.abs().sum() for g in got)) > 0


def _decode_run(mod, params, cfg, frames, toks, t=_t):
    """encode + decode_train's last logits, and prefill of all but the
    last token + one decode_step, in one package."""
    if mod is JE:
        arr = jnp.asarray
        mem = JE.encode(params, arr(frames), cfg)
        fwd = JE.decode_train(params, mem, arr(toks), cfg)
        st = JE.init_decode_state(cfg, B, MAX_LEN)
        pre, st = JE.prefill(params, arr(frames), arr(toks[:, :-1]), cfg, st)
        dec, st = JE.decode_step(params, arr(toks[:, -1]), cfg, st)
        return [np.asarray(a) for a in (mem, fwd, pre, dec)] + [int(st["index"])]
    with torch.inference_mode():
        mem = TE.encode(params, t(frames), cfg)
        fwd = TE.decode_train(params, mem, t(toks), cfg)
        st = TE.init_decode_state(cfg, B, MAX_LEN, device="cpu")
        pre, st = TE.prefill(params, t(frames), t(toks[:, :-1]), cfg, st)
        dec, st = TE.decode_step(params, t(toks[:, -1]), cfg, st)
    return [a.numpy() for a in (mem, fwd, pre, dec)] + [st["index"]]


@pytest.mark.parametrize("enc_seq", [16, 80])
@pytest.mark.parametrize("plan", list(PLANS))
def test_prefill_decode_match_reference_plan(plan, enc_seq, monkeypatch):
    """Plan with plan.  At ``enc_seq`` 80 the encoder's and the cross
    attention's unmasked rows are longer than 64 keys, where the
    reference's Pallas softmax truncates its pre-shift and its oracle
    rounds; the port follows the oracle (ROADMAP C1).  There the port's
    ``cuda`` is held to the reference's ``pallas`` plan with the softmax
    kernel replaced by its own oracle (``repro.kernels.ref.lut_softmax``);
    the reference's ``lut_fixed`` would not do for the whole model: it
    excludes the decoder's masked lanes where the kernel path zeroes and
    renormalises them (0.040 apart on these logits)."""
    jcfg, tcfg, jp, tp = _setup(enc_seq=enc_seq)
    jc, tc = _exec_cfgs(jcfg, tcfg, plan)
    if plan == "cuda" and enc_seq > 64:
        monkeypatch.setattr(jops, "lut_softmax",
                            lambda x, fixed=True, interpret=None:
                            jref.lut_softmax(x, fixed=fixed))
    frames, toks = _inputs(tcfg)
    jm, jf, jpre, jd, jidx = _decode_run(JE, jp, jc, frames, toks)
    tm, tf, tpre, td, tidx = _decode_run(TE, tp, tc, frames, toks)
    assert tidx == jidx == S
    tol = FLOAT_ATOL if plan == "float" else LUT_ATOL
    _close(tm, jm, FLOAT_ATOL, f"{plan} memory")
    _close(tf, jf, tol, f"{plan} decode_train")
    _close(tpre, jpre, tol, f"{plan} prefill")
    _close(td, jd, tol, f"{plan} decode_step")
    # decode == forward, the reference's own bound, in both packages
    assert np.abs(td - tf[:, -1]).max() < DECODE_ATOL
    assert np.abs(jd - jf[:, -1]).max() < DECODE_ATOL


@pytest.mark.parametrize("plan", ["lut", "cuda"])
def test_scanned_reference_moves_at_most_a_bin(plan, monkeypatch):
    """The split behind ``BIN_ATOL``: at ``enc_seq`` 80 the reference's
    scanned layers move a LUT bin against its own unrolled layers, which
    the port equals to float rounding."""
    jscan, tcfg, jp, tp = _setup(enc_seq=80, scan_layers=True)
    jloop = jscan.with_(scan_layers=False)
    if plan == "cuda":
        monkeypatch.setattr(jops, "lut_softmax",
                            lambda x, fixed=True, interpret=None:
                            jref.lut_softmax(x, fixed=fixed))
    frames, toks = _inputs(tcfg)
    scanned = _decode_run(JE, jp, _exec_cfgs(jscan, tcfg, plan)[0], frames,
                          toks)
    unrolled = _decode_run(JE, jp, _exec_cfgs(jloop, tcfg, plan)[0], frames,
                           toks)
    port = _decode_run(TE, tp, _exec_cfgs(jloop, tcfg, plan)[1], frames, toks)
    for i, what in enumerate(("memory", "decode_train", "prefill",
                              "decode_step")):
        _close(port[i], unrolled[i], FLOAT_ATOL, f"{plan} {what}")
        _close(port[i], scanned[i], BIN_ATOL, f"{plan} {what} (scanned)")
    assert np.abs(scanned[0] - unrolled[0]).max() > LUT_ATOL   # a bin moved


@pytest.mark.parametrize("plan", list(PLANS))
def test_encoder_rows_over_64_keys_pair_with_lut_fixed(plan):
    """The encoder alone has only unmasked rows: at ``enc_seq`` 80 its
    memory on every port plan equals the reference's with the softmax in
    ``lut_fixed`` where the plan's softmax is the fixed-point one (the
    port's ``cuda`` follows the oracle, C1)."""
    jcfg, tcfg, jp, tp = _setup(enc_seq=80)
    jc, tc = _exec_cfgs(jcfg, tcfg, plan)
    if plan == "cuda":
        jc = jc.with_(softmax_mode="lut_fixed")
    frames, _ = _inputs(tcfg)
    want = JE.encode(jp, jnp.asarray(frames), jc)
    with torch.inference_mode():
        got = TE.encode(tp, _t(frames), tc)
    _close(got, want, FLOAT_ATOL, f"{plan} memory at enc_seq 80")


@pytest.mark.parametrize("plan", list(PLANS))
def test_decode_state_is_written_in_place(plan):
    """``prefill`` fills the cross caches from the memory and the self
    caches with the prompt, in the state's own tensors; a later
    ``decode_step`` reads the cross caches and writes one slot; a
    per-lane index raises (the reference has none for this family)."""
    _, tcfg, _, tp = _setup()
    tc = tbe.get_backend(plan).configure(tcfg)
    frames, toks = _inputs(tcfg)
    st = TE.init_decode_state(tc, B, MAX_LEN, device="cpu")
    cross_k, self_k = st["layers"]["cross"]["k"], st["layers"]["kv"]["k"]
    assert cross_k.shape == (tcfg.n_layers, B, tcfg.enc_seq, tcfg.n_heads,
                             tcfg.resolved_head_dim)
    with torch.inference_mode():
        mem = TE.encode(tp, _t(frames), tc)
        _, st = TE.prefill(tp, _t(frames), _t(toks[:, :-1]), tc, st)
        want_k = TL.linear(mem, _layer(tp["dec_blocks"], 1)["cross_attn"]
                           ["wk"], "bsd,df->bsf")
        before = cross_k.clone()
        _, st2 = TE.decode_step(tp, _t(toks[:, -1]), tc, st)
    assert st2["layers"]["cross"]["k"] is cross_k and st2["index"] == S
    assert torch.equal(cross_k[1].reshape(want_k.shape), want_k)
    assert torch.equal(cross_k, before)
    assert bool((self_k[:, :, :S] != 0).any(-1).any(-1).all())
    assert bool((self_k[:, :, S:] == 0).all())
    with pytest.raises(ValueError, match="one index"):
        TE.decode_step(tp, _t(toks[:, -1]), tc,
                       {**st2, "index": torch.full((B,), S)})


# ---------------------------------------------------------------------------
# the flash-LUT encoder
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("plan", ["lut", "cuda"])
def test_flash_lut_encoder_one_key_tile(plan):
    """``enc_seq`` 16 is one key tile: the port's plain version and the
    reference's kernel agree to float rounding."""
    jcfg, tcfg, jp, tp = _setup()
    jc, tc = _exec_cfgs(jcfg, tcfg, plan, attention="flash_lut")
    assert tops.fit_block(tcfg.enc_seq, tops.ATTN_BLOCK_K) == tcfg.enc_seq
    frames, _ = _inputs(tcfg)
    want = JE.encode(jp, jnp.asarray(frames), jc)
    with torch.inference_mode():
        got = TE.encode(tp, _t(frames), tc)
    _close(got, want, FLOAT_ATOL, f"{plan} flash_lut memory")


def test_flash_lut_key_tile_4_matches_pallas_kernel():
    """``enc_seq`` 132: key tiles of 4, the card's at 1500.  A layer's
    real q/k/v through the plain tiled version and the reference's kernel
    (interpret mode); then the whole encoder, the port with the kernel's
    tiles in its plain version against the reference's ``pallas`` +
    ``flash_lut`` plan."""
    jcfg, tcfg, jp, tp = _setup(enc_seq=132)
    assert tops.fit_block(132, tops.ATTN_BLOCK_K) == 4 == \
        jops.fit_block(132, 128)
    jc, tc = _exec_cfgs(jcfg, tcfg, "cuda", attention="flash_lut")
    frames, _ = _inputs(tcfg)
    bp = _layer(tp["enc_blocks"])
    h, dh = tcfg.n_heads, tcfg.resolved_head_dim
    with torch.inference_mode():
        x = _t(frames) + TE.sinusoid(torch.arange(132), tcfg.d_model)
        hn = TL.apply_norm(bp["ln1"], x, tc)
        q, k, v = ((TL.linear(hn, bp["attn"]["w" + n], "bsd,df->bsf")
                    + bp["attn"]["b" + n]).reshape(B, 132, h, dh)
                   .transpose(1, 2) for n in "qkv")
        got = tops.lut_attention_plain(q, k, v, causal=False)
    want = np.asarray(jops.lut_attention(
        *(jnp.asarray(t.contiguous().numpy()) for t in (q, k, v)),
        causal=False, interpret=True))
    diff = np.abs(got.numpy() - want)
    assert diff.max() <= ATTN_LUT_ATOL
    assert (diff <= ATTN_ATOL).mean() >= ATTN_SHARE
    jm = JE.encode(jp, jnp.asarray(frames), jc)
    with torch.inference_mode():
        tm = TE.encode(tp, _t(frames), tc)
    _close(tm, jm, ATTN_TIGHT_ATOL, "flash_lut memory at key tiles of 4")


# ---------------------------------------------------------------------------
# planning, entry points, launchers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("plan", list(PLANS))
def test_compile_model_plans_as_the_reference(plan):
    """PTQ where the backend quantises; on the integer-executing plans the
    reference's partial residency keeps ``embed`` packed (the same payload
    and exponents) and dequantises the blocks; the exec configs pin the
    same modes."""
    jcfg, tcfg, jp, tp = _setup()
    je = jrt.compile_model(jcfg, jp, backend=PLANS[plan], interpret=True)
    te = trt.compile_model(tcfg, tp, backend=plan, device="cpu",
                           plain_kernels=plan == "cuda")
    assert te.int_exec == je.int_exec == (plan in ("lut", "cuda"))
    assert te.quantized_bytes == je.quantized_bytes
    for f in ("int_exec", "attn_impl"):
        assert getattr(te.exec_cfg, f) == getattr(je.exec_cfg, f)
    modes = {"pallas": "cuda"}
    assert te.exec_cfg.softmax_mode == modes.get(je.exec_cfg.softmax_mode,
                                                 je.exec_cfg.softmax_mode)
    assert te.exec_cfg.act_approx == modes.get(je.exec_cfg.act_approx,
                                               je.exec_cfg.act_approx)
    tq, jq = te.params["embed"], je.params["embed"]
    assert isinstance(tq, tquant.QTensor) == isinstance(jq, jquant.QTensor) \
        == te.int_exec
    if te.int_exec:
        assert np.array_equal(tq.values.numpy(), np.asarray(jq.values))
        assert tq.exponent == jq.exponent
    else:
        _close(tq, jq, 0.0, f"{plan} embed")
    _close(te.params["dec_blocks"]["mlp"]["w1"],
           je.params["dec_blocks"]["mlp"]["w1"], 0.0, f"{plan} block leaf")
    assert te.exec_cfg.family == "encdec"


def test_engine_refuses_to_drive_encdec_naming_c11():
    """The reference's ``Engine.prefill`` raises a bare ``TypeError`` (it
    passes no frames); the port's entry points, ``init_decode_state``
    included, raise one that names C11 and says what to call.  The
    module-level ``init_decode_state`` gives the reference's state
    layout."""
    jcfg, tcfg, jp, tp = _setup()
    je = jrt.compile_model(jcfg, jp, backend="float")
    te = trt.compile_model(tcfg, tp, backend="float", device="cpu")
    js = je.init_decode_state(B, MAX_LEN)
    ts = TE.init_decode_state(tcfg, B, MAX_LEN, device="cpu")
    assert jax.tree.structure(convert.to_numpy_tree(ts["layers"])) == \
        jax.tree.structure(js["layers"])
    assert [tuple(a.shape) for a in tree_leaves_sorted(ts["layers"])] == \
        [a.shape for a in jax.tree.leaves(js["layers"])]
    assert ts["index"] == 0
    toks = np.zeros((B, 3), np.int32)
    with pytest.raises(TypeError):
        je.prefill(jnp.asarray(toks), js)
    for call in (lambda: te.init_decode_state(B, MAX_LEN),
                 lambda: te.prefill(toks, ts),
                 lambda: te.decode_step(toks[:, 0], ts),
                 lambda: te.forward(toks)):
        with pytest.raises(TypeError, match="C11.*models.encdec"):
            call()


def test_steps_model_module_and_specs():
    jcfg, tcfg = _cfgs()
    from repro.launch import steps as jsteps
    assert jsteps.model_module(jcfg) is JE
    assert tsteps.model_module(tcfg) is TE
    from jax.sharding import PartitionSpec as JP
    for name in ("param_specs", "enc_block_specs", "dec_block_specs",
                 "cross_attention_specs", "decode_state_specs"):
        want = jax.tree.leaves(getattr(JE, name)(jcfg),
                               is_leaf=lambda x: isinstance(x, JP))
        got = tree_leaves_sorted(getattr(TE, name)(tcfg))
        assert [tuple(s) for s in want] == [tuple(s) for s in got], name


def test_serve_refuses_encdec():
    """As the reference's launcher does (an assert there)."""
    from repro.launch import serve as jserve
    with pytest.raises(AssertionError):
        jserve.main(["--arch", NAME, "--smoke", "--requests", "1"])
    with pytest.raises(ValueError, match="encdec.*C11"):
        tserve.main(["--arch", NAME, "--smoke", "--device", "cpu",
                     "--requests", "1"])


def test_full_config_matches_reference():
    jc, tc = jregistry.get(NAME).config, tregistry.get(NAME).config
    assert dataclasses.asdict(jc) == dataclasses.asdict(tc)
    assert (tc.n_layers, tc.n_enc_layers, tc.d_model, tc.n_heads,
            tc.resolved_head_dim, tc.d_ff, tc.enc_seq, tc.padded_vocab) == \
        (32, 32, 1280, 20, 64, 5120, 1500, 51968)
    assert tops.fit_block(tc.enc_seq, tops.ATTN_BLOCK_K) == 4
