"""The flash-LUT attention of the port against the reference, on the CPU.

The port's wrapper ``kernels.ops.lut_attention`` takes its plain version
(``kernels.ref.lut_attention_tiled``: the reference kernel's online
softmax over its own key tiles) for a CPU tensor; on the card it launches
``csrc/lut_attention.cu``, which ``chip_smoke.py`` holds tightly against
the same plain version and, loosely, against ``kernels.ref.lut_attention``
(one softmax over the whole key axis, the reference's oracle).  The JAX side runs as its own tests run
it here: the Pallas kernel in ``interpret=True`` and the jnp oracle
``repro.kernels.ref.lut_attention``.

Stated tolerances, with the errors measured behind them (this file's
inputs, PyTorch CPU against XLA:CPU):

* plain version against the jnp oracle, both modes, the reference's five
  sweep shapes, causal and not: ``ATOL`` 2e-5 (the reference's bound for
  its exact mode).  Measured worst 7.2e-7 — only the order of the float
  sums differs.  In the LUT mode a score that lands within that rounding
  of a 1/32 bin edge would take the neighbouring entry; for that case
  every element stays within ``LUT_ATOL`` 0.05 (the reference's own
  bound) and at least ``SHARE`` 99 % within ``ATOL``: a moved bin moves
  the whole output row.  Measured: no element moved a bin.
* the wrapper against the Pallas kernel where the keys are one tile (the
  KWT shapes, Lk = 27 and 99, and D = 72): ``ATOL`` on the same terms.
  Measured worst 9.5e-7, except in the KWT-1 case, where one score moved
  a bin: max 7.7e-4, 99.53 % of elements within ``ATOL`` (2 other seeds:
  5.9e-7).  Where they are several (Lk = 256, two tiles of
  128): ``LUT_ATOL`` 0.05, the bound kept from when the CPU branch took
  one softmax (5.6e-3, 49-57 % of elements within ``ATOL``), since the
  online rescale ``alpha`` is a 1/32-bin lookup that a single softmax
  never takes; the tiled plain version meets the kernel within ``ATOL``
  there too (tests/test_torch_flash_parity.py).  The exact mode stays
  within ``ATOL`` at every shape (measured 6.9e-7).
* the tiled version against the Pallas kernel, one key tile and several
  (two of 128, 125 of 8), causal and not, both modes: ``ATOL`` on the
  same terms.  Measured worst 8.3e-7, every element within ``ATOL``.
  Rescaling at other edges than the reference's (one softmax, or tiles
  of half the size) keeps within ``LUT_ATOL`` (measured 4.8e-4 to 5.5e-3)
  but leaves 6.6-55.6 % of elements within ``ATOL``, below ``SHARE``.
* whole-model logits under ``attention="flash_lut"`` against the
  reference's same plan: the tolerances of ``tests/test_torch_runtime.py``
  (``lut_float`` 2^-5 on KWT-Tiny; KWT-1 at 2 layers 0.25 with at most 2
  of 64 samples further than 1e-4).  Measured at B = 64: KWT-Tiny
  ``lut_float`` 3.6e-7, ``lut`` 0.0; KWT-1 ``lut_float`` 0.0135 on 2
  samples (a LUT GELU bin moved), ``lut`` 0.041 on 1 sample (an
  activation LSB moved).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import runtime as jrt
from repro.configs import registry as jregistry
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models import kwt as jkwt
from repro_torch import convert
from repro_torch import runtime as trt
from repro_torch.configs import registry as tregistry
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.models import kwt as tkwt
from repro_torch.models import layers as tL

torch.set_num_threads(1)

ATOL = 2e-5
LUT_ATOL = 0.05
SHARE = 0.99
TINY_ATOL = 2.0 ** -5
KWT1_ATOL = 0.25
KWT1_MAX_MOVED_SAMPLES = 2

# (b, hq, hkv, lq, lk, d): the reference's sweep (tests/test_kernels.py)
SWEEP = {"mha": (1, 2, 2, 64, 64, 32), "gqa": (2, 4, 2, 64, 64, 32),
         "mqa": (1, 8, 1, 128, 128, 64), "decode": (2, 4, 2, 1, 64, 32),
         "long_kv": (1, 2, 2, 64, 256, 32)}
# one key tile in the reference: KWT-Tiny, KWT-1, and a ragged D
ONE_TILE = {"kwt_tiny_b8": (8, 1, 1, 27, 27, 8),
            "kwt_1_b4": (4, 1, 1, 99, 99, 64),
            "d72": (2, 2, 1, 27, 27, 72)}
# several key tiles: two of 128, and 125 of 8 (fit_block(1000, 128) = 8)
MULTI_TILE = {"long_kv": SWEEP["long_kv"], "lk_1000": (1, 2, 1, 16, 1000, 16)}


def _qkv(shape, seed=0):
    b, hq, hkv, lq, lk, d = shape
    rng = np.random.default_rng(seed)
    return [rng.normal(size=s).astype(np.float32)
            for s in ((b, hq, lq, d), (b, hkv, lk, d), (b, hkv, lk, d))]


def _close(got, want, *, lut: bool):
    diff = np.abs(np.asarray(got, np.float64) - np.asarray(want, np.float64))
    if lut:
        assert diff.max() <= LUT_ATOL, diff.max()
        assert (diff <= ATOL).mean() >= SHARE, (diff <= ATOL).mean()
    else:
        assert diff.max() <= ATOL, diff.max()


@pytest.mark.parametrize("name", list(SWEEP))
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("mode", ["exact", "lut"])
def test_plain_version_matches_reference_oracle(name, causal, mode):
    q, k, v = _qkv(SWEEP[name])
    want = jref.lut_attention(*map(jnp.asarray, (q, k, v)), causal=causal,
                              softmax_mode=mode)
    got = tref.lut_attention(*map(torch.from_numpy, (q, k, v)),
                             causal=causal, softmax_mode=mode)
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    _close(got.numpy(), want, lut=mode == "lut")


@pytest.mark.parametrize("name", list(ONE_TILE) + ["long_kv"])
@pytest.mark.parametrize("use_lut", [True, False])
def test_cpu_wrapper_matches_pallas_kernel(name, use_lut):
    shape = ONE_TILE.get(name) or SWEEP[name]
    q, k, v = _qkv(shape, seed=1)
    want = np.asarray(jops.lut_attention(*map(jnp.asarray, (q, k, v)),
                                         causal=False, use_lut=use_lut,
                                         interpret=True))
    got = tops.lut_attention(*map(torch.from_numpy, (q, k, v)), causal=False,
                             use_lut=use_lut).numpy()
    diff = np.abs(got - want)
    if use_lut and name == "long_kv":
        # two key tiles: the reference rescales by a LUT probe at the edge
        assert diff.max() <= LUT_ATOL, diff.max()
    else:
        _close(got, want, lut=use_lut)


@pytest.mark.parametrize("name", list(ONE_TILE) + list(MULTI_TILE))
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("use_lut", [True, False])
def test_tiled_version_matches_pallas_kernel(name, causal, use_lut):
    """``ref.lut_attention_tiled`` is the reference kernel's online softmax
    over its key tiles, so it meets the Pallas kernel on the tight terms
    wherever the keys are cut, one tile or 125 (the card holds the kernel
    to it on the same terms)."""
    q, k, v = _qkv(ONE_TILE.get(name) or MULTI_TILE[name], seed=4)
    want = np.asarray(jops.lut_attention(*map(jnp.asarray, (q, k, v)),
                                         causal=causal, use_lut=use_lut,
                                         interpret=True))
    got = tref.lut_attention_tiled(*map(torch.from_numpy, (q, k, v)),
                                   causal=causal, use_lut=use_lut,
                                   block_k=tops.fit_block(k.shape[2], 128))
    _close(got.numpy(), want, lut=use_lut)


@pytest.mark.parametrize("name", list(MULTI_TILE))
def test_tight_terms_tell_the_tile_edges_apart(name):
    """Rescaling at other edges than the reference's (here: a single
    softmax, and tiles of half the size) stays inside the reference's
    0.05 but fails the tight share: the tight terms are what hold the
    kernel to the reference's edges."""
    q, k, v = _qkv(MULTI_TILE[name], seed=1)
    want = np.asarray(jops.lut_attention(*map(jnp.asarray, (q, k, v)),
                                         causal=False, interpret=True))
    lk = k.shape[2]
    qt, kt, vt = map(torch.from_numpy, (q, k, v))
    for other in (tref.lut_attention(qt, kt, vt, causal=False),
                  tref.lut_attention_tiled(qt, kt, vt, causal=False,
                                           use_lut=True,
                                           block_k=tops.fit_block(lk, 128) // 2)):
        diff = np.abs(other.numpy().astype(np.float64) - want)
        assert diff.max() <= LUT_ATOL, diff.max()
        assert (diff <= ATOL).mean() < SHARE, (diff <= ATOL).mean()


def test_cpu_wrapper_causal_gqa_and_bf16():
    q, k, v = _qkv(SWEEP["gqa"], seed=2)
    want = np.asarray(jops.lut_attention(*map(jnp.asarray, (q, k, v)),
                                         causal=True, interpret=True))
    got = tops.lut_attention(*map(torch.from_numpy, (q, k, v)), causal=True)
    _close(got.numpy(), want, lut=True)
    qb, kb, vb = (torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v))
    out = tops.lut_attention(qb, kb, vb, causal=True)
    assert out.dtype == torch.bfloat16 and bool(torch.isfinite(out).all())


@pytest.mark.parametrize("use_lut", [True, False])
def test_fully_masked_causal_rows_are_zeros_like_the_pallas_kernel(use_lut):
    """Causal with Lq > Lk: the first Lq - Lk queries see no key.  The
    Pallas kernel gives them 0 through max(l, 1e-30), and so does the
    port (the jnp oracle gives NaN or a uniform row there)."""
    q, k, v = _qkv((1, 4, 2, 40, 20, 16), seed=3)
    want = np.asarray(jops.lut_attention(*map(jnp.asarray, (q, k, v)),
                                         causal=True, use_lut=use_lut,
                                         interpret=True))
    got = tops.lut_attention(*map(torch.from_numpy, (q, k, v)), causal=True,
                             use_lut=use_lut).numpy()
    assert np.all(want[:, :, :20] == 0) and np.all(got[:, :, :20] == 0)
    _close(got, want, lut=use_lut)


def test_wrapper_rejects_what_the_kernel_does_not_take():
    q = torch.zeros(1, 3, 4, 8)
    with pytest.raises(ValueError, match="Hq % Hkv"):
        tops.lut_attention(q, torch.zeros(1, 2, 4, 8), torch.zeros(1, 2, 4, 8))
    with pytest.raises(ValueError):
        tops.lut_attention(q, torch.zeros(1, 3, 4, 7), torch.zeros(1, 3, 4, 7))
    from repro_torch.kernels import lut_attention as tattn
    with pytest.raises(ValueError, match="block_k"):
        tattn.lut_attention(q, q, q, causal=False, use_lut=True, scale=1.0,
                            block_k=3)


def test_fit_block_equals_reference():
    for size in range(1, 300):
        for preferred in (1, 2, 8, 64, 128, 1024):
            assert tops.fit_block(size, preferred) == \
                jops.fit_block(size, preferred), (size, preferred)
    for size in (1000, 1792, 4096, 6336):
        assert tops.fit_block(size, 128) == jops.fit_block(size, 128)


# ---------------------------------------------------------------------------
# the flash branch of the model
# ---------------------------------------------------------------------------

def _np_params(jcfg, seed=0):
    shapes = jax.eval_shape(lambda key: jkwt.init_params(jcfg, key),
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


def _setup(name):
    if name not in _CACHE:
        je, te = jregistry.get(name), tregistry.get(name)
        jcfg, tcfg = (je.config, te.config) if name == "kwt-tiny" else \
            (je.smoke, te.smoke)
        npp = _np_params(jcfg)
        _CACHE[name] = (jcfg, tcfg, jax.tree.map(jnp.asarray, npp),
                        convert.from_numpy_tree(npp, "cpu"))
    return _CACHE[name]


def _mfcc(cfg, batch, seed=0):
    rng = np.random.default_rng(200 + seed + batch)
    return rng.normal(0, 0.5, (batch, *cfg.input_dim)).astype(np.float32)


@pytest.mark.parametrize("name", ["kwt-tiny", "kwt-1"])
@pytest.mark.parametrize("backend", ["lut_float", "lut"])
def test_flash_lut_logits_match_reference_plan(name, backend):
    jcfg, tcfg, jp, tp = _setup(name)
    x = _mfcc(jcfg, 64)
    want = np.asarray(jrt.compile_model(jcfg, jp, backend=backend,
                                        attention="flash_lut")
                      .forward(jnp.asarray(x)))
    eng = trt.compile_model(tcfg, tp, backend=backend, attention="flash_lut",
                            device="cpu")
    got = eng.forward(x).numpy()
    assert np.all(np.isfinite(got)) and got.shape == want.shape
    diff = np.abs(got - want)
    if name == "kwt-tiny":
        assert diff.max() <= TINY_ATOL, diff.max()
    else:
        assert diff.max() <= KWT1_ATOL, diff.max()
        assert int((diff.max(axis=-1) > 1e-4).sum()) <= KWT1_MAX_MOVED_SAMPLES


def test_routed_layer_is_the_direct_call():
    """The flash branch of ``apply_attention`` is the wrapper verbatim:
    projections, the [B, H, L, D] layout and the output projection around
    one ``ops.lut_attention`` call (bit-identical)."""
    _, tcfg, _, tp = _setup("kwt-tiny")
    eng = trt.compile_model(tcfg, tp, backend="lut_float",
                            attention="flash_lut", device="cpu")
    cfg, p = eng.exec_cfg, eng.params
    bp = p["blocks"][0]["attn"]
    x = torch.from_numpy(_mfcc(cfg, 2))
    emb = tkwt.embed_frames(p, x.transpose(1, 2), cfg)
    b = emb.shape[0]
    x = torch.cat([p["cls"].expand(b, 1, cfg.d_model), emb], 1) + p["pos"]
    routed, cache = tL.apply_attention(bp, x, cfg, causal=False)
    assert cache is None
    h, dh = cfg.n_heads, cfg.resolved_head_dim
    q, k, v = ((torch.einsum("bsd,df->bsf", x, bp[w]) + bp[bias])
               .reshape(b, -1, h, dh).transpose(1, 2)
               for w, bias in (("wq", "bq"), ("wk", "bk"), ("wv", "bv")))
    o = tops.lut_attention(q, k, v, causal=False)
    direct = torch.einsum("bsf,fd->bsd",
                          o.transpose(1, 2).reshape(b, -1, h * dh),
                          bp["wo"]) + bp["bo"]
    assert torch.equal(routed, direct.to(routed.dtype))
    # the same layer under the kernel mode: on a CPU tensor the wrapper
    # takes the same plain version, and nothing is launched
    tops.reset_launch_counts()
    kernel, _ = tL.apply_attention(bp, x, cfg.with_(act_approx="cuda"),
                                   causal=False)
    assert torch.equal(kernel, routed)
    assert tops.launch_counts()["lut_attention"] == 0


def test_flash_lut_close_to_sdpa_lut_float():
    """Online-softmax (flash) against the float-LUT softmax of the sdpa
    path: one key tile here, so only the order of the float sums differs."""
    _, tcfg, _, tp = _setup("kwt-tiny")
    x = _mfcc(tcfg, 8)
    flash = trt.compile_model(tcfg, tp, backend="lut_float",
                              attention="flash_lut", device="cpu").forward(x)
    sdpa = trt.compile_model(tcfg, tp, backend="lut_float",
                             device="cpu").forward(x)
    assert float((flash - sdpa).abs().max()) < 1e-4


# ---------------------------------------------------------------------------
# the attention= knob
# ---------------------------------------------------------------------------

def test_attention_knob_pins_attn_impl_and_shows_in_describe():
    _, tcfg, _, tp = _setup("kwt-tiny")
    eng = trt.compile_model(tcfg, tp, backend="lut", attention="flash_lut",
                            device="cpu")
    assert eng.exec_cfg.attn_impl == "flash_lut"
    assert eng.describe().endswith(", attn=flash_lut")
    plain = trt.compile_model(tcfg, tp, backend="lut", device="cpu")
    assert plain.exec_cfg.attn_impl == "xla"
    assert "attn=" not in plain.describe()
    assert trt.get_backend("cuda").configure(
        tcfg, attention="flash_lut").attn_impl == "flash_lut"


def test_unknown_attention_raises_and_names_both():
    _, tcfg, _, tp = _setup("kwt-tiny")
    with pytest.raises(ValueError, match="xla, flash_lut"):
        trt.compile_model(tcfg, tp, backend="lut", attention="tpu_v7",
                          device="cpu")


def test_cuda_flash_lut_on_cpu_device_raises():
    _, tcfg, _, tp = _setup("kwt-tiny")
    with pytest.raises(ValueError, match="CUDA device"):
        trt.compile_model(tcfg, tp, backend="cuda", attention="flash_lut",
                          device="cpu")


# ---------------------------------------------------------------------------
# strided operands and the 3xTF32 split of the kernel
# ---------------------------------------------------------------------------

from repro_torch.kernels import lut_attention as tattn  # noqa: E402


@pytest.mark.parametrize("shape", [(2, 27, 1, 8), (3, 99, 1, 64),
                                   (2, 64, 4, 32), (1, 1, 2, 72)])
def test_stride_extraction_reads_the_layers_views(shape):
    """The layer hands the wrapper its ``[B, L, H, D]`` projections
    transposed to ``[B, H, L, D]``: the (batch, head, row) strides the
    kernel gets are those of the view, with no copy, and the CPU answer
    on the view is the answer on its contiguous copy."""
    b, l, h, d = shape
    rng = np.random.default_rng(sum(shape))
    base = [torch.from_numpy(rng.normal(size=shape).astype(np.float32))
            for _ in range(3)]
    q, k, v = (t.transpose(1, 2) for t in base)
    assert tattn.strides(q, "q") == (l * h * d, d, h * d)
    assert not q.is_contiguous() or h == 1 or l == 1
    got = tops.lut_attention(q, k, v, causal=False)
    want = tops.lut_attention(q.contiguous(), k.contiguous(), v.contiguous(),
                              causal=False)
    assert torch.equal(got, want)


def test_wrapper_refuses_a_non_unit_depth_stride():
    x = torch.zeros(1, 2, 3, 16)[..., ::2]          # depth stride 2
    assert x.shape[3] == 8 and x.stride(3) == 2
    with pytest.raises(ValueError, match="depth axis of q must have stride 1"):
        tops.lut_attention(x, x.contiguous(), x.contiguous())
    with pytest.raises(ValueError, match="depth axis of v"):
        tops.lut_attention(x.contiguous(), x.contiguous(), x)
    one = torch.zeros(1, 2, 3, 4)[..., :1]          # D = 1: any stride
    assert tattn.strides(one, "q") == (24, 12, 4)


def test_output_layout_makes_the_layers_reshape_a_view():
    """On the card the output is allocated ``[B, L, H, D]`` and returned
    transposed, so the layer's ``out.transpose(1, 2).reshape(B, L, H*D)``
    reads it in place."""
    q = torch.zeros(4, 3, 27, 8)
    out = tattn.empty_out(q)
    assert out.shape == q.shape and out.dtype == q.dtype
    flat = out.transpose(1, 2).reshape(4, 27, 3 * 8)
    assert flat.data_ptr() == out.data_ptr()
    assert out.transpose(1, 2).is_contiguous()


def _tf32_rna(x: np.ndarray) -> np.ndarray:
    """float32 -> TF32 (10 mantissa bits), to nearest, ties away from zero:
    the kernel's ``(bits + 0x1000) & ~0x1fff``."""
    u = x.astype(np.float32).view(np.uint32)
    return ((u + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def _tf32_trunc(x: np.ndarray) -> np.ndarray:
    """What the tensor core reads of a float32 operand: its top 10
    mantissa bits (the low 13 bits ignored)."""
    u = x.astype(np.float32).view(np.uint32)
    return (u & np.uint32(0xFFFFE000)).view(np.float32)


def _scores(q, k, split: bool) -> np.ndarray:
    """q k^T / 8 with TF32 operands, products summed in float64, the score
    rounded to float32: one pass of TF32, or the kernel's 3xTF32 split
    (``a_hi = rna(a)``, ``a_lo`` = ``a - a_hi`` truncated; ``a_lo b_hi +
    a_hi b_lo + a_hi b_hi``)."""
    qh, kh = _tf32_rna(q), _tf32_rna(k)
    if not split:
        s = np.einsum("bqd,bkd->bqk", qh.astype(np.float64),
                      kh.astype(np.float64))
    else:
        ql, kl = _tf32_trunc(q - qh), _tf32_trunc(k - kh)
        s = sum(np.einsum("bqd,bkd->bqk", a.astype(np.float64),
                          b.astype(np.float64))
                for a, b in ((ql, kh), (qh, kl), (qh, kh)))
    return (s.astype(np.float32) * np.float32(0.125)).astype(np.float32)


def _bins(s: np.ndarray) -> np.ndarray:
    m = s.max(axis=-1, keepdims=True)
    return np.clip(((m - s).clip(0, 10) * 32).astype(np.int64), 0, 319)


def test_3xtf32_split_keeps_the_lut_bins_where_single_tf32_does_not():
    """At KWT-1's shape (99 x 99 scores over D = 64, scale 1/8) a row's
    output moves when any of its scores moves to another 1/32 LUT bin.
    Against the float64 scores: with the kernel's 3xTF32 split more than
    ``ATTN_TIGHT_MIN_SHARE`` (98 %) of the rows keep every bin; with one
    pass of TF32 most rows lose one."""
    rng = np.random.default_rng(14)
    q = rng.normal(size=(64, 99, 64)).astype(np.float32)
    k = rng.normal(size=(64, 99, 64)).astype(np.float32)
    exact = (np.einsum("bqd,bkd->bqk", q.astype(np.float64),
                       k.astype(np.float64)) * 0.125)
    want = _bins(exact)
    kept = {split: float((_bins(_scores(q, k, split)) == want)
                         .all(axis=-1).mean()) for split in (True, False)}
    assert kept[True] >= 0.98, kept
    assert kept[False] < 0.98, kept
    assert kept[False] < 0.5, kept
