"""The dense LMs' layers in the port against the reference, on shared numpy
inputs and weights, on the CPU: the sigmoid-LUT SiLU, the squared ReLU,
``gather_descale``, RMSNorm and qk-norm, RoPE, the masked attention tile
and its query chunking, the KV-cache attention (scalar slice write and
per-lane scatter), the gated and squared-ReLU MLPs, and the int8 matmul
wrapper's bf16 activation and long K.

Tolerances, each beside what was measured on this host (PERF.md §6):

* integer and LUT stages (the sigmoid table, the LUT SiLU, the squared
  ReLU, ``gather_descale``, the fixed-point masked softmax) are bit-equal;
* float stages reduce in another order under PyTorch than under XLA:CPU:
  RMSNorm / LayerNorm and qk-norm within 1e-6 (measured 4.8e-7 / 2.4e-7),
  RoPE's tables and rotation within 1e-6 (measured 6.0e-8 / 2.4e-7), the
  attention tile, its chunking, the KV-cache attention, the MLPs and the
  exact SiLU within rtol / atol 1e-5 or 1e-6 (measured at most 3.6e-7,
  2.4e-7, 4.8e-7, 2.4e-7 and 9.5e-7);
* the ``cuda`` masked softmax against the reference's ``pallas`` one (in
  interpret mode) only where keys are at most 64 (ROADMAP C1: the Pallas
  kernel truncates its pre-shift where the oracle rounds); longer rows
  hold the port's plain version against the reference's oracle
  (``approx.softmax(mode="lut_fixed")`` of the masked scores: bit for bit;
  then zeroed and renormalised: rtol 1e-6, numpy summing the row in
  another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jregistry
from repro.core import approx as japprox
from repro.core import quant as jquant
from repro.models import layers as jL
from repro_torch import convert
from repro_torch.configs import registry as tregistry
from repro_torch.core import approx as tapprox
from repro_torch.core import quant as tquant
from repro_torch.kernels import ops as tops
from repro_torch.models import layers as tL

torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-5)
NORM_ATOL = 1e-6
ROPE_ATOL = 1e-6


def _cfgs(name="internlm2-1.8b", **kw):
    jc, tc = jregistry.get(name).smoke, tregistry.get(name).smoke
    return jc.with_(**kw), tc.with_(**kw)


def _np(x):
    return np.asarray(x)


def _t(x):
    return torch.from_numpy(np.array(x))


# ---------------------------------------------------------------------------
# activations
# ---------------------------------------------------------------------------

def test_sigmoid_table_equals_reference():
    assert np.array_equal(tapprox._sigmoid_table(),
                          _np(japprox._sigmoid_table()))
    assert tapprox._sigmoid_table().dtype == np.float32


def _act_inputs(seed=0):
    rng = np.random.default_rng(seed)
    x = (rng.normal(0, 4, 4096)).astype(np.float32)
    # the table's edges, its bin midpoints (round half to even) and beyond
    step = 16.0 / 255.0
    edges = np.array([-8, 8, -8.0001, 8.0001, 0, -20, 20, step / 2,
                      -step / 2, 3 * step / 2], np.float32)
    x[:edges.size] = edges
    return x


def test_sigmoid_lut_equals_reference():
    x = _act_inputs()
    assert np.array_equal(tapprox.sigmoid_lut(_t(x)).numpy(),
                          _np(japprox.sigmoid_lut(jnp.asarray(x))))


@pytest.mark.parametrize("mode", ["exact", "lut", "cuda"])
def test_silu_activation_matches_reference(mode):
    """``cuda`` SiLU is the LUT (the kernels cover GELU and softmax), as
    the reference's ``pallas`` one is."""
    x = _act_inputs(1)
    jmode = {"cuda": "pallas"}.get(mode, mode)
    got = tapprox.activation("silu", mode)(_t(x)).numpy()
    want = _np(japprox.activation("silu", jmode)(jnp.asarray(x)))
    if mode == "exact":
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    else:
        assert np.array_equal(got, want)


@pytest.mark.parametrize("name", ["sqrelu", "relu"])
def test_polynomial_activations_equal_reference(name):
    x = _act_inputs(2)
    got = tapprox.activation(name, "cuda")(_t(x)).numpy()
    want = _np(japprox.activation(name, "pallas")(jnp.asarray(x)))
    assert np.array_equal(got, want)


def test_silu_lut_trains_through_the_exact_gradient():
    x = _t(_act_inputs(3)).requires_grad_(True)
    y = tapprox.silu(x, mode="lut")
    (g,) = torch.autograd.grad(y.sum(), x)
    (want,) = torch.autograd.grad(tapprox.silu_exact(x).sum(), x)
    assert torch.equal(g, want)
    assert torch.equal(y.detach(), tapprox.silu(x.detach(), mode="lut"))


def test_unknown_activation_raises():
    with pytest.raises(ValueError, match="softplus"):
        tapprox.activation("softplus")


# ---------------------------------------------------------------------------
# gather_descale
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("per_channel", [False, True])
def test_gather_descale_equals_reference(bits, per_channel):
    rng = np.random.default_rng(bits)
    lo, hi = -(2 ** (bits - 1)), 2 ** (bits - 1) - 1
    grid = rng.integers(lo, hi + 1, (300, 24))
    axis = rng.integers(-8, 9, 24).astype(np.int8) if per_channel else None
    jw = jquant.QTensor.store(jnp.asarray(grid), 6, bits=bits,
                              axis_exponents=None if axis is None
                              else jnp.asarray(axis))
    tw = tquant.QTensor.store(torch.from_numpy(grid), 6, bits=bits,
                              axis_exponents=None if axis is None
                              else torch.from_numpy(axis))
    idx = rng.integers(0, 300, (3, 7)).astype(np.int32)
    got = tquant.gather_descale(tw, _t(idx)).numpy()
    want = _np(jquant.gather_descale(jw, jnp.asarray(idx)))
    assert got.shape == (3, 7, 24) and np.array_equal(got, want)
    # only the rows looked up, equal to the dequantised table's rows
    assert np.array_equal(got, tw.dequantize().numpy()[idx])


def test_embed_rows_float_and_packed():
    rng = np.random.default_rng(0)
    table = rng.normal(0, 1, (50, 8)).astype(np.float32)
    idx = rng.integers(0, 50, (2, 5)).astype(np.int32)
    got = tL.embed_rows(_t(table), _t(idx)).numpy()
    assert np.array_equal(got, _np(jL.embed_rows(jnp.asarray(table),
                                                 jnp.asarray(idx))))
    q = tquant.quantize_po2(_t(table), 6, rounding="nearest")
    assert torch.equal(tL.embed_rows(q, _t(idx)),
                       tquant.gather_descale(q, _t(idx)))


# ---------------------------------------------------------------------------
# norms and RoPE
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["internlm2-1.8b", "nemotron-4-340b"])
def test_norm_matches_reference(name):
    """RMSNorm (internlm2) and LayerNorm (nemotron)."""
    jc, tc = _cfgs(name)
    rng = np.random.default_rng(0)
    x = rng.normal(0, 2, (2, 9, tc.d_model)).astype(np.float32)
    jp = jL.norm_params(jc)
    p = {k: rng.normal(1, 0.1, v.shape).astype(np.float32)
         for k, v in jp.items()}
    assert set(tL.norm_params(tc)) == set(jp)
    got = tL.apply_norm(convert.from_numpy_tree(p, "cpu"), _t(x), tc).numpy()
    want = _np(jL.apply_norm(jax.tree.map(jnp.asarray, p), jnp.asarray(x),
                             jc))
    np.testing.assert_allclose(got, want, rtol=0, atol=NORM_ATOL)


def test_qk_norm_rms_matches_reference():
    rng = np.random.default_rng(1)
    x = rng.normal(0, 2, (2, 5, 4, 16)).astype(np.float32)
    scale = rng.normal(1, 0.1, 16).astype(np.float32)
    got = tL._rms(_t(x), _t(scale)).numpy()
    want = _np(jL._rms(jnp.asarray(x), jnp.asarray(scale)))
    np.testing.assert_allclose(got, want, rtol=0, atol=NORM_ATOL)


@pytest.mark.parametrize("per_lane", [False, True])
def test_rope_matches_reference(per_lane):
    rng = np.random.default_rng(2)
    pos = np.array([[3], [17]], np.int32) if per_lane \
        else np.arange(5, 25, dtype=np.int32)
    tc_, ts_ = tL.rope_tables(_t(pos), 16, 10000.0)
    jc_, js_ = jL.rope_tables(jnp.asarray(pos), 16, 10000.0)
    np.testing.assert_allclose(tc_.numpy(), _np(jc_), rtol=0, atol=ROPE_ATOL)
    np.testing.assert_allclose(ts_.numpy(), _np(js_), rtol=0, atol=ROPE_ATOL)
    s = pos.shape[-1]
    x = rng.normal(0, 1, (2, s, 4, 16)).astype(np.float32)
    got = tL.apply_rope(_t(x), tc_[..., :, None, :], ts_[..., :, None, :])
    want = jL.apply_rope(jnp.asarray(x), jc_[..., :, None, :],
                         js_[..., :, None, :])
    np.testing.assert_allclose(got.numpy(), _np(want), rtol=0,
                               atol=ROPE_ATOL)


# ---------------------------------------------------------------------------
# the masked attention tile, chunking, the KV cache
# ---------------------------------------------------------------------------

def _qkv(b, sq, sk, h=4, kv=2, d=16, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.normal(0, 1, (b, sq, h, d)).astype(np.float32),
            rng.normal(0, 1, (b, sk, kv, d)).astype(np.float32),
            rng.normal(0, 1, (b, sk, kv, d)).astype(np.float32))


CASES = {
    # name: (b, sq, sk, q_offset, kv_len_valid, causal)
    "causal": (2, 12, 12, 0, None, True),
    "decode_scalar": (2, 1, 20, 9, 10, True),
    "valid_only": (2, 6, 20, 0, 13, False),
    "per_lane": (3, 1, 24, np.array([2, 11, 23]), np.array([3, 12, 24]),
                 True),
}
# the plan's softmax mode -> the reference's
MODES = {"exact": "exact", "lut": "lut", "lut_fixed": "lut_fixed",
         "cuda": "pallas"}


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("mode", list(MODES))
def test_sdpa_block_matches_reference(case, mode):
    b, sq, sk, q_off, valid, causal = CASES[case]
    jc, tc = _cfgs(softmax_mode=MODES[mode])
    tc = tc.with_(softmax_mode=mode)
    q, k, v = _qkv(b, sq, sk)

    def conv(a, to):
        return a if not isinstance(a, np.ndarray) else to(a.astype(np.int32))

    got = tL._sdpa_block(_t(q), _t(k), _t(v), tc, q0=0, k0=0,
                         q_offset=conv(q_off, _t),
                         kv_len_valid=conv(valid, _t), causal=causal)
    want = jL._sdpa_block(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jc,
                          q0=0, k0=0, q_offset=conv(q_off, jnp.asarray),
                          kv_len_valid=conv(valid, jnp.asarray),
                          causal=causal)
    np.testing.assert_allclose(got.numpy(), _np(want), **TOL)


@pytest.mark.parametrize("mode", ["exact", "lut", "lut_fixed"])
def test_sdpa_chunks_long_queries_like_reference(mode):
    """Sq = 600 > Q_CHUNK = 512: two chunks, each against its causal key
    window, on the plain plans (the cuda plan's rows here exceed 64 keys:
    see the oracle test below)."""
    jc, tc = _cfgs(softmax_mode=mode)
    q, k, v = _qkv(1, 600, 600, h=2, kv=1, d=8, seed=4)
    got = tL.sdpa(_t(q), _t(k), _t(v), tc, q_offset=0, kv_len_valid=None)
    want = jL.sdpa(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jc,
                   q_offset=0, kv_len_valid=None)
    np.testing.assert_allclose(got.numpy(), _np(want), **TOL)
    one = tL._sdpa_block(_t(q), _t(k), _t(v), tc, q0=0, k0=0, q_offset=0,
                         kv_len_valid=None, causal=True)
    np.testing.assert_allclose(got.numpy(), one.numpy(), **TOL)


def test_sdpa_chunking_refuses_an_offset():
    _, tc = _cfgs()
    q, k, v = _qkv(1, 600, 600, h=2, kv=1, d=8)
    with pytest.raises(ValueError, match="start position"):
        tL.sdpa(_t(q), _t(k), _t(v), tc, q_offset=3, kv_len_valid=None)


@pytest.mark.parametrize("sk", [100, 600])
@pytest.mark.parametrize("kind", ["causal", "per_lane"])
def test_cuda_masked_softmax_long_rows_match_reference_oracle(sk, kind):
    """Rows longer than 64 keys: the port's masked ``cuda`` softmax (its
    plain version here) against the reference's oracle — the fixed-point
    softmax of the masked scores, zeroed and renormalised as the pallas
    branch does — bit for bit."""
    rng = np.random.default_rng(sk)
    sq = 4 if kind == "causal" else 1
    s = (rng.normal(0, 3, (2, 2, 2, sq, sk))).astype(np.float32)
    if kind == "causal":
        qpos = np.arange(sq) + sk - sq
        mask = (qpos[:, None] >= np.arange(sk))[None, None, None]
    else:
        lanes = np.array([sk // 3, sk - 1])
        mask = (np.arange(sk) < lanes[:, None, None])[:, None, None]
        mask = np.broadcast_to(mask, (2, 1, 1, sq, sk))
    got = tapprox.masked_softmax(_t(s), _t(mask), mode="cuda").numpy()
    neg = np.finfo(np.float32).min
    sm = np.where(mask, s, neg)
    o = _np(japprox.softmax(jnp.asarray(sm), mode="lut_fixed"))
    # the fixed-point pipeline the kernel runs: bit for bit
    assert np.array_equal(tops.lut_softmax(_t(sm), fixed=True).numpy(), o)
    # then the zeroing and the float32 renormalisation, whose row sum
    # numpy takes in another order
    o = np.where(mask, o, np.float32(0))
    want = o / np.maximum(o.sum(-1, keepdims=True), np.float32(1e-30))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
    assert np.array_equal(got == 0, ~np.broadcast_to(mask, got.shape))


def _attn_params(tc, seed=0, bias=False):
    rng = np.random.default_rng(seed)
    d, h, kv, dh = tc.d_model, tc.n_heads, tc.n_kv_heads, tc.resolved_head_dim
    p = {"wq": (d, h * dh), "wk": (d, kv * dh), "wv": (d, kv * dh),
         "wo": (h * dh, d)}
    p = {k: rng.normal(0, 1 / np.sqrt(s[0]), s).astype(np.float32)
         for k, s in p.items()}
    if bias:
        for k, n in (("bq", h * dh), ("bk", kv * dh), ("bv", kv * dh)):
            p[k] = rng.normal(0, 0.1, n).astype(np.float32)
    if tc.qk_norm:
        p["q_norm"] = rng.normal(1, 0.1, dh).astype(np.float32)
        p["k_norm"] = rng.normal(1, 0.1, dh).astype(np.float32)
    return p


@pytest.mark.parametrize("name", ["internlm2-1.8b", "qwen2.5-14b",
                                  "chameleon-34b"])
@pytest.mark.parametrize("mode", ["exact", "lut_fixed"])
def test_kv_cache_attention_matches_reference(name, mode):
    """A prefill of 5 tokens into a cache of 12 (scalar slice write), then
    one per-lane decode token (scatter at each lane's index): outputs and
    caches against the reference's; GQA, QKV bias, qk-norm."""
    jc, tc = _cfgs(name, softmax_mode=mode)
    p = _attn_params(tc, bias=tc.qkv_bias)
    assert set(p) == set(jL.attention_params(jc, jax.random.PRNGKey(0)))
    jp, tp = jax.tree.map(jnp.asarray, p), convert.from_numpy_tree(p, "cpu")
    rng = np.random.default_rng(5)
    b, d = 2, tc.d_model
    x = rng.normal(0, 1, (b, 5, d)).astype(np.float32)
    jcache = jL.init_kv_cache(jc, b, 12)
    tcache = tL.init_kv_cache(tc, b, 12)
    pos = np.arange(5, dtype=np.int32)
    jo, jcache = jL.apply_attention(jp, jnp.asarray(x), jc,
                                    positions=jnp.asarray(pos), cache=jcache,
                                    cache_index=0, kv_len_valid=5)
    to, tcache2 = tL.apply_attention(tp, _t(x), tc, positions=_t(pos),
                                     cache=tcache, cache_index=0,
                                     kv_len_valid=5)
    assert tcache2 is tcache                    # written in place
    np.testing.assert_allclose(to.numpy(), _np(jo), **TOL)
    np.testing.assert_allclose(tcache["k"].numpy(), _np(jcache["k"]), **TOL)
    # one token per lane at the lanes' own depths
    idx = np.array([5, 3], np.int32)
    x1 = rng.normal(0, 1, (b, 1, d)).astype(np.float32)
    jo, jcache = jL.apply_attention(
        jp, jnp.asarray(x1), jc, positions=jnp.asarray(idx[:, None]),
        cache=jcache, cache_index=jnp.asarray(idx),
        kv_len_valid=jnp.asarray(idx + 1))
    to, _ = tL.apply_attention(tp, _t(x1), tc, positions=_t(idx[:, None]),
                               cache=tcache, cache_index=_t(idx),
                               kv_len_valid=_t(idx + 1))
    np.testing.assert_allclose(to.numpy(), _np(jo), **TOL)
    for key in ("k", "v"):
        np.testing.assert_allclose(tcache[key].numpy(), _np(jcache[key]),
                                   **TOL)


def test_per_lane_cache_write_refuses_several_tokens():
    _, tc = _cfgs()
    tp = convert.from_numpy_tree(_attn_params(tc), "cpu")
    cache = tL.init_kv_cache(tc, 2, 8)
    with pytest.raises(ValueError, match="one-token"):
        tL.apply_attention(tp, torch.zeros(2, 3, tc.d_model), tc,
                           positions=torch.zeros(2, 3, dtype=torch.long),
                           cache=cache, cache_index=torch.tensor([0, 1]))


def test_int8_kv_cache_is_int8_and_written_in_place():
    """The int8 KV cache (tests/test_torch_kvcache.py holds it against the
    reference): codes and scales in the caller's tensors, the layer's
    output within the quantisation error of the float cache's."""
    _, tc = _cfgs()
    tp = convert.from_numpy_tree(_attn_params(tc), "cpu")
    x = torch.from_numpy(np.random.default_rng(7).normal(
        0, 1, (1, 3, tc.d_model)).astype(np.float32))
    from repro_torch.configs.base import QuantConfig
    kvq = tc.with_(quant=QuantConfig(quantize_kv_cache=True))
    cache = tL.init_kv_cache(kvq, 1, 4, dtype=torch.bfloat16)
    assert {k: v.dtype for k, v in cache.items()} == {
        "k": torch.int8, "ks": torch.float32, "v": torch.int8,
        "vs": torch.float32}
    k0 = cache["k"]
    out, got = tL.apply_attention(tp, x, kvq, positions=torch.arange(3),
                                  cache=cache, cache_index=0)
    assert got is cache and cache["k"] is k0
    # each written vector's largest code is above half the int8 range
    top = cache["k"][:, :3].abs().amax(-1)
    assert int(top.min()) >= 64 and int(top.max()) <= 127
    assert float(cache["ks"][:, 3:].min()) == 1.0       # unwritten slot
    want, _ = tL.apply_attention(tp, x, tc, positions=torch.arange(3),
                                 cache=tL.init_kv_cache(tc, 1, 4),
                                 cache_index=0)
    assert float((out - want).abs().max()) < 0.05 * float(want.abs().max())


# ---------------------------------------------------------------------------
# MLPs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["internlm2-1.8b", "nemotron-4-340b"])
@pytest.mark.parametrize("act", ["exact", "lut"])
def test_mlp_matches_reference(name, act):
    """The gated SiLU MLP (internlm2) and the ungated squared-ReLU one
    (nemotron)."""
    jc, tc = _cfgs(name, act_approx=act)
    jshapes = jax.eval_shape(lambda k: jL.mlp_params(jc, k),
                             jax.random.PRNGKey(0))
    rng = np.random.default_rng(6)
    p = {k: rng.normal(0, 1 / np.sqrt(s.shape[0]), s.shape).astype(np.float32)
         for k, s in jshapes.items()}
    fresh = tL.mlp_params(tc, torch.Generator().manual_seed(0))
    assert {k: tuple(v.shape) for k, v in fresh.items()} == \
        {k: s.shape for k, s in jshapes.items()}
    x = rng.normal(0, 1, (2, 7, tc.d_model)).astype(np.float32)
    got = tL.apply_mlp(convert.from_numpy_tree(p, "cpu"), _t(x), tc).numpy()
    want = _np(jL.apply_mlp(jax.tree.map(jnp.asarray, p), jnp.asarray(x), jc))
    np.testing.assert_allclose(got, want, **TOL)


# ---------------------------------------------------------------------------
# the int8 matmul wrapper on the LM's operands
# ---------------------------------------------------------------------------

def test_int8_matmul_takes_a_bf16_activation_as_its_float32_cast():
    rng = np.random.default_rng(7)
    x = torch.from_numpy(rng.normal(0, 2, (3, 64)).astype(np.float32))
    xb = x.to(torch.bfloat16)
    w = tquant.QTensor.store(torch.from_numpy(rng.integers(-128, 128, (64, 40))),
                             6, axis_exponents=torch.from_numpy(
                                 rng.integers(-4, 5, 40).astype(np.int8)))
    got = tops.int8_matmul(xb, w, x_exp=5, residual_bits=16)
    want = tops.int8_matmul(xb.to(torch.float32), w, x_exp=5,
                            residual_bits=16)
    assert got.dtype == torch.float32 and torch.equal(got, want)


@pytest.mark.parametrize("k", [300, 2048])
def test_head_sized_int8_matmul_equals_reference_int_exec(k):
    """K beyond the one-slab kernel (the LM head's K = 2048): the wrapper's
    plain version against the reference's integer-executing linear, bit for
    bit, per-channel exponents included."""
    rng = np.random.default_rng(k)
    x = rng.normal(0, 2, (2, 3, k)).astype(np.float32)
    grid = rng.integers(-128, 128, (k, 257))
    axis = rng.integers(-6, 7, 257).astype(np.int8)
    tw = tquant.QTensor.store(torch.from_numpy(grid), 6,
                              axis_exponents=torch.from_numpy(axis))
    jw = jquant.QTensor.store(jnp.asarray(grid), 6,
                              axis_exponents=jnp.asarray(axis))
    got = tquant.int_exec_einsum("...d,dv->...v", _t(x), tw, x_exp=5,
                                 use_kernel=True)
    want = jquant.int_exec_einsum("...d,dv->...v", jnp.asarray(x), jw,
                                  x_exp=5)
    assert np.array_equal(got.numpy(), _np(want))
