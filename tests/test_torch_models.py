"""repro_torch.models / configs / convert against the reference, on
shared numpy weights and inputs.

Float stages (LayerNorm, the score and P.V products, exact softmax and
GELU) reduce in another order under PyTorch than under XLA:CPU:
rtol 1e-5 / atol 1e-5.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jregistry
from repro.models import kwt as jkwt
from repro.models import layers as jL
from repro.runtime import QuantRecipe as JRecipe
from repro_torch import convert
from repro_torch.configs import registry as tregistry
from repro_torch.core import quant as tquant
from repro_torch.core import tree as ttree
from repro_torch.models import kwt as tkwt
from repro_torch.models import layers as tL

torch.set_num_threads(1)


TOL = dict(rtol=1e-5, atol=1e-5)


def _np_params(jcfg, seed=0):
    """Reference-layout parameters with every leaf random (the reference
    initialises biases to zero, which would hide a dropped bias)."""
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


def _both(name, seed=0, smoke=False):
    je, te = jregistry.get(name), tregistry.get(name)
    jcfg, tcfg = (je.smoke, te.smoke) if smoke else (je.config, te.config)
    npp = _np_params(jcfg, seed)
    return jcfg, tcfg, jax.tree.map(jnp.asarray, npp), \
        convert.from_numpy_tree(npp, "cpu")


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["kwt-tiny", "kwt-1"])
def test_config_field_sets_and_values_equal_reference(name):
    je, te = jregistry.get(name), tregistry.get(name)
    for jc, tc in ((je.config, te.config), (je.smoke, te.smoke)):
        jf = {f.name for f in dataclasses.fields(jc)}
        tf = {f.name for f in dataclasses.fields(tc)}
        assert jf == tf
        jd, td = dataclasses.asdict(jc), dataclasses.asdict(tc)
        assert jd == td
        assert tc.resolved_head_dim == jc.resolved_head_dim
        assert tkwt.seqlen(tc) == jkwt.seqlen(jc)
    assert te.shapes == je.shapes and te.skips == je.skips
    assert te.config.with_(n_layers=3).n_layers == 3
    assert sorted(tregistry.all_entries()) == sorted(jregistry.all_entries())


# ---------------------------------------------------------------------------
# convert
# ---------------------------------------------------------------------------

def test_convert_float_tree_roundtrip():
    jcfg, _, _, tparams = _both("kwt-tiny")
    npp = _np_params(jcfg)
    back = convert.to_numpy_tree(tparams)
    flat_a = jax.tree.leaves(npp)
    flat_b = jax.tree.leaves(back)
    assert len(flat_a) == len(flat_b) == len(ttree.tree_leaves(tparams))
    for a, b in zip(flat_a, flat_b):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    assert tkwt.count_params(tparams) == jkwt.count_params(
        jax.tree.map(jnp.asarray, npp))


@pytest.mark.parametrize("bits,per_channel", [(8, False), (4, False), (4, True)])
def test_convert_carries_a_reference_quantised_tree(bits, per_channel):
    """A tree quantised by the reference deploys in the port as-is: same
    stored bytes, same dequantised values, and it survives the round trip
    through ``to_numpy_tree``."""
    jcfg, _, jparams, tparams = _both("kwt-tiny")
    jq = JRecipe.from_config(jcfg, bits=bits, weight_exponent=6 if bits == 8
                             else 2, per_channel=per_channel).quantize(jparams)
    tq = convert.from_numpy_tree(jax.tree.map(np.asarray, jq), "cpu")
    again = convert.from_numpy_tree(convert.to_numpy_tree(tq), "cpu")
    jleaves = jax.tree.leaves(jq, is_leaf=lambda x: hasattr(x, "exponent"))
    for jl, tl, al in zip(jleaves, ttree.tree_leaves(tq), ttree.tree_leaves(again)):
        if hasattr(jl, "exponent"):
            assert isinstance(tl, tquant.QTensor) and isinstance(al, tquant.QTensor)
            assert tl.stored_bytes == jl.stored_bytes == al.stored_bytes
            assert (tl.exponent, tl.bits, tl.logical_shape) == \
                (jl.exponent, jl.bits, jl.logical_shape)
            assert np.array_equal(tl.values.numpy(), np.asarray(jl.values))
            assert np.array_equal(al.values.numpy(), np.asarray(jl.values))
            assert (tl.axis_exponents is None) == (jl.axis_exponents is None)
            assert np.array_equal(tl.dequantize().numpy(),
                                  np.asarray(jl.dequantize()))
        else:
            assert np.array_equal(tl.numpy(), np.asarray(jl))
    q = convert.qtensor_from_numpy(np.asarray(jq["proj_w"].values),
                                   jq["proj_w"].exponent,
                                   None if jq["proj_w"].axis_exponents is None
                                   else np.asarray(jq["proj_w"].axis_exponents),
                                   bits, jq["proj_w"].logical_shape,
                                   device="cpu")
    assert np.array_equal(q.int_values().numpy(),
                          np.asarray(jq["proj_w"].int_values()))


# ---------------------------------------------------------------------------
# layers, float plan
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["kwt-tiny", "kwt-1"])
def test_apply_norm_matches(name):
    jcfg, tcfg, jp, tp = _both(name, smoke=True)
    rng = np.random.default_rng(1)
    x = rng.normal(0, 2, (3, tkwt.seqlen(tcfg), tcfg.d_model)).astype(np.float32)
    want = jL.apply_norm(jp["blocks"][0]["ln1"], jnp.asarray(x), jcfg)
    got = tL.apply_norm(tp["blocks"][0]["ln1"], torch.from_numpy(x), tcfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    fresh = tL.norm_params(tcfg)
    assert set(fresh) == set(jL.norm_params(jcfg))


@pytest.mark.parametrize("name", ["kwt-tiny", "kwt-1"])
@pytest.mark.parametrize("causal", [False, True])
def test_apply_attention_matches(name, causal):
    jcfg, tcfg, jp, tp = _both(name, smoke=True)
    rng = np.random.default_rng(2)
    x = rng.normal(0, 1, (2, tkwt.seqlen(tcfg), tcfg.d_model)).astype(np.float32)
    want, _ = jL.apply_attention(jp["blocks"][0]["attn"], jnp.asarray(x), jcfg,
                                 positions=jnp.arange(x.shape[1]), causal=causal)
    got, cache = tL.apply_attention(tp["blocks"][0]["attn"], torch.from_numpy(x),
                                    tcfg, causal=causal)
    assert cache is None
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("softmax_mode", ["lut", "lut_fixed"])
def test_apply_attention_lut_modes_causal_match(softmax_mode):
    jcfg, tcfg, jp, tp = _both("kwt-tiny")
    jcfg = jcfg.with_(softmax_mode=softmax_mode)
    tcfg = tcfg.with_(softmax_mode=softmax_mode)
    rng = np.random.default_rng(3)
    x = rng.normal(0, 1, (2, 27, 12)).astype(np.float32)
    want, _ = jL.apply_attention(jp["blocks"][0]["attn"], jnp.asarray(x), jcfg,
                                 positions=jnp.arange(27), causal=True)
    got, _ = tL.apply_attention(tp["blocks"][0]["attn"], torch.from_numpy(x),
                                tcfg, causal=True)
    # Measured on these inputs (and three other seeds): every one of the 648
    # outputs within 4.8e-7.  A one-ulp score difference can move a lane to
    # the next 1/32 LUT bin (a 3% change of one weight, under 0.05 of an
    # output), so a few elements may miss float accuracy, none by more.
    diff = np.abs(got.numpy() - np.asarray(want))
    assert np.mean(diff <= 1e-5) >= 0.99 and diff.max() < 0.05


@pytest.mark.parametrize("name", ["kwt-tiny", "kwt-1"])
@pytest.mark.parametrize("act_approx", ["exact", "lut"])
def test_apply_mlp_matches(name, act_approx):
    jcfg, tcfg, jp, tp = _both(name, smoke=True)
    jcfg, tcfg = jcfg.with_(act_approx=act_approx), tcfg.with_(act_approx=act_approx)
    rng = np.random.default_rng(4)
    x = rng.normal(0, 1, (2, tkwt.seqlen(tcfg), tcfg.d_model)).astype(np.float32)
    want = jL.apply_mlp(jp["blocks"][0]["mlp"], jnp.asarray(x), jcfg)
    got = tL.apply_mlp(tp["blocks"][0]["mlp"], torch.from_numpy(x), tcfg)
    if act_approx == "exact":
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    else:
        # a pre-activation one ulp apart can land in the next of 32 LUT bins
        # (bin height <= 0.13); nearly every element agrees to float accuracy
        diff = np.abs(got.numpy() - np.asarray(want))
        assert np.mean(diff <= 1e-5) > 0.999 and diff.max() < 0.2


@pytest.mark.parametrize("name", ["kwt-tiny", "kwt-1"])
def test_embed_frames_and_encode_window_match(name):
    jcfg, tcfg, jp, tp = _both(name, smoke=True)
    rng = np.random.default_rng(5)
    f, t = tcfg.input_dim
    frames = rng.normal(0, 1, (3, t, f)).astype(np.float32)
    want_e = jkwt.embed_frames(jp, jnp.asarray(frames), jcfg)
    got_e = tkwt.embed_frames(tp, torch.from_numpy(frames), tcfg)
    np.testing.assert_allclose(got_e.numpy(), np.asarray(want_e), **TOL)
    window = rng.normal(0, 1, (3, t, tcfg.d_model)).astype(np.float32)
    want = jkwt.encode_window(jp, jnp.asarray(window), jcfg)
    got = tkwt.encode_window(tp, torch.from_numpy(window), tcfg)
    assert got.dtype == torch.float32 and tuple(got.shape) == (3, tcfg.n_classes)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=2e-5)
    mfcc = np.swapaxes(frames, 1, 2).copy()
    want_f = jkwt.forward(jp, jnp.asarray(mfcc), jcfg)
    got_f = tkwt.forward(tp, torch.from_numpy(mfcc), tcfg)
    np.testing.assert_allclose(got_f.numpy(), np.asarray(want_f), rtol=1e-5,
                               atol=2e-5)
    labels = np.asarray(want_f).argmax(-1)
    acc = tkwt.accuracy(tp, {"mfcc": torch.from_numpy(mfcc),
                             "labels": torch.from_numpy(labels)}, tcfg)
    assert float(acc) == 1.0


def test_init_params_layout_matches_reference_and_device_rule():
    jcfg = jregistry.get("kwt-1").smoke
    tcfg = tregistry.get("kwt-1").smoke
    tp = tkwt.init_params(tcfg, torch.Generator().manual_seed(0), device="cpu")
    jp = jkwt.init_params(jcfg, jax.random.PRNGKey(0))
    jshapes = jax.tree.map(lambda a: (tuple(a.shape), str(a.dtype)), jp)
    tshapes = jax.tree.map(lambda a: (tuple(a.shape), str(a.dtype)),
                           convert.to_numpy_tree(tp))
    assert jshapes == tshapes
    assert tkwt.count_params(tp) == jkwt.count_params(jp)
    again = tkwt.init_params(tcfg, torch.Generator().manual_seed(0), device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(ttree.tree_leaves(tp), ttree.tree_leaves(again)))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            tkwt.init_params(tcfg, torch.Generator().manual_seed(0))


def test_kwt_attention_over_an_int8_kv_cache_matches_reference():
    """The int8 KV cache (tests/test_torch_kvcache.py for the LMs) under
    KWT-Tiny's biased, rope-less attention: a bidirectional pass of the 27
    frames written into the cache at index 0, output and codes and scales
    against the reference's."""
    from repro.configs.base import QuantConfig as JQuant
    from repro_torch.configs.base import QuantConfig
    jcfg = jregistry.get("kwt-tiny").config.with_(
        quant=JQuant(quantize_kv_cache=True))
    tcfg = tregistry.get("kwt-tiny").config.with_(
        quant=QuantConfig(quantize_kv_cache=True))
    shapes = jL.attention_params(jcfg, jax.random.PRNGKey(0))
    rng = np.random.default_rng(3)
    p = {k: rng.normal(0, 0.3, v.shape).astype(np.float32)
         for k, v in shapes.items()}
    x = rng.normal(0, 1, (2, 27, tcfg.d_model)).astype(np.float32)
    jcache = jL.init_kv_cache(jcfg, 2, 27)
    tcache = tL.init_kv_cache(tcfg, 2, 27)
    assert tcache["k"].dtype == torch.int8 and tcache["ks"].shape == (2, 27, 1)
    jo, jcache = jL.apply_attention(
        jax.tree.map(jnp.asarray, p), jnp.asarray(x), jcfg,
        positions=jnp.arange(27), cache=jcache, cache_index=0, causal=False)
    to, out_cache = tL.apply_attention(
        convert.from_numpy_tree(p, "cpu"), torch.from_numpy(x), tcfg,
        cache=tcache, cache_index=0, causal=False)
    assert out_cache is tcache
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), **TOL)
    for key in ("k", "ks", "v", "vs"):
        assert np.array_equal(tcache[key].numpy(), np.asarray(jcache[key]))
