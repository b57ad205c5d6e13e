"""repro_torch.core against repro.core: LUT tables, Q8.24 arithmetic, the
nibble codec and the eq-9 quantisers, bit for bit on shared numpy inputs.

Every comparison here is exact (``array_equal``): these stages are integer
or power-of-two arithmetic with no reduction whose order could differ.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import fixedpoint as jfxp
from repro.core import lut as jlut
from repro.core import quant as jquant
from repro_torch.core import fixedpoint as tfxp
from repro_torch.core import lut as tlut
from repro_torch.core import quant as tquant

torch.set_num_threads(1)

I32_MIN, I32_MAX = -(2**31), 2**31 - 1


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _eq(got, want) -> bool:
    want = np.asarray(want)
    got = got.numpy()
    return got.dtype == want.dtype and np.array_equal(got, want)


def _edge_i32(rng, n=4096):
    edges = np.array([I32_MIN, I32_MIN + 1, -(1 << 24), -4097, -4096, -1, 0, 1,
                      2, 3, 4095, 4096, (1 << 24) - 1, 1 << 24, (1 << 24) + 1,
                      1 << 30, I32_MAX - 1, I32_MAX], np.int32)
    return np.concatenate([edges, rng.integers(I32_MIN, I32_MAX, n,
                                               dtype=np.int64).astype(np.int32)])


# ---------------------------------------------------------------------------
# LUT bank
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["exp_f32", "inv_f32", "gelu_f32",
                                  "exp_q24", "inv_q24", "gelu_q24"])
def test_lut_tables_equal(name):
    want = getattr(jlut.make_lut_bank(), name)
    got = getattr(tlut.make_lut_bank(), name)
    assert got.dtype == want.dtype and np.array_equal(got, want)
    assert _eq(tlut.bank_tensors("cpu")[name], want)
    assert tlut.make_lut_bank().rom_bytes == jlut.make_lut_bank().rom_bytes == 2688


# ---------------------------------------------------------------------------
# Q8.24 fixed point
# ---------------------------------------------------------------------------

def test_to_fixed_and_to_float_bit_exact():
    rng = np.random.default_rng(0)
    x = np.concatenate([
        rng.normal(0, 40, 4096), rng.uniform(-1, 1, 4096),
        [0.0, -0.0, 0.5 / (1 << 24), 1.5 / (1 << 24), 2.5 / (1 << 24),
         -0.5 / (1 << 24), 127.99999, 128.0, -128.0, -129.0, 200.0, 1e9,
         -1e9, 3.0e38, -3.0e38]]).astype(np.float32)
    want = jfxp.to_fixed(jnp.asarray(x))
    got = tfxp.to_fixed(_t(x))
    assert _eq(got, want)
    q = _edge_i32(rng)
    assert _eq(tfxp.to_float(_t(q)), jfxp.to_float(jnp.asarray(q)))


@pytest.mark.parametrize("nonneg", [False, True])
def test_fixed_mul_bit_exact(nonneg):
    rng = np.random.default_rng(1)
    lo = 0 if nonneg else -(1 << 24)
    a = rng.integers(lo, (1 << 24) + 1, 8192).astype(np.int32)
    b = rng.integers(lo, (1 << 24) + 1, 8192).astype(np.int32)
    a[:4] = [0, 1 << 24, 1 << 24, 1]
    b[:4] = [1 << 24, 1 << 24, 0, 1]
    want = jfxp.fixed_mul(jnp.asarray(a), jnp.asarray(b), nonneg=nonneg)
    assert _eq(tfxp.fixed_mul(_t(a), _t(b), nonneg=nonneg), want)


@pytest.mark.parametrize("shift", [-31, -7, -1, 0, 1, 3, 8, 24, 30])
def test_fixed_shift_mul_saturation_bit_exact(shift):
    q = _edge_i32(np.random.default_rng(2))
    want = jfxp.fixed_shift_mul(jnp.asarray(q), shift)
    assert _eq(tfxp.fixed_shift_mul(_t(q), shift), want)


def test_ilog2_bit_exact():
    rng = np.random.default_rng(3)
    x = np.concatenate([
        np.array([1, 2, 3, 4, 255, 256, 65535, 65536, (1 << 24) - 1, 1 << 24,
                  1 << 30, I32_MAX], np.int32),
        (1 << rng.integers(0, 31, 2048)).astype(np.int32),
        rng.integers(1, I32_MAX, 4096).astype(np.int32)])
    want = jfxp.ilog2(jnp.asarray(x))
    got = tfxp.ilog2(_t(x))
    assert _eq(got, want)
    assert np.array_equal(got.numpy(), np.floor(np.log2(x.astype(np.float64))))


@pytest.mark.parametrize("range_reduce", [True, False])
def test_reciprocal_q24_bit_exact(range_reduce):
    rng = np.random.default_rng(4)
    s = np.concatenate([
        np.array([1, 2, 100, (1 << 19) - 1, 1 << 19, (1 << 24) - 1, 1 << 24,
                  (1 << 24) + 1, 10 << 24, 27 << 24, 1 << 30, I32_MAX],
                 np.int32),
        rng.integers(1, I32_MAX, 4096).astype(np.int32),
        rng.integers(1 << 24, 64 << 24, 4096).astype(np.int32)])
    want = jlut.reciprocal_q24(jnp.asarray(s), jlut.make_lut_bank(),
                               range_reduce=range_reduce)
    assert _eq(tlut.reciprocal_q24(_t(s), range_reduce=range_reduce), want)
    assert _eq(tlut.reciprocal_q24(_t(s), tlut.make_lut_bank(),
                                   range_reduce=range_reduce), want)


def test_lut_index_functions_bit_exact():
    rng = np.random.default_rng(5)
    zq = np.concatenate([rng.integers(0, 12 << 24, 4096),
                         [0, 1, (1 << 19) - 1, 1 << 19, 10 << 24]]).astype(np.int32)
    assert _eq(tlut.exp_index_from_q24(_t(zq)),
               jlut.exp_index_from_q24(jnp.asarray(zq)))
    assert _eq(tlut.inv_index_from_q24(_t(zq)),
               jlut.inv_index_from_q24(jnp.asarray(zq)))
    x = np.concatenate([rng.normal(0, 2, 4096), [-1.857, 1.595, 0.0, -5, 5],
                        np.linspace(-2, 2, 1001)]).astype(np.float32)
    assert _eq(tlut.gelu_index_from_f32(_t(x)),
               jlut.gelu_index_from_f32(jnp.asarray(x)))


# ---------------------------------------------------------------------------
# nibble codec (the round-trip and saturation cases of tests/test_core.py)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("bits", [1, 2, 3, 4])
@pytest.mark.parametrize("n", [0, 1, 2, 7, 8, 33, 256])
def test_pack_po2_roundtrip_and_bytes_equal(bits, n):
    rng = np.random.default_rng(100 * bits + n)
    lo, hi = -(2 ** (bits - 1)), 2 ** (bits - 1) - 1
    v = rng.integers(lo, hi + 1, n).astype(np.int8)
    if n >= 2:
        v[0], v[-1] = lo, hi
    want = jquant.pack_po2(jnp.asarray(v), bits)
    got = tquant.pack_po2(_t(v), bits)
    assert _eq(got, want)
    assert got.numel() == tquant.packed_length(n, bits) == (n + 1) // 2
    back = tquant.unpack_po2(got, bits, (n,))
    assert back.dtype == torch.int8 and np.array_equal(back.numpy(), v)
    assert _eq(back, jquant.unpack_po2(want, bits, (n,)))


def test_pack_payload_identity_above_4_bits_and_2d_shapes():
    rng = np.random.default_rng(6)
    v = rng.integers(-8, 8, (5, 7)).astype(np.int8)
    p4 = tquant.pack_payload(_t(v), 4)
    assert _eq(p4, jquant.pack_payload(jnp.asarray(v), 4))
    assert np.array_equal(tquant.unpack_payload(p4, 4, (5, 7)).numpy(), v)
    v8 = rng.integers(-128, 128, (5, 7)).astype(np.int8)
    p8 = tquant.pack_payload(_t(v8), 8)
    assert p8.dtype == torch.int8 and np.array_equal(p8.numpy(), v8)
    assert np.array_equal(tquant.unpack_payload(p8, 8, (5, 7)).numpy(), v8)


# ---------------------------------------------------------------------------
# eq-9 quantisers
# ---------------------------------------------------------------------------

def _assert_qtensor_equal(got, want):
    assert _eq(got.values, want.values)
    assert got.exponent == want.exponent and got.bits == want.bits
    assert got.logical_shape == want.logical_shape
    assert got.stored_bytes == want.stored_bytes
    assert tuple(got.shape) == tuple(want.shape)
    if want.axis_exponents is None:
        assert got.axis_exponents is None
    else:
        assert _eq(got.axis_exponents, want.axis_exponents)
    assert _eq(got.int_values(), want.int_values())
    assert _eq(got.dequantize(), want.dequantize())


@pytest.mark.parametrize("bits", [8, 4, 12])
@pytest.mark.parametrize("rounding", ["floor", "nearest"])
def test_quantize_po2_bit_exact(bits, rounding):
    rng = np.random.default_rng(7)
    w = rng.normal(0, 0.7, (33, 17)).astype(np.float32)
    w[0, :4] = [100.0, -100.0, 0.5 / 64, -0.5 / 64]     # saturation + ties
    exp = {8: 6, 4: 2, 12: 9}[bits]
    want = jquant.quantize_po2(jnp.asarray(w), exp, bits=bits, rounding=rounding)
    got = tquant.quantize_po2(_t(w), exp, bits=bits, rounding=rounding)
    _assert_qtensor_equal(got, want)
    assert tquant.choose_exponent(_t(w), bits=bits) == \
        jquant.choose_exponent(jnp.asarray(w), bits=bits)


@pytest.mark.parametrize("exp,bits", [(5, 8), (3, 8), (5, 4), (7, 8)])
def test_quantize_act_bit_exact(exp, bits):
    rng = np.random.default_rng(8)
    x = np.concatenate([rng.normal(0, 2, 4096),
                        [1e6, -1e6, 0.5 / 32, -0.5 / 32, 1.5 / 32, 127 / 32,
                         127.5 / 32, -128 / 32, -128.5 / 32]]).astype(np.float32)
    want = jquant.quantize_act(jnp.asarray(x), exp, bits=bits)
    assert _eq(tquant.quantize_act(_t(x), exp, bits=bits), want)


def test_requant_bit_exact():
    rng = np.random.default_rng(9)
    acc_i = rng.integers(-(1 << 20), 1 << 20, (9, 16)).astype(np.int32)
    axis = rng.integers(-3, 4, 16).astype(np.int8)
    for acc in (acc_i, acc_i.astype(np.float32)):
        for ax in (None, axis):
            want = jquant.requant(jnp.asarray(acc), 5, 6,
                                  None if ax is None else jnp.asarray(ax))
            got = tquant.requant(_t(acc), 5, 6, None if ax is None else _t(ax))
            assert _eq(got, want)


def _weight(rng, k, n, bits, per_channel):
    lo, hi = -(2 ** (bits - 1)), 2 ** (bits - 1) - 1
    grid = rng.integers(lo, hi + 1, (k, n)).astype(np.int8)
    axis = rng.integers(-2, 3, n).astype(np.int8) if per_channel else None
    jw = jquant.QTensor.store(jnp.asarray(grid), 6, bits=bits,
                              axis_exponents=None if axis is None
                              else jnp.asarray(axis))
    tw = tquant.QTensor.store(_t(grid), 6, bits=bits,
                              axis_exponents=None if axis is None else _t(axis))
    return jw, tw


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("per_channel", [False, True])
@pytest.mark.parametrize("residual_bits", [16, 32])
def test_int_exec_einsum_bit_exact(bits, per_channel, residual_bits):
    rng = np.random.default_rng(10 + bits)
    jw, tw = _weight(rng, 24, 12, bits, per_channel)
    _assert_qtensor_equal(tw, jw)
    # activations large enough that the INT16 clip is hit on purpose at int8
    x = rng.normal(0, 3.0, (2, 27, 24)).astype(np.float32)
    want = jquant.int_exec_einsum("bsd,df->bsf", jnp.asarray(x), jw, x_exp=5,
                                  residual_bits=residual_bits)
    got = tquant.int_exec_einsum("bsd,df->bsf", _t(x), tw, x_exp=5,
                                 residual_bits=residual_bits)
    assert _eq(got, want)
    if bits == 8 and residual_bits == 16:
        raw = np.abs(np.asarray(want) * 2.0 ** 11)
        if per_channel:
            raw = raw * np.exp2(np.asarray(jw.axis_exponents, np.float32))
        assert raw.max() == 32768.0 or raw.max() == 32767.0, \
            "the test data no longer reaches the INT16 clip"


def test_int_exec_einsum_int32_branch_and_head_layout():
    """K long enough that the f32 container is not exact (the int32
    branch), and the rank-2 head equation ``bd,dc->bc``."""
    rng = np.random.default_rng(11)
    jw, tw = _weight(rng, 2048, 5, 8, False)
    x = rng.normal(0, 1.0, (3, 2048)).astype(np.float32)
    for rb in (16, 32):
        want = jquant.int_exec_einsum("bd,dc->bc", jnp.asarray(x), jw, x_exp=5,
                                      residual_bits=rb)
        got = tquant.int_exec_einsum("bd,dc->bc", _t(x), tw, x_exp=5,
                                     residual_bits=rb)
        assert _eq(got, want)


@pytest.mark.parametrize("bits,per_channel", [(8, False), (8, True), (4, True)])
def test_int_exec_qkv_equals_three_einsums_and_reference(bits, per_channel):
    rng = np.random.default_rng(12)
    pairs = [_weight(rng, 12, n, bits, per_channel) for n in (8, 8, 8)]
    # different scalar exponents exercise the per-column delta
    pairs[1][0].exponent = pairs[1][1].exponent = 5
    jws = tuple(p[0] for p in pairs)
    tws = tuple(p[1] for p in pairs)
    x = rng.normal(0, 1.5, (4, 27, 12)).astype(np.float32)
    want = jquant.int_exec_qkv(jnp.asarray(x), jws, x_exp=5)
    got = tquant.int_exec_qkv(_t(x), tws, x_exp=5)
    for g, w_, tw in zip(got, want, tws):
        assert _eq(g, w_)
        sep = tquant.int_exec_einsum("bsd,df->bsf", _t(x), tw, x_exp=5)
        assert torch.equal(g, sep)


def test_int_exec_supported_matrix():
    rng = np.random.default_rng(13)
    jw, tw = _weight(rng, 12, 8, 8, False)
    jc, tc = _weight(rng, 12, 8, 8, True)
    for eq in ("bsd,df->bsf", "bd,dc->bc", "bsd,vd->bsv", "bsd,dfe->bsfe"):
        assert tquant.int_exec_supported(tw, eq) == jquant.int_exec_supported(jw, eq)
        assert tquant.int_exec_supported(tc, eq) == jquant.int_exec_supported(jc, eq)
    assert not tquant.int_exec_supported(_t(np.zeros((12, 8), np.float32)),
                                         "bsd,df->bsf")


def test_qmatmul_and_qt_einsum_bit_exact():
    rng = np.random.default_rng(14)
    xi = rng.integers(-128, 128, (9, 40)).astype(np.int8)
    wi = rng.integers(-128, 128, (40, 6)).astype(np.int8)
    for rb, oe in ((16, 7), (32, None), (16, 12)):
        want = jquant.qmatmul(jquant.QTensor(jnp.asarray(xi), 5),
                              jquant.QTensor(jnp.asarray(wi), 6),
                              out_exponent=oe, residual_bits=rb)
        got = tquant.qmatmul(tquant.QTensor(_t(xi), 5), tquant.QTensor(_t(wi), 6),
                             out_exponent=oe, residual_bits=rb)
        assert _eq(got.values, want.values) and got.exponent == want.exponent
    # the CPU trouble spot: a narrow integer product wraps at int8
    assert int(tquant.exact_int_matmul(_t(xi), _t(wi)).abs().max()) > 127
    jw, tw = _weight(rng, 40, 6, 4, True)
    x = rng.normal(0, 1, (2, 5, 40)).astype(np.float32)
    want = jquant.qt_einsum("bsd,df->bsf", jnp.asarray(x), jw)
    got = tquant.qt_einsum("bsd,df->bsf", _t(x), tw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    assert _eq(tquant.resident_values(tw), jw.dequantize())
    assert _eq(tquant.int_container(tw), jquant.int_container(jw))


def test_quantize_tree_and_bytes_equal():
    rng = np.random.default_rng(15)
    tree = {"w": rng.normal(0, 0.3, (16, 12)).astype(np.float32),
            "b": rng.normal(0, 0.3, (12,)).astype(np.float32),
            "blocks": [{"w1": rng.normal(0, 0.3, (12, 24)).astype(np.float32)}]}
    import jax
    jt = jax.tree.map(jnp.asarray, tree)
    tt = {"w": _t(tree["w"]), "b": _t(tree["b"]),
          "blocks": [{"w1": _t(tree["blocks"][0]["w1"])}]}
    for bits in (8, 4):
        jq = jquant.quantize_tree(jt, weight_exponent=6 if bits == 8 else 2,
                                  bits=bits)
        tq = tquant.quantize_tree(tt, weight_exponent=6 if bits == 8 else 2,
                                  bits=bits)
        assert tquant.tree_quantized_bytes(tq) == jquant.tree_quantized_bytes(jq)
        _assert_qtensor_equal(tq["w"], jq["w"])
        _assert_qtensor_equal(tq["blocks"][0]["w1"], jq["blocks"][0]["w1"])
        assert isinstance(tq["b"], torch.Tensor)
        td, jd = tquant.dequantize_tree(tq), jquant.dequantize_tree(jq)
        assert _eq(td["w"], jd["w"]) and _eq(td["b"], jd["b"])
