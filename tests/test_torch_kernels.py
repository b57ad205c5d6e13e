"""The plain versions of the CUDA kernels against the reference, on the CPU.

The JAX side runs as its own tests run it here: the Pallas kernels in
``interpret=True`` through ``repro.kernels.ops``, or the pure-jnp oracles
``repro.core.approx`` / ``repro.kernels.ref``.  The port side runs the
wrappers of ``repro_torch.kernels.ops`` on CPU tensors, which take the
plain versions — the functions the CUDA kernels are held against on the
card by ``chip_smoke.py``.

Tolerances: the Q8.24 softmax, the float32 GELU and the integer matmul
are bit-exact.  The float-carry softmax differs from the reference in the
last place (the port sums the row in float64 and divides, the oracle
multiplies by a float32 reciprocal of a float32 sum, whose own rounding
error grows with the row length): atol 1e-6 plus rtol 2e-6 — measured
worst case 1.01e-6 on an output of 0.955 at N = 1000.  The interpolating
GELU equals the jnp oracle to the bit; the reference's Pallas kernel in
interpret mode is jitted, XLA contracts its blend into a fused
multiply-add, and it sits one float32 unit away from its own oracle:
atol 1e-6 there, as in the reference's own kernel test.  bf16 GELU
outputs may differ by one bf16 unit for the same reason.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import approx as japprox
from repro.core import quant as jquant
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.core import approx as tapprox
from repro_torch.core import quant as tquant
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref

torch.set_num_threads(1)

def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _rows(n, m=64, seed=0, scale=4.0):
    rng = np.random.default_rng(seed + n)
    x = (rng.normal(0, scale, (m, n))).astype(np.float32)
    x[0] = 0.0                                  # flat row: largest row sum
    if n > 1:
        x[1, 0] = 50.0                          # one dominant lane
        x[2] = np.float32(np.finfo(np.float32).min)   # a fully "masked" row
        x[2, -1] = 0.0
    return x


# ---------------------------------------------------------------------------
# lut_softmax
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", [1, 27, 64, 99, 128, 1000])
def test_lut_softmax_fixed_bit_exact_vs_oracle(n):
    x = _rows(n)
    want = np.asarray(japprox.softmax_lut(jnp.asarray(x), fixed=True))
    got = tops.lut_softmax(_t(x), fixed=True)
    assert got.dtype == torch.float32
    assert np.array_equal(got.numpy(), want)
    assert np.array_equal(tref.lut_softmax(_t(x), fixed=True).numpy(), want)
    assert np.array_equal(
        tapprox.softmax(_t(x), mode="lut_fixed").numpy(), want)
    assert np.array_equal(tapprox.softmax(_t(x), mode="cuda").numpy(), want)
    assert np.array_equal(
        tapprox.masked_softmax(_t(x), None, mode="lut_fixed").numpy(), want)


@pytest.mark.parametrize("n", [1, 27, 64])
def test_lut_softmax_fixed_bit_exact_vs_pallas_kernel_up_to_64(n):
    """At pre == 0 (N <= 64) the reference's Pallas kernel and its oracle
    agree, and so must the port; beyond that the kernel truncates the
    pre-shift where the oracle — which the port follows — rounds."""
    x = _rows(n, m=16)
    want = np.asarray(jops.lut_softmax(jnp.asarray(x), fixed=True,
                                       interpret=True))
    assert np.array_equal(tops.lut_softmax(_t(x), fixed=True).numpy(), want)


def test_lut_softmax_fixed_paper_range_reduce_off_and_leading_dims():
    x = _rows(27, m=24).reshape(2, 3, 4, 27)
    want = np.asarray(japprox.softmax_lut(jnp.asarray(x), fixed=True,
                                          range_reduce=False))
    got = tapprox.softmax_lut(_t(x), fixed=True, range_reduce=False)
    assert np.array_equal(got.numpy(), want)
    want = np.asarray(japprox.softmax_lut(jnp.asarray(x), fixed=True))
    assert np.array_equal(tops.lut_softmax(_t(x)).numpy(), want)


@pytest.mark.parametrize("n", [1, 27, 99, 320, 1000])
def test_lut_softmax_float_close(n):
    x = _rows(n, m=32)
    got = tops.lut_softmax(_t(x), fixed=False).numpy()
    for want in (japprox.softmax_lut(jnp.asarray(x), fixed=False),
                 jops.lut_softmax(jnp.asarray(x), fixed=False, interpret=True)):
        np.testing.assert_allclose(got, np.asarray(want), rtol=2e-6, atol=1e-6)
    np.testing.assert_allclose(
        tapprox.softmax_lut(_t(x), fixed=False).numpy(),
        np.asarray(japprox.softmax_lut(jnp.asarray(x), fixed=False)),
        rtol=2e-6, atol=1e-6)
    np.testing.assert_allclose(got.sum(-1), 1.0, atol=1e-5)


@pytest.mark.parametrize("mode", ["exact", "lut", "lut_fixed"])
def test_masked_softmax_causal(mode):
    rng = np.random.default_rng(3)
    s = rng.normal(0, 2, (2, 1, 1, 9, 9)).astype(np.float32)
    mask = np.tril(np.ones((9, 9), bool))[None, None, None]
    want = np.asarray(japprox.masked_softmax(jnp.asarray(s), jnp.asarray(mask),
                                             mode=mode))
    got = tapprox.masked_softmax(_t(s), _t(mask), mode=mode).numpy()
    if mode == "lut_fixed":
        assert np.array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    assert np.all(got[..., ~mask[0, 0, 0]] == 0.0)


def test_masked_softmax_kernel_mode_matches_reference_kernel_mode():
    rng = np.random.default_rng(4)
    s = rng.normal(0, 2, (3, 1, 1, 9, 9)).astype(np.float32)
    mask = np.tril(np.ones((9, 9), bool))[None, None, None]
    want = np.asarray(japprox.masked_softmax(
        jnp.asarray(s), jnp.asarray(mask), mode="pallas", interpret=True))
    got = tapprox.masked_softmax(_t(s), _t(mask), mode="cuda").numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


# ---------------------------------------------------------------------------
# lut_gelu
# ---------------------------------------------------------------------------

def _gelu_input(shape, seed=0):
    rng = np.random.default_rng(seed)
    x = (rng.normal(0, 3, shape)).astype(np.float32)
    flat = x.reshape(-1)
    edges = np.array([-1.857, 1.595, -1.8570001, 1.5950001, 0.0, -10.0, 10.0],
                     np.float32)
    flat[:min(edges.size, flat.size)] = edges[:flat.size]
    return x


@pytest.mark.parametrize("shape", [(8, 32), (37, 300), (5, 27), (1, 512),
                                   (2, 27, 24)])
@pytest.mark.parametrize("interp", [False, True])
def test_lut_gelu_f32_bit_exact(shape, interp):
    x = _gelu_input(shape)
    want = np.asarray(japprox.gelu_lut(jnp.asarray(x), interp=interp))
    got = tops.lut_gelu(_t(x), interp=interp)
    assert got.dtype == torch.float32 and tuple(got.shape) == shape
    assert np.array_equal(got.numpy(), want)
    if len(shape) == 2:
        kern = np.asarray(jops.lut_gelu(jnp.asarray(x), interp=interp,
                                        interpret=True))
        if interp:
            np.testing.assert_allclose(got.numpy(), kern, rtol=0, atol=1e-6)
        else:
            assert np.array_equal(got.numpy(), kern)
    mode = "lut_interp" if interp else "lut"
    assert np.array_equal(tapprox.gelu(_t(x), mode=mode).numpy(), want)
    if not interp:
        assert np.array_equal(tapprox.gelu(_t(x), mode="cuda").numpy(), want)
        assert np.array_equal(
            tapprox.activation("gelu", "cuda")(_t(x)).numpy(), want)


def test_lut_gelu_dense_sweep_bit_exact_and_exact_gelu_close():
    x = np.linspace(-3, 3, 200001).astype(np.float32)
    for interp in (False, True):
        want = np.asarray(japprox.gelu_lut(jnp.asarray(x), interp=interp))
        assert np.array_equal(tops.lut_gelu(_t(x), interp=interp).numpy(), want)
    np.testing.assert_allclose(
        tapprox.gelu(_t(x), mode="exact").numpy(),
        np.asarray(japprox.gelu_exact(jnp.asarray(x))), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("interp", [False, True])
def test_lut_gelu_bf16_within_one_ulp(interp):
    x32 = _gelu_input((37, 300), seed=1)
    xb = _t(x32).to(torch.bfloat16)
    got = tops.lut_gelu(xb, interp=interp)
    assert got.dtype == torch.bfloat16
    got32 = got.to(torch.float32).numpy()
    assert np.all(np.isfinite(got32))
    xj = jnp.asarray(xb.to(torch.float32).numpy()).astype(jnp.bfloat16)
    want = np.asarray(jops.lut_gelu(xj, interp=interp, interpret=True)
                      .astype(jnp.float32))
    # one bf16 unit in the last place: 2^-8 relative
    assert np.all(np.abs(got32 - want) <= np.abs(want) * 2.0 ** -7 + 1e-30)


# ---------------------------------------------------------------------------
# int8_matmul
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mnk", [(8, 16, 32), (50, 70, 200), (128, 128, 128),
                                 (1, 5, 7)])
@pytest.mark.parametrize("residual_bits", [16, 32])
def test_int8_matmul_sweep_bit_exact(mnk, residual_bits):
    m, n, k = mnk
    rng = np.random.default_rng(m + n + k)
    x = rng.integers(-16, 16, (m, k)).astype(np.int8)
    w = rng.integers(-16, 16, (k, n)).astype(np.int8)
    want = np.asarray(jops.int8_matmul(jnp.asarray(x), jnp.asarray(w), x_exp=5,
                                       w_exp=6, out_exp=7,
                                       residual_bits=residual_bits,
                                       interpret=True))
    got = tops.int8_matmul(_t(x), _t(w), x_exp=5, w_exp=6, out_exp=7,
                           residual_bits=residual_bits)
    assert np.array_equal(got.numpy(), want)
    oracle = tref.int8_matmul(_t(x), _t(w), x_exp=5, w_exp=6, out_exp=7,
                              residual_bits=residual_bits)
    assert np.array_equal(oracle.numpy(), np.asarray(jref.int8_matmul(
        jnp.asarray(x), jnp.asarray(w), x_exp=5, w_exp=6, out_exp=7,
        residual_bits=residual_bits)))
    assert np.array_equal(got.numpy(), oracle.numpy())


@pytest.mark.parametrize("shift,out_int16", [(0, False), (4, False), (4, True),
                                             (-3, False), (-9, True)])
def test_int8_matmul_raw_full_range_bit_exact(shift, out_int16):
    from repro.kernels import int8_matmul as jmm
    rng = np.random.default_rng(17)
    x = rng.integers(-128, 128, (16, 256)).astype(np.int8)
    w = rng.integers(-128, 128, (256, 128)).astype(np.int8)
    want = np.asarray(jmm.int8_matmul_raw(jnp.asarray(x), jnp.asarray(w),
                                          shift=shift, out_int16=out_int16,
                                          block_m=16, interpret=True))
    got = tops.int8_matmul_raw(_t(x), _t(w), shift=shift, out_int16=out_int16)
    assert got.numpy().dtype == want.dtype
    assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("per_channel", [False, True])
@pytest.mark.parametrize("residual_bits", [16, 32])
def test_int8_matmul_qtensor_int4_operands_bit_exact(per_channel, residual_bits):
    rng = np.random.default_rng(18)
    x = rng.integers(-128, 128, (2, 27, 32)).astype(np.int8)   # leading dims
    w4 = rng.integers(-8, 8, (32, 16)).astype(np.int8)
    axis = rng.integers(-2, 3, 16).astype(np.int8) if per_channel else None
    jw = jquant.QTensor.store(jnp.asarray(w4), 6, bits=4,
                              axis_exponents=None if axis is None
                              else jnp.asarray(axis))
    tw = tquant.QTensor.store(_t(w4), 6, bits=4,
                              axis_exponents=None if axis is None else _t(axis))
    assert tw.packed and tw.values.dtype == torch.uint8
    want = np.asarray(jops.int8_matmul(
        jquant.QTensor(jnp.asarray(x.reshape(-1, 32)), 5), jw,
        residual_bits=residual_bits, interpret=True)).reshape(2, 27, 16)
    got = tops.int8_matmul(tquant.QTensor(_t(x), 5), tw,
                           residual_bits=residual_bits)
    assert np.array_equal(got.numpy(), want)


def test_int8_matmul_wrapper_matches_int_exec_einsum():
    """The kernel wrapper and the plain integer-executing einsum are the
    same math (what makes the ``cuda`` plan reproduce the ``lut`` plan)."""
    rng = np.random.default_rng(19)
    x = rng.normal(0, 3, (4, 27, 24)).astype(np.float32)
    grid = rng.integers(-128, 128, (24, 12)).astype(np.int8)
    for axis in (None, rng.integers(-2, 3, 12).astype(np.int8)):
        tw = tquant.QTensor.store(_t(grid), 6, axis_exponents=None
                                  if axis is None else _t(axis))
        plain = tquant.int_exec_einsum("bsd,df->bsf", _t(x), tw, x_exp=5)
        kern = tquant.int_exec_einsum("bsd,df->bsf", _t(x), tw, x_exp=5,
                                      use_kernel=True)
        assert torch.equal(plain, kern)


def test_int8_matmul_rejects_per_channel_activation_and_bad_shapes():
    x = tquant.QTensor(torch.zeros((4, 8), dtype=torch.int8), 5,
                       axis_exponents=torch.zeros(8, dtype=torch.int8))
    w = torch.zeros((8, 3), dtype=torch.int8)
    with pytest.raises(NotImplementedError):
        tops.int8_matmul(x, w, w_exp=6)
    with pytest.raises(ValueError):
        tops.int8_matmul_raw(torch.zeros((4, 7), dtype=torch.int8), w)


def test_launch_counters_stay_zero_on_cpu():
    """A wrapper counts a launch where it launches its kernel and nowhere
    else: CPU calls take the plain version and count nothing."""
    tops.reset_launch_counts()
    tops.lut_softmax(torch.zeros(3, 5))
    tops.lut_gelu(torch.zeros(3, 5))
    tops.int8_matmul_raw(torch.zeros((3, 5), dtype=torch.int8),
                         torch.zeros((5, 2), dtype=torch.int8))
    tops.lut_attention(torch.zeros(1, 1, 3, 4), torch.zeros(1, 1, 3, 4),
                       torch.zeros(1, 1, 3, 4))
    assert tops.launch_counts() == {"lut_softmax": 0, "lut_gelu": 0,
                                    "int8_matmul": 0, "lut_attention": 0}
    assert jax.default_backend() == "cpu"
