"""The int8 matmul's input modes against the reference, on the CPU.

On the card the kernel takes its operands as they are stored: the float
activation, which it quantises by eq 9 as it loads it, the nibble-packed
int4 payload, which it unpacks as it stages it, and the int8 per-column
exponents, applied in the epilogue as a power of two built from its bits.
Here the wrapper takes its plain version (``ref.int8_matmul_io``) and the
kernel's own index and bit arithmetic is written out in torch
(``kernels.int8_matmul.pow2_neg``, ``nibble_grid``); ``chip_smoke.py``
holds the kernel to the same plain version on the card.

Every comparison is bit-exact: the quantiser's two float32 roundings
(``x * 2^e``, then ``+ 0.5``), the integer product, the INT16 clip and the
power-of-two requant leave nothing to tolerate.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import quant as jquant
from repro_torch.core import quant as tquant
from repro_torch.kernels import int8_matmul as tmm
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref

torch.set_num_threads(1)

X_EXP = 5


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _activations(shape, bits, seed):
    """Normal activations, with the first row set to the quantiser's
    edges: exact .5 ties (``x * 2^5 + 0.5`` an integer), values just
    inside and beyond the clip edges, and far beyond them."""
    rng = np.random.default_rng(seed)
    x = rng.normal(0, 2.0, shape).astype(np.float32)
    lo, hi = tquant.int_range(bits)
    s = 2.0 ** X_EXP
    edges = [0.5 / s, -0.5 / s, 1.5 / s, -1.5 / s, 2.5 / s, -2.5 / s,
             (hi + 0.5) / s, (lo - 0.5) / s, (hi - 0.5) / s, (lo + 0.5) / s,
             (hi + 1) / s, (lo - 1) / s, 1e6, -1e6, 0.0, -0.0]
    flat = x.reshape(-1)
    flat[:min(len(edges), flat.size)] = np.asarray(
        edges[:flat.size], np.float32)
    return x


def _weights(k, n, bits, per_channel, seed):
    rng = np.random.default_rng(seed + 1)
    lo, hi = tquant.int_range(bits)
    grid = rng.integers(lo, hi + 1, (k, n)).astype(np.int8)
    axis = rng.integers(-3, 4, n).astype(np.int8) if per_channel else None
    jw = jquant.QTensor.store(jnp.asarray(grid), 6, bits=bits,
                              axis_exponents=None if axis is None
                              else jnp.asarray(axis))
    tw = tquant.QTensor.store(_t(grid), 6, bits=bits,
                              axis_exponents=None if axis is None
                              else _t(axis))
    return grid, axis, jw, tw


SHAPES = [(2, 27, 12, 24), (1, 99, 64, 256), (3, 5, 17, 7), (1, 1, 1, 1)]


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("per_channel", [False, True])
@pytest.mark.parametrize("residual_bits", [16, 32])
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_float_input_path_equals_reference_int_exec_einsum(
        shape, residual_bits, per_channel, bits):
    """``int_exec_einsum(use_kernel=True)`` hands the float activation and
    the stored payload to the matmul wrapper as they are; the answer is
    the reference's ``int_exec_einsum`` to the bit, ties and clip edges
    included, for int8 and nibble-packed int4 weights."""
    b, s, k, n = shape
    x = _activations((b, s, k), 8, seed=k * n + bits)
    _, _, jw, tw = _weights(k, n, bits, per_channel, seed=k + n)
    assert tw.packed == (bits <= 4)
    want = np.asarray(jquant.int_exec_einsum(
        "bsd,df->bsf", jnp.asarray(x), jw, x_exp=X_EXP,
        residual_bits=residual_bits))
    got = tquant.int_exec_einsum("bsd,df->bsf", _t(x), tw, x_exp=X_EXP,
                                 residual_bits=residual_bits, use_kernel=True)
    assert got.shape == want.shape and got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("x_bits", [8, 6, 4])
@pytest.mark.parametrize("bits", [8, 4])
def test_fused_quantiser_equals_reference_quantize_act(bits, x_bits):
    """The wrapper's float mode quantises as the reference's
    ``quantize_act`` does, at every activation width up to 8 bits: its
    answer is the int8 wrapper's on the reference's grid, to the bit."""
    x = _activations((4, 33, 40), x_bits, seed=x_bits)
    _, axis, _, tw = _weights(40, 24, bits, True, seed=bits)
    xq = np.asarray(jquant.quantize_act(jnp.asarray(x), X_EXP, bits=x_bits))
    assert np.array_equal(xq, np.round(xq))
    assert xq.min() >= tquant.int_range(x_bits)[0]
    want = tops.int8_matmul(_t(xq.astype(np.int8)), tw, x_exp=X_EXP,
                            residual_bits=16)
    got = tops.int8_matmul(_t(x), tw, x_exp=X_EXP, x_bits=x_bits,
                           residual_bits=16)
    assert got.shape == (4, 33, 24)
    assert torch.equal(got, want)
    ref_grid = tquant.quantize_act(_t(x), X_EXP, bits=x_bits)
    np.testing.assert_array_equal(ref_grid.numpy(), xq)


def test_float_mode_refuses_what_the_int8_container_cannot_hold():
    x = torch.zeros((3, 8))
    w = torch.zeros((8, 2), dtype=torch.int8)
    with pytest.raises(ValueError, match="at most 8 bits"):
        tmm.int8_matmul_scaled(x, w, shift=0, clip16=True, out_exp=11,
                               x_exp=5, x_bits=9)
    with pytest.raises(ValueError, match="x_exp"):
        tmm.int8_matmul_scaled(x, w, shift=0, clip16=True, out_exp=11)


INT16_EDGES = [-32768, -32767, -1, 0, 1, 32766, 32767]


@pytest.mark.parametrize("a", range(-8, 9))
def test_epilogue_power_of_two_equals_exp2(a):
    """The epilogue scales by ``2^-a`` built from the float32 bits; on
    accumulators at the INT16 edges, after the ``2^-out_exp`` multiply,
    it is ``* torch.exp2(-a)`` to the bit."""
    acc = torch.tensor(INT16_EDGES, dtype=torch.float32)
    for out_exp in (0, 11, 14):
        f = acc * (2.0 ** -out_exp)
        a_t = torch.full((len(INT16_EDGES),), a, dtype=torch.int8)
        got = f * tmm.pow2_neg(a_t)
        want = f * torch.exp2(-a_t.to(torch.float32))
        assert torch.equal(got, want), (a, out_exp)


def test_epilogue_power_of_two_over_every_int8_exponent():
    """``pow2_neg`` is ``exp2(-a)`` for every int8 ``a``: the one
    subnormal (a = 127) and inf (a = -128) included."""
    a = torch.arange(-128, 128, dtype=torch.int32).to(torch.int8)
    got = tmm.pow2_neg(a)
    want = torch.exp2(-a.to(torch.float32))
    assert torch.equal(got, want)
    assert got[-1].item() == 2.0 ** -127 and got[0].item() == float("inf")


@pytest.mark.parametrize("k, n", [(1, 1), (3, 5), (7, 3), (12, 24),
                                  (40, 64), (17, 35), (64, 256), (255, 3)])
def test_nibble_addressing_equals_unpack_po2(k, n):
    """The kernel's int4 staging (flat index ``kk * N + nn``, byte
    ``f >> 1``, low nibble first, ``(v ^ 8) - 8``, written N-major) is the
    transpose of ``unpack_po2``, odd K * N (a padded last nibble)
    included."""
    rng = np.random.default_rng(k * 1000 + n)
    grid = _t(rng.integers(-8, 8, (k, n)).astype(np.int8))
    payload = tquant.pack_po2(grid, 4)
    assert payload.numel() == (k * n + 1) // 2
    staged = tmm.nibble_grid(payload, k, n)
    assert staged.shape == (n, k)
    assert torch.equal(staged.T, tquant.unpack_po2(payload, 4, (k, n)))
    assert torch.equal(staged.T, grid)


@pytest.mark.parametrize("per_channel", [False, True])
def test_int4_payload_goes_to_the_wrapper_packed(per_channel, monkeypatch):
    """No unpack before the call: the wrapper hands the kernel's plain
    version the packed payload and its logical shape, and
    ``QTensor.int_values`` is never called for the weight."""
    _, axis, _, tw = _weights(24, 12, 4, per_channel, seed=3)
    seen = {}
    real = tref.int8_matmul_io

    def spy(x, w, **kw):
        seen.update(dtype=w.dtype, numel=w.numel(), w_shape=kw["w_shape"])
        return real(x, w, **kw)

    def refuse(self):
        raise AssertionError("int_values called on the weight")

    monkeypatch.setattr(tref, "int8_matmul_io", spy)
    x = _t(_activations((2, 27, 24), 8, seed=5))
    want = tquant.int_exec_einsum("bsd,df->bsf", x, tw, x_exp=X_EXP)
    monkeypatch.setattr(tquant.QTensor, "int_values", refuse)
    got = tops.int8_matmul(x, tw, x_exp=X_EXP, residual_bits=16)
    assert seen == {"dtype": torch.uint8, "numel": 24 * 12 // 2,
                    "w_shape": (24, 12)}
    assert torch.equal(got, want)


class _CountOps(torch.utils._python_dispatch.TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops.append(str(func))
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("bits, per_channel", [(8, False), (8, True),
                                               (4, True)])
def test_cuda_plan_linear_dispatches_only_its_output(bits, per_channel,
                                                     monkeypatch):
    """The ``cuda`` plan's integer linear, with the launch stubbed out (the
    wrapper's Python runs as it does for a CUDA tensor): the only ATen op
    it dispatches is the output's allocation — no quantiser, no int8 cast,
    no nibble unpack, no ``exp2`` of the column exponents, no reshape."""
    from repro_torch.kernels import _launch

    class _State:
        index = 0
        lib = type("Lib", (), {"int8_matmul_launch": staticmethod(
            lambda *a: 0)})()

    calls = []
    monkeypatch.setattr(_launch, "on_cuda", lambda x, what: True)
    monkeypatch.setattr(_launch, "state", lambda index: _State)
    monkeypatch.setattr(_launch, "launch",
                        lambda st, entry, what, *args: calls.append(args))
    _, _, _, tw = _weights(64, 256, bits, per_channel, seed=bits)
    x = torch.randn(2, 99, 64)
    tops.reset_launch_counts()
    with _CountOps() as counter:
        out = tquant.int_exec_einsum("bsd,df->bsf", x, tw, x_exp=X_EXP,
                                     use_kernel=True)
    assert counter.ops == ["aten.empty.memory_format"]
    assert out.shape == (2, 99, 256) and out.dtype == torch.float32
    assert tops.launch_counts()["int8_matmul"] == 1
    (args,) = calls
    assert args[0] == x.data_ptr()                 # the float activation
    assert args[1] == tw.values.data_ptr()         # the stored payload
    assert args[4:7] == (2 * 99, 64, 256)          # m, k, n
    mode = args[8]
    assert mode >> 3 & 1 == 1 and mode >> 8 == 8   # float input, 8 bits
    assert mode >> 4 & 1 == (bits <= 4)            # nibble-packed weight
    assert mode & 1 == 1 and mode >> 1 & 3 == 0    # INT16 clip, float out
    assert args[9:] == (X_EXP + tw.exponent, X_EXP)   # out_exp, x_exp
