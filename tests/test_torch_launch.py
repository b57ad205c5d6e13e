"""The launch path of the port's kernel wrappers, on the CPU.

What a wrapper does in Python before it launches — the output allocated
at the input's offset modulo 16 bytes for the GELU's vectors, the
softmax's rows taken from the contiguous layout of any rank, the
pre-shift of the plain version, no launch state and no count for a CPU
tensor — is checked here.  The choices the CUDA launchers make from the
addresses (the softmax's slab path or global path, the GELU's scalar
head and tail) and the kernels themselves are held to the plain versions
on the card by ``chip_smoke.py``.  The parity of the plain versions with
the reference is in ``test_torch_kernels.py``.
"""

import numpy as np
import pytest
import torch

from repro_torch.core import approx as tapprox
from repro_torch.kernels import _launch, lut_gelu, lut_softmax, ops, ref


def test_pre_shift_bits_integer_form_equals_the_reference_float_form():
    """``(n - 1).bit_length() - 6`` against the reference's
    ``ceil(log2(n)) - 6`` (``repro/core/approx.py``), both at least 0,
    for every n in 1 .. 2^20."""
    n = np.arange(1, 2 ** 20 + 1)
    want = np.maximum(0, np.ceil(np.log2(n)).astype(np.int64) - 6)
    got = np.fromiter((tapprox.pre_shift_bits(int(k)) for k in n),
                      dtype=np.int64, count=n.size)
    np.testing.assert_array_equal(got, want)
    assert tapprox.pre_shift_bits(0) == 0


ROW_SHAPES = [(1,), (99,), (3, 27), (2, 3, 27), (2, 2, 3, 99), (4, 1),
              (5, 129)]


@pytest.mark.parametrize("fixed", [True, False])
@pytest.mark.parametrize("shape", ROW_SHAPES)
def test_softmax_rows_of_any_rank_are_the_rows_of_the_flat_layout(shape, fixed):
    """The wrapper takes a tensor of any rank as it lies, its rows being
    the runs of ``shape[-1]`` floats of the contiguous layout: the same
    answer as the 2-D array of those rows, in the input's shape."""
    g = torch.Generator().manual_seed(len(shape) * 1000 + shape[-1])
    x = torch.randn(shape, generator=g) * 4.0
    got = lut_softmax.lut_softmax_rows(x, fixed=fixed)
    want = ref.lut_softmax(x.reshape(-1, shape[-1]), fixed=fixed)
    assert got.shape == x.shape and got.dtype == torch.float32
    assert torch.equal(got, want.reshape(shape))


def test_softmax_rows_refuse_a_scalar():
    with pytest.raises(ValueError, match="rank 1 or more"):
        lut_softmax.lut_softmax_rows(torch.tensor(1.0))


ALIGN_SHAPES = [(1,), (2,), (3,), (7,), (8,), (9,), (37,), (5, 7), (3, 4, 5)]


@pytest.mark.parametrize("shape", ALIGN_SHAPES)
@pytest.mark.parametrize("dtype, offset",
                         [(torch.float32, o) for o in range(4)]
                         + [(torch.bfloat16, o) for o in range(8)])
def test_output_keeps_the_input_offset_modulo_16_bytes(dtype, offset, shape):
    """The GELU kernel moves input and output in the same vectors, so the
    output is allocated at the input's offset modulo 16 bytes: for every
    offset inside a vector, arrays that end before the next 16-byte
    boundary included."""
    numel = int(np.prod(shape))
    buf = torch.zeros(numel + 16, dtype=dtype)
    assert buf.data_ptr() % 16 == 0
    x = buf[offset:offset + numel].view(shape)
    out = lut_gelu.empty_aligned_like(x)
    assert out.shape == x.shape and out.dtype == x.dtype
    assert out.is_contiguous()
    assert out.data_ptr() % 16 == x.data_ptr() % 16


def _call_every_wrapper(device):
    x = torch.linspace(-3.0, 3.0, 15, device=device).reshape(3, 5)
    ops.lut_softmax(x)
    ops.lut_softmax(x, fixed=False)
    for dtype in (torch.float32, torch.bfloat16):
        for interp in (False, True):
            ops.lut_gelu(x.to(dtype), interp=interp)
    xi = torch.ones((3, 5), dtype=torch.int8, device=device)
    wi = torch.ones((5, 2), dtype=torch.int8, device=device)
    ops.int8_matmul_raw(xi, wi, shift=1)
    ops.int8_matmul(xi, wi, x_exp=5, w_exp=6)
    q = torch.zeros(1, 2, 3, 4, device=device)
    ops.lut_attention(q, q, q)


def test_no_launch_state_and_no_count_for_cpu_tensors(monkeypatch):
    """A CPU tensor takes the plain version: the launch state (library,
    table addresses) is never built for it, and no counter moves."""
    def refuse(index):
        raise AssertionError("launch state built for a CPU tensor")

    monkeypatch.setattr(_launch, "LaunchState", refuse)
    monkeypatch.setattr(_launch, "_STATES", {})
    ops.reset_launch_counts()
    _call_every_wrapper("cpu")
    assert _launch._STATES == {}
    assert ops.launch_counts() == dict.fromkeys(
        ("lut_softmax", "lut_gelu", "int8_matmul", "lut_attention"), 0)


@pytest.mark.parametrize("wrapper", ["lut_softmax", "lut_gelu", "int8_matmul",
                                     "lut_attention"])
def test_wrappers_refuse_a_device_that_is_neither_cpu_nor_cuda(wrapper):
    x = torch.zeros(3, 4, device="meta")
    call = {"lut_softmax": lambda: ops.lut_softmax(x),
            "lut_gelu": lambda: ops.lut_gelu(x),
            "int8_matmul": lambda: ops.int8_matmul_raw(
                x.to(torch.int8), torch.zeros(4, 2, dtype=torch.int8,
                                              device="meta")),
            "lut_attention": lambda: ops.lut_attention(
                x[None, None], x[None, None], x[None, None])}[wrapper]
    with pytest.raises(RuntimeError, match="no kernel for device meta"):
        call()
