"""Row softmax via the paper's LUT pipeline: wrapper of the CUDA kernel
``csrc/lut_softmax.cu`` (which replaces the reference's Pallas
``lut_softmax_2d``).  Plain version: :func:`ref.lut_softmax`."""

from __future__ import annotations

import torch

from repro_torch.core import approx, lut as lutlib
from repro_torch.kernels import build, ref
from repro_torch.kernels._launch import require_cuda, stream_of

launches = 0   # kernel launches made by this wrapper (both variants)


def lut_softmax_2d(x: torch.Tensor, *, fixed: bool = True) -> torch.Tensor:
    """LUT softmax along the last axis of a [M, N] tensor -> float32."""
    if x.ndim != 2:
        raise ValueError(f"lut_softmax_2d takes [M, N], got {tuple(x.shape)}")
    if x.device.type == "cpu":
        return ref.lut_softmax(x, fixed=fixed)
    require_cuda(x, "lut_softmax")
    global launches
    x = x.to(torch.float32).contiguous()
    m, n = x.shape
    out = torch.empty_like(x)
    if x.numel() == 0:
        return out
    tabs = lutlib.bank_tensors(x.device)
    lib = build.load()
    with torch.cuda.device(x.device):
        if fixed:
            code = lib.lut_softmax_fixed_launch(
                x.data_ptr(), tabs["exp_q24"].data_ptr(),
                tabs["inv_q24"].data_ptr(), out.data_ptr(), m, n,
                approx.pre_shift_bits(n), stream_of(x))
        else:
            code = lib.lut_softmax_float_launch(
                x.data_ptr(), tabs["exp_f32"].data_ptr(), out.data_ptr(),
                m, n, stream_of(x))
    build.check(code, "lut_softmax")
    launches += 1
    return out
