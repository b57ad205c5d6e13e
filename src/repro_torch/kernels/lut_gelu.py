"""Piecewise LUT GELU: wrapper of the CUDA kernel ``csrc/lut_gelu.cu``
(which replaces the reference's Pallas ``lut_gelu_2d``).  Plain version:
:func:`ref.lut_gelu`."""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import lut as lutlib
from repro_torch.kernels import build, ref
from repro_torch.kernels._launch import require_cuda, stream_of

launches = 0   # kernel launches made by this wrapper

# The reference's constants are Python doubles that meet float32 data as
# float32 values; round them once on the host and hand them to the kernel.
_LO = float(np.float32(lutlib.GELU_LO))
_HI = float(np.float32(lutlib.GELU_HI))
_SCALE = float(np.float32(float(lutlib.N_GELU_ENTRIES - 1)
                          / (lutlib.GELU_HI - lutlib.GELU_LO)))


def lut_gelu_flat(x: torch.Tensor, *, interp: bool = False) -> torch.Tensor:
    """LUT GELU over a tensor of any shape (elementwise), float32 or
    bfloat16 in and out."""
    if x.device.type == "cpu":
        return ref.lut_gelu(x, interp=interp)
    require_cuda(x, "lut_gelu")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"lut_gelu kernel takes float32 or bfloat16, got {x.dtype}")
    global launches
    x = x.contiguous()
    out = torch.empty_like(x)
    if x.numel() == 0:
        return out
    tab = lutlib.bank_tensors(x.device)["gelu_f32"]
    lib = build.load()
    with torch.cuda.device(x.device):
        code = lib.lut_gelu_launch(
            x.data_ptr(), tab.data_ptr(), out.data_ptr(), x.numel(),
            int(interp), int(x.dtype == torch.bfloat16), _LO, _HI, _SCALE,
            stream_of(x))
    build.check(code, "lut_gelu")
    launches += 1
    return out
