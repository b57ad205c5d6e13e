"""Row softmax via the paper's LUT pipeline: wrapper of the CUDA kernel
``csrc/lut_softmax.cu`` (which replaces the reference's Pallas
``lut_softmax_2d``).  Plain version: :func:`ref.lut_softmax`.

The kernel has two paths, chosen by its launcher from the row length and
the addresses: a slab path that copies slabs of whole rows into shared
memory with bulk asynchronous copies, and a global path, one warp per
row straight from device memory.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _launch, ref

launches = 0   # kernel launches made by this wrapper (both variants)


def lut_softmax_rows(x: torch.Tensor, *, fixed: bool = True) -> torch.Tensor:
    """LUT softmax along the last axis of a tensor of any rank -> float32:
    its rows are the M = numel / N runs of N = ``x.shape[-1]`` floats of
    the contiguous layout, so nothing is reshaped."""
    if x.ndim == 0:
        raise ValueError("lut_softmax takes a tensor of rank 1 or more")
    if not _launch.on_cuda(x, "lut_softmax"):
        return ref.lut_softmax(x, fixed=fixed)
    global launches
    if x.dtype != torch.float32:
        x = x.to(torch.float32)
    if not x.is_contiguous():
        x = x.contiguous()
    out = torch.empty_like(x)
    numel, n = x.numel(), x.size(-1)
    if numel == 0:
        return out
    st = _launch.state(x.get_device())
    if fixed:
        _launch.launch(st, st.lib.lut_softmax_fixed_launch, "lut_softmax",
                       x.data_ptr(), st.exp_q24, st.inv_q24, out.data_ptr(),
                       numel // n, n)
    else:
        _launch.launch(st, st.lib.lut_softmax_float_launch, "lut_softmax",
                       x.data_ptr(), st.exp_f32, out.data_ptr(), numel // n, n)
    launches += 1
    return out
