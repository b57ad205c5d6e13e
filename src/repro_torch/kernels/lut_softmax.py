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

# the launcher's constants (csrc/lut_softmax.cu)
_WARPS, _MAX_BLOCKS = 8, 4096
_SLAB_WARPS, _SLAB_FLOATS, _STAGES, _MAX_PER_WARP = 4, 512, 3, 4


def _slab_kernel(n: int) -> tuple:
    """(G lanes a row, VPL floats a lane) of the slab kernel for rows of n."""
    for lim, g in ((1, 1), (2, 2), (4, 4), (8, 8), (16, 16), (32, 32)):
        if n <= lim:
            return g, 1
    return (32, 2) if n <= 64 else (32, 4)


def geometry(x_addr: int, out_addr: int, m: int, n: int, fixed: int, *,
             sms: int, occupancy) -> tuple:
    """The launcher's choice for ``lut_softmax_geometry``'s arguments,
    written out in Python: ``(code, (grid, threads, shared memory,
    variant))``, variant 0 the global path or ``G * 16 + VPL`` a slab
    kernel.  ``occupancy(("lut_softmax", G, VPL, fixed), threads, smem)``
    is the blocks an SM holds (the card's answer, or a model of it)."""
    aligned = (x_addr | out_addr) % 16 == 0
    rows = 0 if not aligned or n < 1 or n > _SLAB_FLOATS // 4 else \
        _SLAB_FLOATS // n // 4 * 4
    if not rows:
        return 0, (min(-(-m // _WARPS), _MAX_BLOCKS), 32 * _WARPS, 0, 0)
    g, vpl = _slab_kernel(n)
    per_sm = occupancy(("lut_softmax", g, vpl, int(bool(fixed))),
                       32 * _SLAB_WARPS,
                       _SLAB_WARPS * _STAGES * 4 * _SLAB_FLOATS)
    if per_sm <= 0:
        return 1, (0, 0, 0, 0)
    warps = sms * per_sm * _SLAB_WARPS
    nslabs = -(-m // rows)
    per_warp = min(max(nslabs // warps, 1), _MAX_PER_WARP)
    blocks = -(-nslabs // (_SLAB_WARPS * per_warp))
    smem = _SLAB_WARPS * _STAGES * 4 * rows * n
    return 0, (blocks, 32 * _SLAB_WARPS, smem, g * 16 + vpl)


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
