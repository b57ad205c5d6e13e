"""Piecewise LUT GELU: wrapper of the CUDA kernel ``csrc/lut_gelu.cu``
(which replaces the reference's Pallas ``lut_gelu_2d``).  Plain version:
:func:`ref.lut_gelu`.

The kernel moves 16-byte vectors: its launcher cuts the flat array into a
scalar head up to the first 16-byte boundary, whole vectors and a scalar
tail.  The output is allocated with the input's offset modulo 16 bytes,
so that one cut serves both.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _launch, ref

launches = 0   # kernel launches made by this wrapper

_THREADS, _UNROLL = 256, 2       # the launcher's (csrc/lut_gelu.cu)


def geometry(x_addr: int, out_addr: int, numel: int, mode: int, **_) -> tuple:
    """The launcher's choice for ``lut_gelu_geometry``'s arguments, written
    out in Python: ``(code, (grid, threads, shared memory, scalar head))``;
    code 1 where the launcher refuses the addresses."""
    size = 2 if mode >= 2 else 4
    per_vec = 16 // size
    if (x_addr | out_addr) % size:
        return 1, (0, 0, 0, 0)
    head = min(((16 - x_addr % 16) % 16) // size, numel)
    vectors = (numel - head) // per_vec
    if vectors > 0 and (x_addr ^ out_addr) % 16:
        return 1, (0, 0, 0, 0)
    want = -(-vectors // (_THREADS * _UNROLL))
    if want >= 2 ** 31:
        return 1, (0, 0, 0, 0)
    return 0, (max(want, 1), _THREADS, 0, head)


def empty_aligned_like(x: torch.Tensor) -> torch.Tensor:
    """An uninitialised contiguous tensor of ``x``'s shape and dtype whose
    address has the same remainder modulo 16 bytes as ``x``'s, so that an
    elementwise kernel can move both in the same 16-byte vectors.  A
    16-byte aligned ``x`` (every tensor the allocator hands out) gets
    ``torch.empty_like``; a view that starts inside a vector gets a view
    into a slightly larger block."""
    off = (x.data_ptr() % 16) // x.element_size()
    if off == 0:
        return torch.empty_like(x, memory_format=torch.contiguous_format)
    buf = torch.empty(x.numel() + off, dtype=x.dtype, device=x.device)
    return buf[off:].view(x.shape)


def lut_gelu_flat(x: torch.Tensor, *, interp: bool = False) -> torch.Tensor:
    """LUT GELU over a tensor of any shape (elementwise), float32 or
    bfloat16 in and out."""
    if not _launch.on_cuda(x, "lut_gelu"):
        return ref.lut_gelu(x, interp=interp)
    bf16 = x.dtype == torch.bfloat16
    if not bf16 and x.dtype != torch.float32:
        raise TypeError(f"lut_gelu kernel takes float32 or bfloat16, got {x.dtype}")
    global launches
    if not x.is_contiguous():
        x = x.contiguous()
    out = empty_aligned_like(x)
    numel = x.numel()
    if numel == 0:
        return out
    st = _launch.state(x.get_device())
    _launch.launch(st, st.lib.lut_gelu_launch, "lut_gelu", x.data_ptr(),
                   st.gelu_f32, out.data_ptr(), numel, 2 * bf16 + interp)
    launches += 1
    return out
