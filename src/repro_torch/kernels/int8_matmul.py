"""INT8 x INT8 -> INT32 matmul with the po2 requant epilogue: wrapper of
the CUDA kernel ``csrc/int8_matmul.cu`` (which replaces the reference's
Pallas ``int8_matmul_raw`` and the wrapper arithmetic around it).  Plain
versions: :func:`ref.int8_matmul_raw` and :func:`ref.int8_matmul_scaled`."""

from __future__ import annotations

import torch

from repro_torch.kernels import _launch, ref

launches = 0   # kernel launches made by this wrapper (all output modes)

_F32, _I32, _I16 = 0, 1, 2      # out_mode of the C entry point


def _check(x_int, w_int):
    if x_int.ndim != 2 or w_int.ndim != 2 or x_int.shape[1] != w_int.shape[0]:
        raise ValueError(f"int8_matmul takes [M,K] @ [K,N], got "
                         f"{tuple(x_int.shape)} @ {tuple(w_int.shape)}")


def _run(x_int, w_int, *, shift, clip16, out_mode, scale, col_scale):
    global launches
    if x_int.dtype != torch.int8 or w_int.dtype != torch.int8:
        raise TypeError("int8_matmul kernel takes int8 operands, got "
                        f"{x_int.dtype} @ {w_int.dtype}")
    if w_int.device != x_int.device:
        raise RuntimeError("int8_matmul: operands on different devices")
    if abs(shift) > 31:
        raise ValueError(f"int8_matmul: shift {shift} outside int32")
    x_int, w_int = x_int.contiguous(), w_int.contiguous()
    m, k = x_int.shape
    n = w_int.shape[1]
    dtype = {_F32: torch.float32, _I32: torch.int32, _I16: torch.int16}[out_mode]
    out = torch.empty((m, n), dtype=dtype, device=x_int.device)
    if out.numel() == 0:
        return out
    if k == 0:
        return out.zero_()
    if col_scale is not None:
        col_scale = col_scale.to(torch.float32).contiguous()
    st = _launch.state(x_int.get_device())
    _launch.launch(st, st.lib.int8_matmul_launch, "int8_matmul",
                   x_int.data_ptr(), w_int.data_ptr(), out.data_ptr(),
                   None if col_scale is None else col_scale.data_ptr(),
                   m, k, n, shift, int(clip16), out_mode, scale)
    launches += 1
    return out


def int8_matmul_raw(x_int: torch.Tensor, w_int: torch.Tensor, *,
                    shift: int = 0, out_int16: bool = False) -> torch.Tensor:
    """[M,K] i8 @ [K,N] i8 -> int32 (or clipped int16) with ``>> shift``."""
    _check(x_int, w_int)
    if not _launch.on_cuda(x_int, "int8_matmul"):
        return ref.int8_matmul_raw(x_int, w_int, shift=shift,
                                   out_int16=out_int16)
    return _run(x_int, w_int, shift=shift, clip16=out_int16,
                out_mode=_I16 if out_int16 else _I32, scale=1.0,
                col_scale=None)


def int8_matmul_scaled(x_int: torch.Tensor, w_int: torch.Tensor, *,
                       shift: int, clip16: bool, out_exp: int,
                       axis_exponents: torch.Tensor | None = None
                       ) -> torch.Tensor:
    """The whole integer-executing linear in one launch: int32
    accumulate, shift, optional INT16 clip, then float32
    ``acc * 2^-out_exp * 2^-axis_exponents[n]``."""
    _check(x_int, w_int)
    if not _launch.on_cuda(x_int, "int8_matmul"):
        return ref.int8_matmul_scaled(x_int, w_int, shift=shift, clip16=clip16,
                                      out_exp=out_exp,
                                      axis_exponents=axis_exponents)
    col = None if axis_exponents is None else \
        torch.exp2(-axis_exponents.to(torch.float32))
    return _run(x_int, w_int, shift=shift, clip16=clip16, out_mode=_F32,
                scale=2.0 ** (-out_exp), col_scale=col)
