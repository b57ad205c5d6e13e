"""Plain PyTorch versions of every CUDA kernel in this package.

Each function is the bit-level specification its kernel is held against:
same LUT contents, same index math, same accumulation widths.  The
wrappers take these for tensors on the CPU; the GPU smoke script calls
them on CUDA tensors to compare with the kernels.
"""

from __future__ import annotations

import torch

from repro_torch.core import approx, lut as lutlib, quant


def lut_softmax(x: torch.Tensor, *, fixed: bool = True,
                range_reduce: bool = True) -> torch.Tensor:
    """Row softmax over the last axis via the paper's LUT pipeline.

    ``fixed=True`` is ``approx.softmax_lut(fixed=True)``: the Q8.24
    pipeline with the rounding pre-shift.  The float variant gathers
    LUT_EXP in float32 and divides by the row sum; the sum is taken in
    float64, where it is exact for rows of up to 2^14 lanes (every table
    entry is a multiple of 2^-38 not above 1), so the value does not
    depend on the order of summation and the kernel can match it to the
    bit.
    """
    if fixed:
        return approx.softmax_lut(x, axis=-1, fixed=True,
                                  range_reduce=range_reduce)
    x = x.to(torch.float32)
    z = (x.amax(dim=-1, keepdim=True) - x).clamp(0.0, lutlib.EXP_RANGE)
    num = lutlib.bank_tensors(x.device)["exp_f32"][approx._exp_index_f32(z)]
    total = num.sum(dim=-1, keepdim=True, dtype=torch.float64)
    return num / total.to(torch.float32)


def lut_gelu(x: torch.Tensor, *, interp: bool = False) -> torch.Tensor:
    """Piecewise LUT GELU, computed in float32, returned in ``x.dtype``."""
    return approx.gelu_lut(x, interp=interp).to(x.dtype)


def int8_matmul_raw(x_int: torch.Tensor, w_int: torch.Tensor, *,
                    shift: int = 0, out_int16: bool = False) -> torch.Tensor:
    """[M,K] int8 @ [K,N] int8 -> int32 with epilogue ``>> shift`` (or
    ``<< -shift``); ``out_int16`` clips to the INT16 range and narrows."""
    acc = quant.exact_int_matmul(x_int, w_int)
    acc = acc >> shift if shift >= 0 else acc << (-shift)
    if out_int16:
        return acc.clamp(quant.INT16_MIN, quant.INT16_MAX).to(torch.int16)
    return acc


def int8_matmul_scaled(x_int: torch.Tensor, w_int: torch.Tensor, *,
                       shift: int, clip16: bool, out_exp: int,
                       axis_exponents: torch.Tensor | None = None
                       ) -> torch.Tensor:
    """The integer-executing linear: int32 accumulate, shift, optional
    INT16 clip, then float32 ``acc * 2^-out_exp * 2^-axis_exponents[n]``
    (the wrapper arithmetic of the reference's ``ops.int8_matmul``)."""
    acc = int8_matmul_raw(x_int, w_int, shift=shift, out_int16=clip16)
    out = acc.to(torch.float32) * (2.0 ** (-out_exp))
    if axis_exponents is not None:
        out = out * torch.exp2(-axis_exponents.to(torch.float32))
    return out


def int8_matmul(x_int: torch.Tensor, w_int: torch.Tensor, *, x_exp: int,
                w_exp: int, out_exp: int | None = None,
                residual_bits: int = 32) -> torch.Tensor:
    """INT8 x INT8 -> INT32 accumulate -> shift-rescale (paper eq 9 epilogue).

    Returns float32 dequantised output (the framework-facing contract).
    """
    q = quant.qmatmul(quant.QTensor(x_int, x_exp), quant.QTensor(w_int, w_exp),
                      out_exponent=out_exp, residual_bits=residual_bits)
    return q.dequantize()
