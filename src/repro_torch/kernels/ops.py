"""Public wrappers for the CUDA kernels: arbitrary leading batch dims,
dtype plumbing, QTensor operands.

A wrapper launches its kernel for a tensor on a CUDA device and takes the
kernel's plain version (``kernels.ref``) only for a tensor on the CPU —
there is no fallback: if the kernels do not build, a CUDA call raises.

The CUDA kernels mask their ragged edges themselves, so nothing is padded
here and the reference's ``pad_to_block`` is not ported.  ``fit_block``
is: the attention kernel's key tiles must end where the reference's do.
"""

from __future__ import annotations

import torch

from repro_torch.core import quant as _q
from repro_torch.kernels import int8_matmul as _mm
from repro_torch.kernels import lut_attention as _attn
from repro_torch.kernels import lut_gelu as _gelu
from repro_torch.kernels import lut_softmax as _sm

_KERNEL_MODULES = {"lut_softmax": _sm, "lut_gelu": _gelu, "int8_matmul": _mm,
                   "lut_attention": _attn}

# the reference's preferred attention key tile (its DEFAULT_BK)
ATTN_BLOCK_K = 128


def fit_block(size: int, preferred: int) -> int:
    """Largest power-of-two shrink of ``preferred`` that divides ``size``.

    Kernels require the grid to tile the (padded) array exactly; this
    replaces the per-wrapper ``while size % b: b //= 2`` loops.  Always
    >= 1 for positive sizes (1 divides everything).
    """
    assert size > 0 and preferred > 0, (size, preferred)
    b = min(preferred, size)
    while size % b:
        b //= 2
    return max(b, 1)


def launch_counts() -> dict:
    """Kernel launches made by each wrapper since the last reset."""
    return {name: mod.launches for name, mod in _KERNEL_MODULES.items()}


def reset_launch_counts() -> None:
    for mod in _KERNEL_MODULES.values():
        mod.launches = 0


def lut_gelu(x: torch.Tensor, *, interp: bool = False) -> torch.Tensor:
    """Piecewise LUT GELU over any-shaped input (output in ``x.dtype``)."""
    return _gelu.lut_gelu_flat(x, interp=interp)


def lut_softmax(x: torch.Tensor, *, fixed: bool = True) -> torch.Tensor:
    """LUT softmax along the last axis of any-shaped input."""
    return _sm.lut_softmax_rows(x, fixed=fixed)


def int8_matmul(x_int, w_int, *, x_exp: int | None = None,
                w_exp: int | None = None, out_exp: int | None = None,
                residual_bits: int = 32, x_bits: int = 8) -> torch.Tensor:
    """Quantised matmul -> dequantised f32 (contract matches ref.int8_matmul).

    Operands may be raw int tensors (+ explicit exponents) or stored
    ``quant.QTensor``s — int8 or nibble-packed int4 — whose exponents and
    per-channel refinements are read off the container.  ``x_int`` may
    carry leading batch dims (a contiguous one is not copied); ``w_int`` is
    [K, N].  ``x_int`` may also be the float activation itself: it is
    quantised by eq 9 (``quant.quantize_act`` with ``x_exp`` and
    ``x_bits``), on the card inside the kernel.  A nibble-packed weight is
    unpacked inside the kernel too.
    """
    w_axis = w_shape = None
    if isinstance(x_int, _q.QTensor):
        if x_int.axis_exponents is not None:
            # x's axis_exponents scale its LAST axis — the contraction
            # axis here — which cannot fold into a post-matmul rescale.
            raise NotImplementedError(
                "per-channel axis_exponents on the activation operand "
                "vary along the contraction axis; dequantise x instead")
        x_exp = x_int.exponent if x_exp is None else x_exp
        x_int = x_int.int_values()
    if isinstance(w_int, _q.QTensor):
        w_exp = w_int.exponent if w_exp is None else w_exp
        w_axis = w_int.axis_exponents
        if w_int.packed:
            w_shape = w_int.logical_shape
        w_int = w_int.values if w_int.packed else w_int.int_values()
    if x_exp is None or w_exp is None:
        raise ValueError("raw int operands need explicit x_exp/w_exp")
    acc_exp = x_exp + w_exp
    out_exp = acc_exp if out_exp is None else out_exp
    return _mm.int8_matmul_scaled(
        x_int, w_int, shift=acc_exp - out_exp, clip16=residual_bits == 16,
        out_exp=out_exp, axis_exponents=w_axis, x_exp=x_exp, x_bits=x_bits,
        w_shape=w_shape)


def int8_matmul_raw(x_int: torch.Tensor, w_int: torch.Tensor, *,
                    shift: int = 0, out_int16: bool = False) -> torch.Tensor:
    """The raw accumulator of the kernel: int32, or int16 after the clip."""
    return _mm.int8_matmul_raw(x_int, w_int, shift=shift, out_int16=out_int16)


def lut_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True, use_lut: bool = True,
                  scale: float | None = None) -> torch.Tensor:
    """Flash attention with LUT-exp softmax; [B,H,L,D] GQA layout.

    The key tile is the reference's, ``fit_block(Lk, 128)``: the online
    rescale is a LUT probe, so the result depends on where the tiles end.
    The reference's query tile ``fit_block(Lq, 128)`` changes no result
    (query rows are independent) and is left to the kernel.
    """
    d = q.shape[-1]
    scale = (d ** -0.5) if scale is None else scale
    return _attn.lut_attention(q, k, v, causal=causal, use_lut=use_lut,
                               scale=scale,
                               block_k=fit_block(k.shape[2], ATTN_BLOCK_K))
