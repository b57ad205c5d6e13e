"""Public wrappers for the CUDA kernels: arbitrary leading batch dims,
dtype plumbing, QTensor operands.

A wrapper launches its kernel for a tensor on a CUDA device and takes the
kernel's plain version (``kernels.ref``) only for a tensor on the CPU —
there is no fallback: if the kernels do not build, a CUDA call raises.

The reference's ``pad_to_block`` / ``fit_block`` helpers exist only to
meet the TPU compiler's (8, 128) tile rule; the CUDA kernels mask their
ragged edges themselves, so nothing is padded here and the helpers are
not ported.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import int8_matmul as _mm
from repro_torch.kernels import lut_gelu as _gelu
from repro_torch.kernels import lut_softmax as _sm

_KERNEL_MODULES = {"lut_softmax": _sm, "lut_gelu": _gelu, "int8_matmul": _mm}


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
    shape = x.shape
    out = _sm.lut_softmax_2d(x.reshape(-1, shape[-1]), fixed=fixed)
    return out.reshape(shape)


def int8_matmul(x_int, w_int, *, x_exp: int | None = None,
                w_exp: int | None = None, out_exp: int | None = None,
                residual_bits: int = 32) -> torch.Tensor:
    """Quantised matmul -> dequantised f32 (contract matches ref.int8_matmul).

    Operands may be raw int tensors (+ explicit exponents) or stored
    ``quant.QTensor``s — int8 or nibble-packed int4 — whose exponents and
    per-channel refinements are read off the container.  ``x_int`` may
    carry leading batch dims; ``w_int`` is [K, N].  Nibble-packed weights
    are unpacked by ``QTensor.int_values()`` before the launch.
    """
    from repro_torch.core import quant as _q

    w_axis = None
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
        w_int = w_int.int_values()
    if x_exp is None or w_exp is None:
        raise ValueError("raw int operands need explicit x_exp/w_exp")
    lead, k = x_int.shape[:-1], x_int.shape[-1]
    acc_exp = x_exp + w_exp
    out_exp = acc_exp if out_exp is None else out_exp
    out = _mm.int8_matmul_scaled(
        x_int.reshape(-1, k), w_int, shift=acc_exp - out_exp,
        clip16=(residual_bits == 16), out_exp=out_exp, axis_exponents=w_axis)
    return out.reshape(*lead, out.shape[-1])


def int8_matmul_raw(x_int: torch.Tensor, w_int: torch.Tensor, *,
                    shift: int = 0, out_int16: bool = False) -> torch.Tensor:
    """The raw accumulator of the kernel: int32, or int16 after the clip."""
    return _mm.int8_matmul_raw(x_int, w_int, shift=shift, out_int16=out_int16)
