"""INT8 x INT8 -> INT32 matmul with the po2 requant epilogue: wrapper of
the CUDA kernel ``csrc/int8_matmul.cu`` (which replaces the reference's
Pallas ``int8_matmul_raw`` and the wrapper arithmetic around it).

The kernel takes its operands as they are stored: the activation as int8,
or as float32 that it quantises itself by eq 9 (what the ``cuda`` plans
pass), the weight as int8 or as the nibble-packed int4 payload of a
``QTensor`` (unpacked as it is staged), the per-column exponents as int8.
Plain versions: :func:`ref.int8_matmul_raw` and :func:`ref.int8_matmul_io`.
:func:`pow2_neg` and :func:`nibble_grid` are the kernel's column scale and
int4 staging written out in torch, for the tests.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _launch, ref

launches = 0   # kernel launches made by this wrapper (all modes)

_F32, _I32, _I16 = 0, 1, 2      # out_mode of the C entry point


def pow2_neg(a: torch.Tensor) -> torch.Tensor:
    """``2^-a`` in float32 for int8 exponents ``a``, built from the bits as
    the kernel's epilogue builds it (``2^-127`` is the one subnormal, ``a =
    -128`` gives inf)."""
    a = a.to(torch.int32)
    bits = torch.where(a == 127, torch.full_like(a, 0x00400000),
                       (127 - a) << 23)
    return bits.view(torch.float32)


def nibble_grid(payload: torch.Tensor, k: int, n: int) -> torch.Tensor:
    """The kernel's int4 staging: flat index ``f = kk * n + nn`` of the
    ``[k, n]`` grid is read from byte ``f >> 1``, nibble ``f & 1`` (low
    first), sign-extended by ``(v ^ 8) - 8`` and written N-major, so the
    result is the ``[n, k]`` int8 grid (the transpose of
    ``quant.unpack_po2(payload, 4, (k, n))``)."""
    f = torch.arange(k * n, device=payload.device)
    byte = payload.to(torch.int32)[f >> 1]
    v = (((byte >> ((f & 1) * 4)) & 0xF) ^ 8) - 8
    out = torch.zeros((n, k), dtype=torch.int8, device=payload.device)
    out[f % n, f // n] = v.to(torch.int8)
    return out


_OUT_DTYPES = (torch.float32, torch.int32, torch.int16)   # by out_mode


def _check(x, w, w_shape):
    k = x.shape[-1] if x.ndim >= 1 else None
    kw = w_shape[0] if w_shape is not None else \
        (w.shape[0] if w.ndim == 2 else None)
    if kw is None or k != kw:
        got = tuple(w.shape) if w_shape is None else f"packed {tuple(w_shape)}"
        raise ValueError(f"int8_matmul takes [..., K] @ [K,N], got "
                         f"{tuple(x.shape)} @ {got}")


def _run(x, w, *, n, shift, clip16, out_mode, out_exp, axis, x_exp, x_bits,
         w_int4):
    """Launch on ``x [..., K]`` (its rows are those of the contiguous
    layout: nothing is reshaped) -> ``[..., N]``.  Kept lean: at the main
    path's small batches this Python costs more than the kernel."""
    global launches
    x_f32 = int(x.dtype == torch.float32)
    if not x_f32 and x.dtype != torch.int8:
        raise TypeError(f"int8_matmul kernel takes an int8 or float32 "
                        f"activation, got {x.dtype}")
    if w.dtype != (torch.uint8 if w_int4 else torch.int8):
        raise TypeError(f"int8_matmul kernel takes an int8 weight or a "
                        f"uint8 nibble-packed payload, got {w.dtype}")
    idx = x.get_device()
    if w.get_device() != idx:
        raise RuntimeError("int8_matmul: operands on different devices")
    if not -31 <= shift <= 31:
        raise ValueError(f"int8_matmul: shift {shift} outside int32")
    if not x.is_contiguous():
        x = x.contiguous()
    if not w.is_contiguous():
        w = w.contiguous()
    k = x.shape[-1]
    out = torch.empty((*x.shape[:-1], n), dtype=_OUT_DTYPES[out_mode],
                      device=x.device)
    m = out.numel() // n if n else 0
    if m == 0:
        return out
    if k == 0:
        return out.zero_()
    if axis is not None and (axis.dtype != torch.int8
                             or not axis.is_contiguous()):
        axis = axis.to(torch.int8).contiguous()
    st = _launch.state(idx)
    mode = clip16 | out_mode << 1 | x_f32 << 3 | w_int4 << 4 | x_bits << 8
    _launch.launch(st, st.lib.int8_matmul_launch, "int8_matmul (K too long "
                   "for its tiles in shared memory?)",
                   x.data_ptr(), w.data_ptr(), out.data_ptr(),
                   None if axis is None else axis.data_ptr(),
                   m, k, n, shift, mode, out_exp, x_exp if x_f32 else 0)
    launches += 1
    return out


def int8_matmul_raw(x_int: torch.Tensor, w_int: torch.Tensor, *,
                    shift: int = 0, out_int16: bool = False) -> torch.Tensor:
    """[M,K] i8 @ [K,N] i8 -> int32 (or clipped int16) with ``>> shift``."""
    if x_int.ndim != 2:
        raise ValueError(f"int8_matmul_raw takes [M,K] @ [K,N], got "
                         f"{tuple(x_int.shape)} @ {tuple(w_int.shape)}")
    _check(x_int, w_int, None)
    if not _launch.on_cuda(x_int, "int8_matmul"):
        return ref.int8_matmul_raw(x_int, w_int, shift=shift,
                                   out_int16=out_int16)
    if x_int.dtype != torch.int8:
        raise TypeError(f"int8_matmul_raw takes int8 operands, got "
                        f"{x_int.dtype} @ {w_int.dtype}")
    return _run(x_int, w_int, n=w_int.shape[1], shift=shift,
                clip16=int(bool(out_int16)),
                out_mode=_I16 if out_int16 else _I32, out_exp=0, axis=None,
                x_exp=None, x_bits=8, w_int4=0)


def int8_matmul_scaled(x: torch.Tensor, w: torch.Tensor, *, shift: int,
                       clip16: bool, out_exp: int,
                       axis_exponents: torch.Tensor | None = None,
                       x_exp: int | None = None, x_bits: int = 8,
                       w_shape: tuple | None = None) -> torch.Tensor:
    """The whole integer-executing linear in one launch: int32
    accumulate, shift, optional INT16 clip, then float32
    ``acc * 2^-out_exp * 2^-axis_exponents[n]``.

    ``x`` is the int8 grid ``[..., K]``, or a float activation that eq 9
    quantises (``x_exp``, ``x_bits`` <= 8) in the kernel; its leading dims
    stay (a contiguous ``x`` is not copied).  ``w`` is the int8 grid
    ``[K, N]``, or, with ``w_shape = (K, N)``, its nibble-packed int4
    payload.  ``axis_exponents`` are integers (int8 as a QTensor stores
    them)."""
    fp = x.is_floating_point()
    if fp:
        if x_exp is None:
            raise ValueError("a float activation needs its exponent x_exp")
        if not 1 <= x_bits <= 8:
            raise ValueError(f"int8_matmul quantises to at most 8 bits, got "
                             f"x_bits={x_bits}")
    _check(x, w, w_shape)
    if not _launch.on_cuda(x, "int8_matmul"):
        lead, k = x.shape[:-1], x.shape[-1]
        out = ref.int8_matmul_io(x.reshape(-1, k), w, shift=shift,
                                 clip16=clip16, out_exp=out_exp,
                                 axis_exponents=axis_exponents, x_exp=x_exp,
                                 x_bits=x_bits, w_shape=w_shape)
        return out.reshape(*lead, out.shape[-1])
    if fp and x.dtype != torch.float32:
        x = x.to(torch.float32)         # exact, as quantize_act does
    if not -126 <= out_exp <= 126 or (fp and not -126 <= x_exp <= 126):
        raise ValueError(f"int8_matmul: exponents {out_exp}, {x_exp} outside "
                         "float32's normal powers of two")
    return _run(x, w, n=w.shape[1] if w_shape is None else w_shape[1],
                shift=shift, clip16=int(bool(clip16)), out_mode=_F32,
                out_exp=out_exp, axis=axis_exponents, x_exp=x_exp,
                x_bits=x_bits, w_int4=int(w_shape is not None))
