"""Public wrappers for the CUDA kernels: arbitrary leading batch dims,
dtype plumbing, QTensor operands.

A wrapper launches its kernel for a tensor on a CUDA device and takes the
kernel's plain version (``kernels.ref``) only for a tensor on the CPU —
there is no fallback: if the kernels do not build, a CUDA call raises.

Under the cost model's op recorder (``analysis.op_walk.recorder`` set) a
wrapper reports what its kernel computes — op class, operations, bytes
(``perf.cost.*_charge``) — and the launch it makes (the arguments of its
kernel's geometry query, ``analysis.geometry``), and its own ATen ops go
unrecorded, so a plan prices and checks the same on either device.

On a device mesh no wrapper meets a sharded operand: the step's forward
runs on each rank's local tensors (``dist.spmd`` gathers the weights
first, as GSPMD gathers the operand of an opaque call), so the softmax
and the GELU take the rank's own rows — their functions are row-local —
and the matmul and the attention whole operands of the rank's batch
shard.  A ``DTensor`` that reaches a wrapper is refused
(:func:`refuse_dtensor`): its raw pointer is one shard, and the plain
version would run in its place unseen on a CPU mesh.

The CUDA kernels mask their ragged edges themselves, so nothing is padded
here and the reference's ``pad_to_block`` is not ported.  ``fit_block``
is: the attention kernel's key tiles must end where the reference's do.
"""

from __future__ import annotations

import functools

import torch

from repro_torch.analysis import op_walk as _walk
from repro_torch.core import quant as _q
from repro_torch.kernels import int8_matmul as _mm
from repro_torch.kernels import lut_attention as _attn
from repro_torch.kernels import lut_gelu as _gelu
from repro_torch.kernels import lut_softmax as _sm
from repro_torch.kernels import ref as _ref
from repro_torch.perf import cost as _cost

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


def restore_launch_counts(counts: dict) -> None:
    """Put back counts read by :func:`launch_counts`: the cost model's
    walks run a plan once and launch its kernels, for no path."""
    for name, mod in _KERNEL_MODULES.items():
        mod.launches = counts[name]


def refuse_grad(x: torch.Tensor, what: str) -> None:
    """Raise where a wrapper would cut a gradient: its output is written by
    a kernel (or, on the CPU, by integer table lookups) and carries no
    ``grad_fn``, so called on a tensor that requires grad while a graph is
    recorded it would silently give every weight upstream no gradient.
    Training reaches the kernels through the straight-through estimators
    of ``core.approx``, whose forward runs with grad mode off."""
    if torch.is_grad_enabled() and x.requires_grad:
        raise RuntimeError(
            f"{what} has no gradient: called on a tensor that requires grad "
            "while grad mode is on, its output would cut the graph. Train "
            "through the straight-through estimator (core.approx.softmax / "
            "masked_softmax / gelu, whose STE Function calls this wrapper "
            "in its forward), or call it under torch.no_grad()")


def refuse_dtensor(x, what: str) -> None:
    """Raise for a ``DTensor`` operand (see the module docstring)."""
    if type(x) is not torch.Tensor and isinstance(x, torch.Tensor):
        from repro_torch.dist import sharding
        if sharding.is_dtensor(x):
            raise TypeError(
                f"{what} got a DTensor: a kernel takes the rank's local "
                "tensors (dist.spmd gathers the weights before the forward)")


def _addr(t: torch.Tensor, dtype=None) -> int:
    """The address a launch would hand its kernel for ``t``: its own where
    the wrapper launches on it as it is, else (a fresh copy) 0 — every
    allocation is aligned beyond 16 bytes, and only the alignment enters
    the geometry."""
    if t.is_contiguous() and (dtype is None or t.dtype == dtype):
        return t.data_ptr()
    return 0


def lut_gelu(x: torch.Tensor, *, interp: bool = False) -> torch.Tensor:
    """Piecewise LUT GELU over any-shaped input (output in ``x.dtype``).
    Refuses a tensor that is recording a gradient (:func:`refuse_grad`)."""
    refuse_grad(x, "lut_gelu")
    refuse_dtensor(x, "lut_gelu")
    if _walk.recorder is not None:
        a = _addr(x)
        launch = ("lut_gelu", (a, a % 16, x.numel(),
                               2 * (x.dtype == torch.bfloat16) + int(interp))
                  ) if x.numel() else None
        return _walk.charged_launch(_cost.gelu_charge(x, interp), launch,
                                    _gelu.lut_gelu_flat, x, interp=interp)
    return _gelu.lut_gelu_flat(x, interp=interp)


def lut_softmax(x: torch.Tensor, *, fixed: bool = True) -> torch.Tensor:
    """LUT softmax along the last axis of any-shaped input.  Refuses a
    tensor that is recording a gradient (:func:`refuse_grad`)."""
    refuse_grad(x, "lut_softmax")
    refuse_dtensor(x, "lut_softmax")
    if _walk.recorder is not None:
        n = x.shape[-1] if x.ndim else 1
        launch = ("lut_softmax", (_addr(x, torch.float32), 0,
                                  x.numel() // n, n, int(fixed))
                  ) if x.numel() else None
        return _walk.charged_launch(_cost.softmax_charge(x, fixed), launch,
                                    _sm.lut_softmax_rows, x, fixed=fixed)
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
    refuse_dtensor(x_int, "int8_matmul")
    refuse_dtensor(w_int, "int8_matmul")
    acc_exp = x_exp + w_exp
    out_exp = acc_exp if out_exp is None else out_exp
    call = _mm.int8_matmul_scaled
    if _walk.recorder is not None:
        k, n = w_shape if w_shape is not None else w_int.shape
        m = x_int.numel() // max(k, 1)
        in_bytes = _walk.tensor_bytes(x_int) + _walk.tensor_bytes(w_int) + (
            0 if w_axis is None else _walk.tensor_bytes(w_axis))
        fp = x_int.is_floating_point()
        mode = int(residual_bits == 16) | fp << 3 | \
            (w_shape is not None) << 4 | x_bits << 8
        launch = ("int8_matmul", (
            _addr(x_int, torch.float32 if fp else None), _addr(w_int), 0,
            m, k, n, mode)) if m and n and k else None
        call = functools.partial(
            _walk.charged_launch,
            _cost.matmul_charge(m, k, n, in_bytes, 4 * m * n), launch, call)
    return call(
        x_int, w_int, shift=acc_exp - out_exp, clip16=residual_bits == 16,
        out_exp=out_exp, axis_exponents=w_axis, x_exp=x_exp, x_bits=x_bits,
        w_shape=w_shape)


def int8_matmul_raw(x_int: torch.Tensor, w_int: torch.Tensor, *,
                    shift: int = 0, out_int16: bool = False) -> torch.Tensor:
    """The raw accumulator of the kernel: int32, or int16 after the clip."""
    refuse_dtensor(x_int, "int8_matmul_raw")
    refuse_dtensor(w_int, "int8_matmul_raw")
    if _walk.recorder is not None:
        (k, n), m = w_int.shape, x_int.shape[0]
        in_bytes = _walk.tensor_bytes(x_int) + _walk.tensor_bytes(w_int)
        mode = int(bool(out_int16)) | (2 if out_int16 else 1) << 1 | 8 << 8
        launch = ("int8_matmul", (_addr(x_int), _addr(w_int), 0, m, k, n,
                                  mode)) if m and n and k else None
        return _walk.charged_launch(
            _cost.matmul_charge(m, k, n, in_bytes,
                                (2 if out_int16 else 4) * m * n), launch,
            _mm.int8_matmul_raw, x_int, w_int, shift=shift,
            out_int16=out_int16)
    return _mm.int8_matmul_raw(x_int, w_int, shift=shift, out_int16=out_int16)


def attention_block_k(lk: int) -> int:
    """The reference's key tile for ``lk`` keys, ``fit_block(lk, 128)``:
    the online rescale is a LUT probe, so the attention's result depends
    on where the tiles end."""
    return fit_block(lk, ATTN_BLOCK_K)


def lut_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True,
                        scale: float | None = None) -> torch.Tensor:
    """The attention kernel's plain version (``ref.lut_attention_tiled``,
    LUT mode) at the reference's key tile, on any device: the flash-LUT
    attention of every plan but ``cuda``.  Launches nothing."""
    return _ref.lut_attention_tiled(q, k, v, causal=causal, use_lut=True,
                                    scale=scale,
                                    block_k=attention_block_k(k.shape[2]))


def lut_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True, use_lut: bool = True,
                  scale: float | None = None) -> torch.Tensor:
    """Flash attention with LUT-exp softmax; [B,H,L,D] GQA layout.

    The key tile is the reference's (:func:`attention_block_k`).  The
    reference's query tile ``fit_block(Lq, 128)`` changes no result
    (query rows are independent) and is left to the kernel.
    """
    for t in (q, k, v):
        refuse_dtensor(t, "lut_attention")
    d = q.shape[-1]
    scale = (d ** -0.5) if scale is None else scale
    call = _attn.lut_attention
    block_k = attention_block_k(k.shape[2])
    if _walk.recorder is not None:
        b, hq, lq, _ = q.shape
        launch = ("lut_attention", (b, hq, k.shape[1], lq, k.shape[2], d,
                                    block_k)) if b * hq and lq else None
        call = functools.partial(_walk.charged_launch,
                                 _cost.attention_charge(q, k, v), launch, call)
    return call(q, k, v, causal=causal, use_lut=use_lut, scale=scale,
                block_k=block_k)
