"""LUT-approximated nonlinearities (paper §VI) as composable PyTorch functions.

These are the plain realisations of the paper's custom ALU behaviours
(Table VII), in both float32 and Q8.24 fixed-point.  The CUDA kernels in
``repro_torch.kernels`` execute the same math per row / per element and
are held bit-for-bit against these functions.

Dispatch contract:

    approx.softmax(x, mode=...)   mode in {"exact", "lut", "lut_fixed", "cuda"}
    approx.gelu(x, mode=...)      mode in {"exact", "lut", "lut_interp", "cuda"}

"exact"      - standard float op (the paper's un-accelerated C path).
"lut"        - float LUT gather (tables identical to the ROM contents).
"lut_fixed"  - full Q8.24 integer pipeline (the "+Hardware" path, Table IX).
"cuda"       - the same Q8.24 pipeline through the wrappers of
               ``repro_torch.kernels.ops``: the hand-written CUDA kernel
               for a tensor on the card, its plain version for a tensor
               on the CPU.

Every non-exact mode is wrapped in a straight-through estimator
(:func:`ste`, :func:`ste_masked`, ``torch.autograd.Function``s): the
forward value is the approx pipeline verbatim (for ``cuda`` on a CUDA
tensor, the kernel's output itself), while the backward is the gradient
of the exact float op at the saved input.  This is what lets
``repro_torch.qat`` put the deployed LUT numerics inside the training
loss.  The Function is used only where a gradient is asked for
(``torch.is_grad_enabled() and x.requires_grad``): under
``torch.inference_mode()`` or ``torch.no_grad()`` — every serving path —
the pipeline runs as it is, saves nothing and dispatches no extra op.

The dispatchers also emit the quantisation-health taps
(``telemetry.taps``): one module-global check, nothing else, unless an
Engine's taps pass is collecting.

Not ported yet: the reference's SiLU / softplus / squared-ReLU family and
its bf16 softmax branch (ROADMAP queue A item 3, the LM families).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from repro_torch.core import fixedpoint as fxp
from repro_torch.core import lut as lutlib
from repro_torch.telemetry import taps as _health


# ---------------------------------------------------------------------------
# Straight-through estimators
# ---------------------------------------------------------------------------

def _records_grad(x: torch.Tensor) -> bool:
    """Whether an autograd graph is being recorded through ``x``: the
    test that decides between the STE Function and the bare pipeline."""
    return torch.is_grad_enabled() and x.requires_grad


def _exact_grad(smooth_fn, x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """The exact op's input gradient at ``x``: ``torch.autograd.grad`` of
    ``smooth_fn`` on a fresh leaf, so that the result is the same bits as
    that call made by hand (PyTorch's own softmax / GELU backward)."""
    with torch.enable_grad():
        leaf = x.detach().requires_grad_(True)
        (gx,) = torch.autograd.grad(smooth_fn(leaf), leaf, g)
    return gx


class Ste(torch.autograd.Function):
    """STE over one operand: ``forward`` runs ``primal_fn(x)`` verbatim
    (the LUT / fixed-point pipeline or the CUDA kernel — bit-identical to
    calling it directly) and saves ``x``; ``backward`` returns the
    gradient of ``smooth_fn`` (the exact float op) at ``x``.  It launches
    no kernel: the exact op's backward is plain PyTorch, as the
    reference's is plain XLA."""

    @staticmethod
    def forward(ctx, x, primal_fn, smooth_fn):
        ctx.save_for_backward(x)
        ctx.smooth_fn = smooth_fn
        return primal_fn(x)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        return _exact_grad(ctx.smooth_fn, x, g), None, None


class SteMasked(torch.autograd.Function):
    """STE over ``(x, mask)``: the boolean mask is an explicit operand
    with no gradient, handed to both the primal and the exact op."""

    @staticmethod
    def forward(ctx, x, mask, primal_fn, smooth_fn):
        ctx.save_for_backward(x, mask)
        ctx.smooth_fn = smooth_fn
        return primal_fn(x, mask)

    @staticmethod
    def backward(ctx, g):
        x, mask = ctx.saved_tensors
        gx = _exact_grad(lambda v: ctx.smooth_fn(v, mask), x, g)
        return gx, None, None, None


def ste(primal_fn, smooth_fn):
    """Straight-through estimator: ``f(x)`` is ``primal_fn(x)``; where a
    gradient is recorded, through :class:`Ste`, whose backward is the
    gradient of ``smooth_fn`` at the same input."""
    def f(x):
        if not _records_grad(x):
            return primal_fn(x)
        return Ste.apply(x, primal_fn, smooth_fn)
    return f


def ste_masked(primal_fn, smooth_fn):
    """:func:`ste` over ``(x, mask)`` (:class:`SteMasked`)."""
    def f(x, mask):
        if not _records_grad(x):
            return primal_fn(x, mask)
        return SteMasked.apply(x, mask, primal_fn, smooth_fn)
    return f


# ---------------------------------------------------------------------------
# SoftMax (paper eqs 2, 10, 11, 12)
# ---------------------------------------------------------------------------

def softmax_exact(x: torch.Tensor, axis: int = -1) -> torch.Tensor:
    return torch.softmax(x.to(torch.float32), dim=axis)


def pre_shift_bits(k_len: int) -> int:
    """Bits the Q8.24 numerators are shifted down by before the row sum,
    so that a sum over ``k_len`` lanes stays inside int32:
    ``ceil(log2(k_len)) - 6``, at least 0, in integer arithmetic (the
    reference's float ``np.ceil(np.log2(n))`` gives the same for every
    ``n >= 1``)."""
    return max(0, (max(k_len, 1) - 1).bit_length() - 6)


def _pre_shift(num_q: torch.Tensor, pre: int) -> torch.Tensor:
    """Round-to-nearest right shift of the Q8.24 numerators.  Truncating
    here instead biases every lane low by ~2^{pre-1}, which deflates the
    row sum and overshoots the normalisation on long rows."""
    if pre <= 0:
        return num_q
    return (num_q + (1 << (pre - 1))) >> pre


def _exp_index_f32(z: torch.Tensor) -> torch.Tensor:
    """Float-path LUT_EXP index: z*32 truncated toward zero, clamped."""
    return (z * lutlib.BINS_PER_UNIT).to(torch.int32).clamp(
        0, lutlib.N_EXP_ENTRIES - 1).long()


def softmax_lut(x: torch.Tensor, axis: int = -1, *, fixed: bool = False,
                range_reduce: bool = True,
                bank: lutlib.LutBank | None = None) -> torch.Tensor:
    """Max-normalised LUT softmax (eq 10 with the eq-11/12 tables).

    z_i = clip(max(x) - x_i, 0, 10);  num_i = LUT_EXP[z_i*32]
    s = sum_i num_i;                  out_i = num_i * LUT_INV-based 1/s
    """
    x = x.to(torch.float32)
    z = (x.amax(dim=axis, keepdim=True) - x).clamp(0.0, lutlib.EXP_RANGE)
    if not fixed:
        num = lutlib._table(bank, "exp_f32", x.device)[_exp_index_f32(z)]
        s = num.sum(dim=axis, keepdim=True)
        if range_reduce:
            inv = 1.0 / s  # float path: true division, LUT only for exp
        else:
            inv = lutlib._table(bank, "inv_f32", x.device)[
                lutlib.inv_index_from_q24(fxp.to_fixed(s)).long()]
        return num * inv

    # Q8.24 integer pipeline: ALU_TO_FIXED -> ALU_EXP -> sum -> ALU_INVERT
    # -> fixed multiply -> ALU_TO_FLOAT.  Matches the C loop in §VI.
    #
    # The paper's int32 accumulator holds sums up to K=SEQLEN=27 in Q8.24;
    # beyond K=127 it would overflow.  For longer rows the numerators are
    # pre-shifted by `pre` bits so the row sum stays in int32, and the
    # reciprocal compensates (1/(s<<pre) == (1/s)>>pre).  pre==0
    # reproduces the paper bit-exactly at its own scales.
    pre = pre_shift_bits(x.shape[axis])
    z_q = fxp.to_fixed(z)
    num_q = lutlib._table(bank, "exp_q24", x.device)[
        lutlib.exp_index_from_q24(z_q).long()]                   # in [0, 1]
    s_q = _pre_shift(num_q, pre).sum(dim=axis, keepdim=True,
                                     dtype=torch.int32)          # Q8.(24-pre)
    inv_q = lutlib.reciprocal_q24(s_q, bank, range_reduce=range_reduce)
    inv_q = inv_q >> pre                                          # back to Q8.24
    out_q = fxp.fixed_mul(num_q, inv_q, nonneg=True)
    return fxp.to_float(out_q)


def softmax(x: torch.Tensor, axis: int = -1, mode: str = "exact",
            **kw) -> torch.Tensor:
    # quantisation-health tap (telemetry.taps): a no-op unless an Engine
    # taps pass is collecting
    if _health.active() and axis in (-1, x.ndim - 1):
        _health.tap_softmax(x, None, fixed=mode in ("lut_fixed", "cuda"))
    if mode == "exact":
        return softmax_exact(x, axis)
    if mode in ("lut", "lut_fixed"):
        primal = functools.partial(softmax_lut, axis=axis,
                                   fixed=mode == "lut_fixed", **kw)
    elif mode == "cuda":
        if axis not in (-1, x.ndim - 1):
            raise ValueError("the softmax kernel reduces the last axis")
        primal = _softmax_kernel
    else:
        raise ValueError(f"unknown softmax mode {mode!r}")
    return ste(primal, functools.partial(softmax_exact, axis=axis))(x)


def _softmax_kernel(x: torch.Tensor) -> torch.Tensor:
    from repro_torch.kernels import ops
    return ops.lut_softmax(x, fixed=True)


_NEG = torch.finfo(torch.float32).min


def _masked_exact(s: torch.Tensor, mask: torch.Tensor | None) -> torch.Tensor:
    sm = s if mask is None else torch.where(mask, s, _NEG)
    out = torch.softmax(sm, dim=-1)
    return out if mask is None else torch.where(mask, out, 0.0)


def _masked_cuda(s: torch.Tensor, mask: torch.Tensor | None) -> torch.Tensor:
    # Kernel path: unmasked rows are the kernel's LUT pipeline verbatim
    # (bit-identical to ops.lut_softmax).  With a mask, masked lanes enter
    # the kernel at the z=10 clip bin (the paper's own off-range leak);
    # they are zeroed and the row renormalised in f32.
    from repro_torch.kernels import ops
    sm = s if mask is None else torch.where(mask, s, _NEG)
    out = ops.lut_softmax(sm, fixed=True)
    if mask is not None:
        out = torch.where(mask, out, 0.0)
        out = out / out.sum(dim=-1, keepdim=True).clamp(min=1e-30)
    return out


def _masked_lut(s: torch.Tensor, mask: torch.Tensor | None) -> torch.Tensor:
    sm = s if mask is None else torch.where(mask, s, _NEG)
    z = (sm.amax(dim=-1, keepdim=True) - s).clamp(0.0, lutlib.EXP_RANGE)
    num = lutlib.bank_tensors(s.device)["exp_f32"][_exp_index_f32(z)]
    if mask is not None:
        num = torch.where(mask, num, 0.0)
    return num / num.sum(dim=-1, keepdim=True).clamp(min=1e-30)


def _masked_lut_fixed(s: torch.Tensor, mask: torch.Tensor | None) -> torch.Tensor:
    sm = s if mask is None else torch.where(mask, s, _NEG)
    z = (sm.amax(dim=-1, keepdim=True) - s).clamp(0.0, lutlib.EXP_RANGE)
    tabs = lutlib.bank_tensors(s.device)
    pre = pre_shift_bits(s.shape[-1])
    num_q = tabs["exp_q24"][lutlib.exp_index_from_q24(fxp.to_fixed(z)).long()]
    if mask is not None:
        num_q = torch.where(mask, num_q, 0)
    s_q = _pre_shift(num_q, pre).sum(dim=-1, keepdim=True, dtype=torch.int32)
    s_q = s_q.clamp(min=1)
    inv_q = lutlib.reciprocal_q24(s_q) >> pre
    return fxp.to_float(fxp.fixed_mul(num_q, inv_q, nonneg=True))


_MASKED_PRIMALS = {"cuda": _masked_cuda, "lut": _masked_lut,
                   "lut_fixed": _masked_lut_fixed}


def masked_softmax(s: torch.Tensor, mask: torch.Tensor | None,
                   mode: str = "exact") -> torch.Tensor:
    """Softmax over the last axis with *structural* masking.

    For the LUT modes, masked lanes are excluded from the numerator sum
    (they never reach the ROM), mirroring the paper's C pipeline which only
    computes valid entries — not approximated to e^{-10} by the clip.
    Rows that are fully masked return zeros.  The non-exact modes are
    STEs whose backward is the exact masked softmax's gradient.
    """
    if _health.active():   # health tap; see softmax()
        _health.tap_softmax(s, mask, fixed=mode in ("lut_fixed", "cuda"))
    s = s.to(torch.float32)
    if mode == "exact":
        return _masked_exact(s, mask)
    try:
        primal = _MASKED_PRIMALS[mode]
    except KeyError:
        raise ValueError(f"unknown softmax mode {mode!r}") from None
    if mask is None:
        return ste(lambda v: primal(v, None),
                   lambda v: _masked_exact(v, None))(s)
    return ste_masked(primal, _masked_exact)(s, mask)


# ---------------------------------------------------------------------------
# GELU (paper eqs 7, 13, Fig 7)
# ---------------------------------------------------------------------------

def gelu_exact(x: torch.Tensor) -> torch.Tensor:
    return torch.nn.functional.gelu(x.to(torch.float32), approximate="none")


def gelu_lut(x: torch.Tensor, *, interp: bool = False,
             bank: lutlib.LutBank | None = None) -> torch.Tensor:
    """Piecewise GELU: x above 1.595, 0 below -1.857, 32-entry LUT between."""
    x = x.to(torch.float32)
    tab = lutlib._table(bank, "gelu_f32", x.device)
    n = lutlib.N_GELU_ENTRIES
    # the thresholds meet float32 data as float32 values (see
    # lut.gelu_index_from_f32)
    lo = float(np.float32(lutlib.GELU_LO))
    hi = float(np.float32(lutlib.GELU_HI))
    if not interp:
        mid = tab[lutlib.gelu_index_from_f32(x).long()]
    else:
        # beyond-paper: linear interpolation between adjacent entries.
        scale = float(np.float32(float(n - 1) / (lutlib.GELU_HI - lutlib.GELU_LO)))
        t = ((x - lo) * scale).clamp(0.0, float(n - 1))
        i0 = torch.floor(t).to(torch.int32).clamp(0, n - 2)
        frac = t - i0.to(torch.float32)
        i0 = i0.long()
        mid = tab[i0] * (1.0 - frac) + tab[i0 + 1] * frac
    return torch.where(x > hi, x, torch.where(x < lo, 0.0, mid))


def _gelu_kernel(x: torch.Tensor) -> torch.Tensor:
    from repro_torch.kernels import ops
    return ops.lut_gelu(x)


def gelu(x: torch.Tensor, mode: str = "exact", **kw) -> torch.Tensor:
    if _health.active():   # health tap; see softmax()
        _health.tap_gelu(x)
    if mode == "exact":
        return gelu_exact(x)
    if mode in ("lut", "lut_interp"):
        primal = functools.partial(gelu_lut, interp=mode == "lut_interp", **kw)
    elif mode == "cuda":
        primal = _gelu_kernel
    else:
        raise ValueError(f"unknown gelu mode {mode!r}")
    return ste(primal, gelu_exact)(x)


def activation(name: str, mode: str = "exact"):
    """Resolve an activation by config name, honouring the approx mode."""
    if name == "gelu":
        if mode == "cuda":
            return lambda x: gelu(x, mode="cuda")
        return lambda x: gelu(x, mode="lut" if mode != "exact" else "exact")
    if name in ("silu", "sqrelu", "relu"):
        raise NotImplementedError(
            f"activation {name!r} serves the LM families, ROADMAP queue A "
            "item 3, not ported yet")
    raise ValueError(f"unknown activation {name!r}")
