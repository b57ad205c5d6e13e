"""The paper's numerics, written out plainly for the references.

A frozen copy of what the configurations state: the three ROM tables
(eqs 11-13, built by numpy as the paper describes them), the Q8.24
fixed-point softmax (eq 10) with its range-reduced reciprocal, the
32-entry GELU, the 256-entry sigmoid behind the LMs' SiLU, the eq-9
power-of-two cast of weights (scalar or per output channel) and of a
linear layer's input, and the INT16 clip of the integer product.

Nothing here imports the program: the references hold the program to
these definitions, so a later change to the program's copies cannot
move the yardstick.
"""

from __future__ import annotations

import math
from functools import lru_cache

import numpy as np
import torch

FRAC = 24                   # Q8.24
ONE = 1 << FRAC
EXP_RANGE = 10.0
BINS = 32                   # LUT bins per unit
N_EXP = 320
GELU_LO, GELU_HI, N_GELU = -1.857, 1.595, 32
SIG_RANGE, N_SIG = 8.0, 256
INT16 = 2 ** 15 - 1


@lru_cache(maxsize=None)
def tables_np() -> dict:
    """exp_f32 / exp_q24 / inv_q24 / gelu_f32 / sig_f32 as numpy arrays."""
    z = np.arange(N_EXP, dtype=np.float64) / BINS
    zi = (np.arange(N_EXP, dtype=np.float64) + 1.0) / BINS
    xg = np.linspace(GELU_LO, GELU_HI, N_GELU)
    gelu = np.array([x * 0.5 * (1.0 + math.erf(x / math.sqrt(2.0)))
                     for x in xg])
    zs = np.linspace(-SIG_RANGE, SIG_RANGE, N_SIG)

    def q24(a):
        return np.round(a * ONE).astype(np.int32)

    return {"exp_f32": np.exp(-z).astype(np.float32),
            "exp_q24": q24(np.exp(-z)), "inv_q24": q24(1.0 / zi),
            "gelu_f32": gelu.astype(np.float32),
            "sig_f32": (1.0 / (1.0 + np.exp(-zs))).astype(np.float32)}


def table(name: str, device) -> torch.Tensor:
    return torch.from_numpy(tables_np()[name].copy()).to(device)


# -- Q8.24 ------------------------------------------------------------------

def to_fixed(x: torch.Tensor) -> torch.Tensor:
    """float -> Q8.24, round half to even, saturating."""
    r = torch.round(x.float() * float(ONE))
    q = r.clamp(-2.0 ** 31, 2147483520.0).to(torch.int32)
    return torch.where(r >= 2.0 ** 31, torch.full_like(q, 2 ** 31 - 1), q)


def fixed_mul_nonneg(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(a * b) >> 24 for Q8.24 values in [0, 1], by 12-bit limbs."""
    ah, al, bh, bl = a >> 12, a & 0xFFF, b >> 12, b & 0xFFF
    return ah * bh + ((ah * bl + al * bh) >> 12) + ((al * bl) >> 24)


def ilog2(x: torch.Tensor) -> torch.Tensor:
    k = torch.zeros_like(x)
    for step in (16, 8, 4, 2, 1):
        c = x >= (1 << step)
        k = torch.where(c, k + step, k)
        x = torch.where(c, x >> step, x)
    return k


def reciprocal_q24(s: torch.Tensor) -> torch.Tensor:
    """1/s for Q8.24 s >= 1: s = m * 2^t, m in [1, 2) from the table."""
    inv = table("inv_q24", s.device)
    t = ilog2(s) - FRAC
    tp, tn = t.clamp(min=0), (-t).clamp(min=0)
    m = (s >> tp) << tn
    inv_m = inv[((m >> (FRAC - 5)) - 1).clamp(0, N_EXP - 1).long()]
    limit = torch.full_like(tn, 2 ** 31 - 1) >> tn
    return torch.where(t >= 0, inv_m >> tp,
                       torch.where(inv_m > limit,
                                   torch.full_like(inv_m, 2 ** 31 - 1),
                                   inv_m << tn))


def softmax_q24(x: torch.Tensor) -> torch.Tensor:
    """Row softmax over the last axis in Q8.24 (eq 10): z = clip(max - x,
    0, 10), numerators from LUT_EXP, long rows' numerators rounded down
    by ``ceil(log2 n) - 6`` bits before the int32 sum, the sum's
    reciprocal, one fixed multiply, back to float."""
    x = x.float()
    n = x.shape[-1]
    pre = max(0, (max(n, 1) - 1).bit_length() - 6)
    z = (x.amax(-1, keepdim=True) - x).clamp(0.0, EXP_RANGE)
    num = table("exp_q24", x.device)[
        (to_fixed(z) >> (FRAC - 5)).clamp(0, N_EXP - 1).long()]
    shifted = num if pre == 0 else (num + (1 << (pre - 1))) >> pre
    s = shifted.sum(-1, keepdim=True, dtype=torch.int32)
    inv = reciprocal_q24(s) >> pre
    return fixed_mul_nonneg(num, inv).float() * (1.0 / ONE)


def exp_lut(z: torch.Tensor) -> torch.Tensor:
    """e^-z from LUT_EXP for z >= 0: the bin z*32 truncated, clipped."""
    z = z.clamp(0.0, EXP_RANGE)
    idx = (z * BINS).to(torch.int32).clamp(0, N_EXP - 1).long()
    return table("exp_f32", z.device)[idx]


def gelu_lut(x: torch.Tensor) -> torch.Tensor:
    """eq 13: x above 1.595, 0 below -1.857, the nearest of 32 samples
    between (the thresholds meet float32 data as float32 values)."""
    x = x.float()
    lo, hi = float(np.float32(GELU_LO)), float(np.float32(GELU_HI))
    scale = float(np.float32((N_GELU - 1) / (GELU_HI - GELU_LO)))
    idx = torch.round((x - lo) * scale).clamp(0, N_GELU - 1).long()
    mid = table("gelu_f32", x.device)[idx]
    return torch.where(x > hi, x, torch.where(x < lo, 0.0, mid))


def silu_lut(x: torch.Tensor) -> torch.Tensor:
    """x * sigmoid(x), the sigmoid the nearest of 256 samples over
    [-8, 8], 1 above and 0 below."""
    x = x.float()
    t = (x + SIG_RANGE) * ((N_SIG - 1) / (2 * SIG_RANGE))
    idx = torch.round(t).to(torch.int32).clamp(0, N_SIG - 1).long()
    sig = torch.where(x > SIG_RANGE, 1.0,
                      torch.where(x < -SIG_RANGE, 0.0,
                                  table("sig_f32", x.device)[idx]))
    return x * sig


# -- eq 9 -------------------------------------------------------------------

def quantize_weight(w: torch.Tensor, exponent: int, bits: int,
                    per_channel: bool) -> tuple[torch.Tensor, torch.Tensor]:
    """The integer grid of ``w`` and the exponent of each output channel
    (the last axis): ``floor(w * 2^e + 0.5)`` clipped to ``bits``.  Per
    channel, e is shifted to the channel's own no-saturation bound, the
    maximum taken over every other axis (stacked layers included), the
    shift clipped to [-12, 12]."""
    lo, hi = -(2 ** (bits - 1)), 2 ** (bits - 1) - 1
    w = w.float()
    e = torch.full((w.shape[-1],), float(exponent), device=w.device)
    if per_channel:
        maxabs = w.abs().amax(dim=tuple(range(w.ndim - 1)))
        extra = torch.floor(torch.log2(hi / maxabs.clamp(min=1e-30)))
        e = e + (extra - exponent).clamp(-12, 12)
    q = torch.floor(w * torch.exp2(e) + 0.5).clamp(lo, hi)
    return q, e


def ptq(w: torch.Tensor, exponent: int, bits: int, per_channel: bool):
    """(grid, exponents, float view ``grid * 2^-e``) of one weight leaf."""
    q, e = quantize_weight(w, exponent, bits, per_channel)
    return q, e, q * torch.exp2(-e)


def quantize_act(x: torch.Tensor, exponent: int) -> torch.Tensor:
    """eq 9 on a linear layer's input: the int8 grid, as float."""
    return torch.floor(x.float() * 2.0 ** exponent + 0.5).clamp(-128, 127)


def int_linear(x: torch.Tensor, q: torch.Tensor, e: torch.Tensor,
               x_exp: int) -> torch.Tensor:
    """The integer-executing linear: x cast by eq 9, the exact integer
    product (float64 holds every partial sum), clipped to INT16, scaled
    back by 2^-(x_exp + e) per output channel."""
    xq = quantize_act(x, x_exp)
    shape = xq.shape
    acc = xq.reshape(-1, shape[-1]).double() @ q.double()
    acc = acc.clamp(-INT16 - 1, INT16).float()
    out = acc * torch.exp2(-(e + x_exp))
    return out.reshape(*shape[:-1], q.shape[-1])

