"""Q8.24 fixed-point arithmetic (paper §VI, ALU_TO_FIXED / ALU_TO_FLOAT).

The paper's custom RISC-V ALU operates on Q8.24 integers: a signed 32-bit
integer whose low 24 bits are the fraction.  Representable range is
[-128, 128) with resolution 2^-24.

Everything here is elementwise int32 tensor arithmetic and runs on any
device; the CUDA softmax kernel (``csrc/lut_softmax.cu``) executes the
same operations per lane and is held bit-for-bit against these functions.
``>>`` on a signed torch tensor is an arithmetic shift, as the pipeline
needs.

The Q8.24 x Q8.24 product uses a 12/12-bit limb decomposition
(`fixed_mul`) so that every partial product fits int32; it is exact
whenever both magnitudes fit in 24 bits (values in [0, 1] after
normalisation) — precisely the domain the SoftMax pipeline produces
(e^{-z} in [0,1], 1/sum in (0,1]).
"""

from __future__ import annotations

import torch

FRAC_BITS = 24
ONE = 1 << FRAC_BITS  # 1.0 in Q8.24
_INT32_MAX = 2**31 - 1
_INT32_MIN = -(2**31)
# float32(2^31 - 1) rounds up to 2^31, which no int32 holds: the largest
# float32 below it is the last value a float->int32 cast converts exactly.
_F32_BELOW_2_31 = 2147483520.0


def to_fixed(x: torch.Tensor) -> torch.Tensor:
    """ALU_TO_FIXED: float -> Q8.24 int32 (round-to-nearest-even,
    saturating at the int32 extremes)."""
    scaled = torch.as_tensor(x).to(torch.float32) * float(ONE)
    r = torch.round(scaled)
    q = r.clamp(float(_INT32_MIN), _F32_BELOW_2_31).to(torch.int32)
    # an out-of-range float->int cast is undefined in torch; pin the top
    return torch.where(r >= 2147483648.0,
                       torch.full_like(q, _INT32_MAX), q)


def to_float(q: torch.Tensor) -> torch.Tensor:
    """ALU_TO_FLOAT: Q8.24 int32 -> float32."""
    return q.to(torch.float32) * (1.0 / float(ONE))


def fixed_mul(a: torch.Tensor, b: torch.Tensor, *,
              nonneg: bool = False) -> torch.Tensor:
    """Q8.24 multiply, exact for |a|,|b| <= 1.0 (24-bit magnitudes).

    (a * b) >> 24 via 12/12 limb split so every partial product fits int32:
      a = ah*2^12 + al,  b = bh*2^12 + bl   (ah,bh <= 2^12 when |x|<=1)
      (a*b)>>24 = ah*bh + ((ah*bl + al*bh) >> 12) + ((al*bl) >> 24)

    ``nonneg=True`` asserts both operands are >= 0 (the SoftMax
    normalise) and skips the sign/abs handling — identical results on
    that domain.
    """
    a32 = a.to(torch.int32)
    b32 = b.to(torch.int32)
    if nonneg:
        ah, al = a32 >> 12, a32 & 0xFFF
        bh, bl = b32 >> 12, b32 & 0xFFF
        return ah * bh + ((ah * bl + al * bh) >> 12) + ((al * bl) >> 24)
    sign = torch.sign(a32) * torch.sign(b32)
    ma = torch.abs(a32)
    mb = torch.abs(b32)
    ah, al = ma >> 12, ma & 0xFFF
    bh, bl = mb >> 12, mb & 0xFFF
    prod = ah * bh + ((ah * bl + al * bh) >> 12) + ((al * bl) >> 24)
    return sign * prod


def fixed_shift_mul(a: torch.Tensor, shift: int) -> torch.Tensor:
    """Multiply a Q8.24 value by 2^shift (the paper's power-of-2 rescale).

    The left-shift path saturates like ``to_fixed`` does: ``a << shift``
    on int32 silently wraps once |a| >= 2^(31-shift).  Values past the
    representable range pin to the int32 extremes instead.
    """
    a = a.to(torch.int32)
    if shift == 0:
        return a
    if shift < 0:
        return a >> (-shift)
    hi_lim = _INT32_MAX >> shift
    lo_lim = _INT32_MIN >> shift
    shifted = a << shift
    return torch.where(a > hi_lim, torch.full_like(a, _INT32_MAX),
                       torch.where(a < lo_lim,
                                   torch.full_like(a, _INT32_MIN), shifted))


def ilog2(x: torch.Tensor) -> torch.Tensor:
    """floor(log2(x)) for positive int32 x, as a fixed compare ladder.

    Used by the range-reduced reciprocal (lut.reciprocal_q24): a Q8.24
    value x is normalised to m = x * 2^-t in [1, 2) with t = ilog2(x) - 24.
    """
    x = x.to(torch.int32)
    k = torch.zeros_like(x)
    for step in (16, 8, 4, 2, 1):
        cond = x >= (1 << step)
        k = torch.where(cond, k + step, k)
        x = torch.where(cond, x >> step, x)
    return k
