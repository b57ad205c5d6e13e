"""Quantisation-health taps (the ``compile_model(taps=True)`` aux).

A *tap* is a scalar health statistic computed from a tensor the forward
already materialises — the numbers that tell you whether the paper's
fixed-point pipeline is running inside its numeric envelope:

* ``int8_sat_frac``   — fraction of activation values that would clip at
  the int8 edge under the plan's eq-9 input grid (``x * 2^e_in`` vs
  ±127).  Rising saturation means the Table V input exponent is too hot
  for this data.
* ``q24_headroom_bits`` — integer bits to spare before ``|x|`` reaches
  the Q8.24 representable edge (128).  Negative: ``ALU_TO_FIXED`` is
  saturating.
* ``lut_oob_frac``    — fraction of lanes hitting a LUT domain clip:
  softmax ``max(x) - x_i > 10`` (the eq-11 table edge, where the paper's
  pipeline silently leaks ``e^{-10}``), GELU inputs outside
  [-1.857, 1.595] (exact-tail region — benign, but drift here tracks
  activation-scale drift).
* ``q24_sum_headroom_bits`` — int32 bits to spare in the fixed softmax's
  numerator accumulator (the §VI overflow guard the pre-shift protects).

Collection protocol: model code calls :func:`tap_activation` /
:func:`tap_softmax` / :func:`tap_gelu` unconditionally — with no active
collector these return at once (one module-global ``None`` check), so a
forward without a collector dispatches exactly what it did before this
module existed.  The Engine's taps pass wraps a forward in
:func:`collecting` and returns :func:`pack` of what accumulated;
:func:`scope` prefixes names (``block0/softmax``) so per-layer stats
stay distinguishable.  The statistics are 0-d float32 tensors on the
forward's device.

The stat math *re-derives* cheap elementwise stages (max-subtract, table
index) from the tapped tensor rather than plumbing intermediates out of
``core.approx``'s pipelines; the formulas mirror ``approx.softmax_lut`` /
``gelu_lut`` line for line.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

from repro_torch.core import fixedpoint as fxp
from repro_torch.core import lut as lutlib

_ACTIVE: list | None = None
_SCOPE: list[str] = []

_Q24_EPS = 2.0 ** -24


def active() -> bool:
    return _ACTIVE is not None


@contextlib.contextmanager
def collecting():
    """Route taps emitted inside into a fresh collector list."""
    global _ACTIVE
    prev, _ACTIVE = _ACTIVE, []
    try:
        yield _ACTIVE
    finally:
        _ACTIVE = prev


@contextlib.contextmanager
def scope(name: str):
    """Prefix taps emitted inside with ``<name>/`` (per-layer naming)."""
    if _ACTIVE is None:
        yield
        return
    _SCOPE.append(name)
    try:
        yield
    finally:
        _SCOPE.pop()


def _emit(site: str, stats: dict):
    _ACTIVE.append(("/".join(_SCOPE + [site]), stats))


def _headroom_bits(maxabs: torch.Tensor, edge_bits: int) -> torch.Tensor:
    """Bits to spare before ``maxabs`` reaches ``2^edge_bits``."""
    return float(edge_bits) - torch.ceil(torch.log2(maxabs.clamp(min=_Q24_EPS)))


def tap_activation(site: str, x, cfg):
    """int8-grid saturation + Q8.24 headroom of one activation tensor."""
    if _ACTIVE is None:
        return
    q = getattr(cfg, "quant", None)
    e_in = q.input_exponent if q is not None else 5
    absx = torch.as_tensor(x).to(torch.float32).abs()
    hi = 2.0 ** 7 - 1                       # int8 clip edge on the input grid
    sat = (absx * (2.0 ** e_in) >= hi).to(torch.float32).mean()
    _emit(site, {"int8_sat_frac": sat,
                 "q24_headroom_bits": _headroom_bits(absx.amax(), 7)})


def tap_softmax(scores, mask=None, *, fixed: bool = False):
    """LUT exp out-of-domain fraction (+ Q8.24 accumulator headroom when
    the fixed pipeline runs) for one softmax's score tensor."""
    if _ACTIVE is None:
        return
    s = torch.as_tensor(scores).to(torch.float32)
    neg = torch.finfo(torch.float32).min
    sm = s if mask is None else torch.where(mask, s, neg)
    z = sm.amax(dim=-1, keepdim=True) - s             # >= 0 on valid lanes
    oob = z > lutlib.EXP_RANGE
    if mask is not None:
        valid = torch.broadcast_to(mask, z.shape)
        n_valid = valid.to(torch.float32).sum().clamp(min=1.0)
        frac = (oob & valid).to(torch.float32).sum() / n_valid
    else:
        frac = oob.to(torch.float32).mean()
    stats = {"lut_oob_frac": frac}
    if fixed:
        # mirror of approx.masked_softmax's lut_fixed accumulator: numerators
        # from the eq-11 ROM, pre-shifted so the int32 row sum cannot wrap.
        from repro_torch.core.approx import pre_shift_bits
        zc = z.clamp(0.0, lutlib.EXP_RANGE)
        num_q = lutlib.bank_tensors(s.device)["exp_q24"][
            lutlib.exp_index_from_q24(fxp.to_fixed(zc)).long()]
        if mask is not None:
            num_q = torch.where(torch.broadcast_to(mask, num_q.shape), num_q, 0)
        pre = pre_shift_bits(s.shape[-1])
        if pre > 0:
            num_q = (num_q + (1 << (pre - 1))) >> pre
        s_q = num_q.sum(dim=-1, dtype=torch.int32)
        max_sq = s_q.amax().to(torch.float32).clamp(min=1.0)
        stats["q24_sum_headroom_bits"] = 31.0 - torch.ceil(torch.log2(max_sq))
    _emit("softmax", stats)


def tap_gelu(x):
    """Fraction of GELU inputs outside the 32-entry table's [LO, HI]."""
    if _ACTIVE is None:
        return
    xf = torch.as_tensor(x).to(torch.float32)
    # the thresholds meet float32 data as float32 values (approx.gelu_lut)
    hi, lo = float(np.float32(lutlib.GELU_HI)), float(np.float32(lutlib.GELU_LO))
    out = (xf > hi) | (xf < lo)
    _emit("gelu", {"lut_oob_frac": out.to(torch.float32).mean()})


def pack(collected: list) -> dict:
    """Collector list -> ``{name: {stat: scalar}}`` with unique names
    (repeat sites outside any scope get ``#<k>`` suffixes)."""
    out: dict = {}
    for name, stats in collected:
        key, k = name, 1
        while key in out:
            key = f"{name}#{k}"
            k += 1
        out[key] = stats
    return out
