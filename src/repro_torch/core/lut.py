"""Lookup-table construction (paper §VI, eqs 11-13, Table VII).

Three ROM tables, identical contents/sizes to the paper's:

  LUT_EXP  (ALU_EXP):    320 entries, e^{-z} for z in [0, 10), 32 bins/unit
                         -> LUT1[z*32] ~= 1/e^z              (eq 11)
  LUT_INV  (ALU_INVERT): 320 entries, 1/z for z in (0, 10], 32 bins/unit
                         -> LUT2[z*32 - 1] ~= 1/z            (eq 12)
  LUT_GELU (ALU_GELU):   32 entries over [-1.857, 1.595]     (eq 13, Fig 7)
                         identity tail above 1.595, zero tail below -1.857

Total ROM = (320+320)*4B + 32*4B = 2.69 kB, matching the paper's figure.

Tables are materialised both as float32 and as Q8.24 int32.  Construction
is pure numpy (the same code as the reference, so the six tables are
equal to the bit); :func:`bank_tensors` hands them out as tensors on a
device, cached per device.
"""

from __future__ import annotations

import dataclasses
from functools import lru_cache

import numpy as np
import torch

from repro_torch.core import fixedpoint as fxp

EXP_RANGE = 10.0          # paper: "all values of e^{max(x)-x_i} lie between 0 and 10"
BINS_PER_UNIT = 32        # paper: "32 divisions per unit"
N_EXP_ENTRIES = int(EXP_RANGE * BINS_PER_UNIT)   # 320
N_GELU_ENTRIES = 32
GELU_HI = 1.595           # GELU(x) = x above this           (paper Fig 7)
GELU_LO = -1.857          # GELU(x) = 0 below this


@dataclasses.dataclass(frozen=True)
class LutBank:
    """The paper's 2.69 kB ROM bank, held as numpy arrays."""

    exp_f32: np.ndarray    # [320] e^{-i/32}
    inv_f32: np.ndarray    # [320] 32/(i+1)  == 1/z at z=(i+1)/32
    gelu_f32: np.ndarray   # [32]  GELU on linspace(GELU_LO, GELU_HI, 32)
    exp_q24: np.ndarray    # int32 Q8.24 versions of the same
    inv_q24: np.ndarray
    gelu_q24: np.ndarray

    @property
    def rom_bytes(self) -> int:
        return 4 * (self.exp_f32.size + self.inv_f32.size + self.gelu_f32.size)


def _gelu_exact_np(x: np.ndarray) -> np.ndarray:
    # erf via math.erf vectorised (exact, not tanh-approximated -- paper eq 7).
    import math

    return np.asarray(
        [xi * 0.5 * (1.0 + math.erf(xi / math.sqrt(2.0))) for xi in np.ravel(x)],
        dtype=np.float64,
    ).reshape(np.shape(x))


@lru_cache(maxsize=4)
def make_lut_bank(bins_per_unit: int = BINS_PER_UNIT,
                  exp_range: float = EXP_RANGE,
                  n_gelu: int = N_GELU_ENTRIES) -> LutBank:
    n_exp = int(exp_range * bins_per_unit)
    # eq 11: LUT1[z*32] ~= e^{-z};  entry i corresponds to z = i/32.
    z = np.arange(n_exp, dtype=np.float64) / bins_per_unit
    exp_tab = np.exp(-z)
    # eq 12: LUT2[z*32 - 1] ~= 1/z; entry i corresponds to z = (i+1)/32.
    zi = (np.arange(n_exp, dtype=np.float64) + 1.0) / bins_per_unit
    inv_tab = 1.0 / zi
    # eq 13: 32 GELU samples across the paper's near-optimal thresholds.
    xg = np.linspace(GELU_LO, GELU_HI, n_gelu)
    gelu_tab = _gelu_exact_np(xg)

    def q24(a):
        return np.round(a * (1 << fxp.FRAC_BITS)).astype(np.int32)

    return LutBank(
        exp_f32=np.asarray(exp_tab, np.float32),
        inv_f32=np.asarray(inv_tab, np.float32),
        gelu_f32=np.asarray(gelu_tab, np.float32),
        exp_q24=q24(exp_tab),
        inv_q24=q24(inv_tab),
        gelu_q24=q24(gelu_tab),
    )


_TABLE_NAMES = ("exp_f32", "inv_f32", "gelu_f32", "exp_q24", "inv_q24",
                "gelu_q24")
_DEVICE_TABLES: dict = {}


def bank_tensors(device) -> dict:
    """The default bank's six tables as tensors on ``device`` (cached:
    the ROM is uploaded to a device once, not per call)."""
    key = str(torch.device(device))
    tabs = _DEVICE_TABLES.get(key)
    if tabs is None:
        bank = make_lut_bank()
        tabs = {n: torch.from_numpy(getattr(bank, n).copy()).to(device)
                for n in _TABLE_NAMES}
        _DEVICE_TABLES[key] = tabs
    return tabs


def _table(bank: LutBank | None, name: str, device) -> torch.Tensor:
    if bank is None:
        return bank_tensors(device)[name]
    return torch.from_numpy(getattr(bank, name).copy()).to(device)


# ---------------------------------------------------------------------------
# Index computations (shared by the plain path and mirrored in the kernels).
# ---------------------------------------------------------------------------

def exp_index_from_q24(z_q: torch.Tensor, bins_per_unit: int = BINS_PER_UNIT) -> torch.Tensor:
    """Index into LUT_EXP for Q8.24 z >= 0.  i = z*32 == z_q >> (24-5)."""
    shift = fxp.FRAC_BITS - int(np.log2(bins_per_unit))
    return (z_q.to(torch.int32) >> shift).clamp(0, N_EXP_ENTRIES - 1)


def inv_index_from_q24(s_q: torch.Tensor, bins_per_unit: int = BINS_PER_UNIT) -> torch.Tensor:
    """Index into LUT_INV for Q8.24 s > 0.  i = s*32 - 1 (eq 12)."""
    shift = fxp.FRAC_BITS - int(np.log2(bins_per_unit))
    return ((s_q.to(torch.int32) >> shift) - 1).clamp(0, N_EXP_ENTRIES - 1)


def gelu_index_from_f32(x: torch.Tensor, n: int = N_GELU_ENTRIES) -> torch.Tensor:
    # the constants act on float32 data as float32 values: round them on
    # the host so the subtract and the multiply see the same operands the
    # CUDA kernel is handed
    lo = float(np.float32(GELU_LO))
    scale = float(np.float32(float(n - 1) / (GELU_HI - GELU_LO)))
    t = (x - lo) * scale
    return torch.round(t).clamp(0, n - 1).to(torch.int32)


def reciprocal_q24(s_q: torch.Tensor, bank: LutBank | None = None,
                   range_reduce: bool = True) -> torch.Tensor:
    """1/s for Q8.24 s >= 1, via LUT_INV.

    Paper-faithful mode (range_reduce=False) indexes the (0,10] table
    directly and clamps -- exact reproduction of eq 12, including its
    saturation for sums > 10.

    range_reduce=True (beyond-paper robustness): normalise s = m * 2^k
    with m in [1,2), look up 1/m, shift back.  Needed for softmax over
    real sequence lengths (sum of e^{-z} over K keys can reach K >> 10;
    KWT-Tiny's own SEQLEN=27 already exceeds the table range when
    attention is flat).
    """
    s_q = s_q.to(torch.int32)
    inv_tab = _table(bank, "inv_q24", s_q.device)
    if not range_reduce:
        return inv_tab[inv_index_from_q24(s_q).long()]
    t = fxp.ilog2(s_q) - fxp.FRAC_BITS          # s * 2^-t in [1, 2)
    tp = t.clamp(min=0)
    tn = (-t).clamp(min=0)
    m = (s_q >> tp) << tn                        # mantissa in [1, 2) Q8.24
    inv_m = inv_tab[inv_index_from_q24(m).long()]
    # (1/m) * 2^-t, saturating on the (rare) left-shift overflow path: the
    # compare against INT32_MAX >> tn comes BEFORE the shift.
    limit = torch.full_like(tn, 2**31 - 1) >> tn
    return torch.where(t >= 0, inv_m >> tp,
                       torch.where(inv_m > limit,
                                   torch.full_like(inv_m, 2**31 - 1),
                                   inv_m << tn))
