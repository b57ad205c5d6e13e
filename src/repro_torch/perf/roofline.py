"""Roofline machine models + device calibration for achieved-vs-peak rows.

A :class:`MachineModel` is the three-number summary the roofline model
needs — peak FLOP/s, memory bandwidth, and a clock for the paper-style
estimated-cycles column.  Two canonical models ship:

* :data:`PAPER_MCU` — a single-issue in-order RV32 at 250 MHz with a
  4-byte/cycle memory port, the class of core the paper's cycle counts
  come from (Table IX: 26M cycles baseline, 5.5M accelerated), so the
  port's plans can be priced in the paper's units;
* :data:`H100` — the published dense rates of an NVIDIA H100 SXM at its
  full 700 W limit (the ``H100_*`` constants; ``chip_smoke.py`` takes its
  kernel bounds from them).  A card set below 700 W runs slower under
  load, so a measured time sits beside the card's power limit.
  ``H100_NVLINK_BW`` (NVLink 4, 450 GB/s a direction) and
  ``H100_HBM_BYTES`` (80 GB) serve the dry run (``launch.dryrun``).  A
  16 x 16 mesh of H100s spans 32 nodes of 8 cards, so most of its
  ``data`` axis crosses InfiniBand at about 50 GB/s a card: a collective
  term at the NVLink rate is an optimistic bound.

:func:`calibrate` measures the device instead of trusting a datasheet: an
f32 matmul for peak FLOP/s and a streaming element-wise pass for memory
bandwidth, best-of-``reps``.  :func:`roofline_terms` combines a machine
with the static cost model (:mod:`repro_torch.perf.cost`) to stamp a row
with ``achieved_pct_of_peak`` / ``achieved_pct_of_roof`` and a
compute-vs-memory-bound verdict.
"""

from __future__ import annotations

import dataclasses
import time

import torch

from repro_torch.device import resolve_device


@dataclasses.dataclass(frozen=True)
class MachineModel:
    """Peak envelope of one machine: the roofline's two ceilings + clock."""

    name: str
    peak_flops: float           # FLOP/s at the compute roof
    mem_bw: float               # bytes/s at the memory roof
    clock_hz: float = 1e9      # for the estimated-cycles column
    source: str = "datasheet"  # "datasheet" | "measured"

    @property
    def ridge(self) -> float:
        """Arithmetic intensity (flops/byte) where the roofs intersect."""
        return self.peak_flops / self.mem_bw if self.mem_bw else 0.0

    def attainable(self, intensity: float) -> float:
        """Roofline ceiling (FLOP/s) at the given arithmetic intensity."""
        return min(self.peak_flops, intensity * self.mem_bw)

    def verdict(self, intensity: float) -> str:
        return "compute-bound" if intensity >= self.ridge else "memory-bound"

    def time_s(self, flops: float, bytes_moved: float) -> float:
        """Roofline time bound: the slower of the compute and memory
        terms (perfect overlap of the two pipes)."""
        t = 0.0
        if self.peak_flops:
            t = flops / self.peak_flops
        if self.mem_bw:
            t = max(t, bytes_moved / self.mem_bw)
        return t

    def cycles(self, flops: float, bytes_moved: float) -> float:
        """Estimated clock cycles of (flops, bytes) on this machine —
        the unit of the paper's Table IX ledger."""
        return self.time_s(flops, bytes_moved) * self.clock_hz

    @property
    def id(self) -> str:
        """Short provenance identity for ledger entries."""
        return (f"{self.name}:{self.peak_flops:.3g}F/"
                f"{self.mem_bw:.3g}B@{self.clock_hz:.3g}Hz")

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


# The paper's deployment class: single-issue in-order RV32 (Ibex-like),
# 1 MAC-class op/cycle, a 32-bit memory port (4 B/cycle).  250 MHz is a
# nominal embedded clock — cycles, not seconds, are the comparable unit.
PAPER_MCU = MachineModel(name="rv32-mcu", peak_flops=250e6 * 1.0,
                         mem_bw=250e6 * 4.0, clock_hz=250e6)

# NVIDIA H100 SXM datasheet envelope (one card, dense, at 700 W).
H100_PEAK_FLOPS_FP32 = 67e12
H100_PEAK_FLOPS_TF32 = 494.7e12
H100_PEAK_FLOPS_BF16 = 989.4e12
H100_PEAK_OPS_INT8 = 1978.9e12
H100_HBM_BW = 3.35e12
H100_CLOCK_HZ = 1.98e9
# NVLink 4 on the H100 SXM: 18 links x 25 GB/s, bytes/s per direction (the
# dry run's collective term, the counterpart of the reference's ICI rate).
# A 16 x 16 mesh of H100s spans 32 nodes of 8 cards: most of its "data"
# axis crosses InfiniBand at about 50 GB/s a card, so a collective term at
# the NVLink rate is an optimistic bound.  One constant, as the reference
# keeps one.
H100_NVLINK_BW = 450e9
# the card's nominal device memory (80 GB), the dry run's fits-HBM line
H100_HBM_BYTES = 80e9
H100 = MachineModel(name="h100-sxm", peak_flops=H100_PEAK_FLOPS_BF16,
                    mem_bw=H100_HBM_BW, clock_hz=H100_CLOCK_HZ)


# -- device calibration -----------------------------------------------------

def _best_of(fn, reps: int, device: torch.device) -> float:
    """Best seconds of one ``fn()`` over ``reps`` runs, after a warm-up:
    CUDA events on the card, ``perf_counter`` on the CPU."""
    fn()
    best = float("inf")
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        for _ in range(reps):
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            stop.record()
            stop.synchronize()
            best = min(best, start.elapsed_time(stop) * 1e-3)
        return best
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        best = min(best, time.perf_counter() - t0)
    return best


def calibrate(n: int = 1024, stream_mb: int = 64, reps: int = 5,
              device=None) -> MachineModel:
    """Measure ``device``'s roofline envelope (``None`` is the card).

    * peak FLOP/s: an ``n×n @ n×n`` float32 matmul, TF32 off (the port
      runs every float product in full float32) → ``2n³ / best_time``;
    * memory bandwidth: ``x + 1`` over a ``stream_mb``-MB float32 array,
      past the card's L2 at the default size → ``(read + write) /
      best_time``.

    Best-of-``reps`` after a warm-up strips scheduler noise.  The result
    is the *measured attainable* peak, the honest roof for
    ``achieved_pct_of_roof``; a reading above the datasheet means the
    timing is wrong (``chip_smoke.py`` fails on it).
    """
    device = resolve_device(device)
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        with torch.no_grad():
            a = torch.ones((n, n), dtype=torch.float32, device=device)
            peak = 2.0 * n ** 3 / _best_of(lambda: a @ a, reps, device)
            m = stream_mb * (1 << 20) // 4
            x = torch.ones((m,), dtype=torch.float32, device=device)
            bw = 2.0 * 4.0 * m / _best_of(lambda: x + 1.0, reps, device)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    name = f"measured-cuda:{torch.cuda.get_device_name(device)}" \
        if device.type == "cuda" else f"measured-{device.type}"
    return MachineModel(name=name, peak_flops=peak, mem_bw=bw, clock_hz=1e9,
                        source="measured")


_CACHED: dict = {}


def host_machine(refresh: bool = False, device=None) -> MachineModel:
    """:func:`calibrate` cached per device — a sweep calibrates once and
    stamps every row with the same machine identity."""
    key = str(resolve_device(device))
    if refresh or key not in _CACHED:
        _CACHED[key] = calibrate(device=key)
    return _CACHED[key]


# -- row annotation ---------------------------------------------------------

def roofline_terms(flops: float, bytes_moved: float, measured_s: float,
                   machine: MachineModel) -> dict:
    """The columns a timed row carries: modelled cost, achieved
    throughput against the machine's roof at this program's arithmetic
    intensity, and the compute-vs-memory-bound verdict.

    ``achieved_pct_of_roof`` > 100% is meaningful, not an error: the
    cost model's traffic term counts every operand/result byte, but a
    cache-resident working set (KWT-Tiny's is a few KB) never pays the
    measured DRAM bandwidth, so the intensity-limited roof underprices
    the machine.  ``achieved_pct_of_peak`` is the unconditional
    achieved-vs-compute-peak fraction, the number to watch for "how far
    from as-fast-as-the-hardware-allows".
    """
    ai = flops / bytes_moved if bytes_moved else 0.0
    roof = machine.attainable(ai)
    achieved = flops / measured_s if measured_s > 0 else 0.0
    return {
        "flops": round(flops),
        "bytes_moved": round(bytes_moved),
        "arithmetic_intensity": round(ai, 4),
        "achieved_flops_per_s": round(achieved),
        "achieved_pct_of_roof": round(100.0 * achieved / roof, 2)
        if roof else 0.0,
        "achieved_pct_of_peak": round(100.0 * achieved
                                      / machine.peak_flops, 3)
        if machine.peak_flops else 0.0,
        "bound": machine.verdict(ai),
    }


def annotate_row(row: dict, cost, measured_s: float,
                 machine: MachineModel) -> dict:
    """Merge :func:`roofline_terms` for a CostReport into ``row``."""
    row.update(roofline_terms(cost.flops, cost.bytes, measured_s, machine))
    return row
