"""repro_torch.analysis — static verification of the port's Engine plans.

The paper's headline claims are *static* properties — integer-resident
weights, overflow-free Q8.24 pipelines, a 64 kB RAM fit.  The reference
traces its programs to jaxprs; the port runs a plan's programs once under
the ATen op recorder with dataflow (:mod:`repro_torch.analysis.op_walk`,
also the cost model's walker), and four passes read the records:

  residency  - taint walk proving/refuting ``Backend.int_resident``
               (``analysis.residency``)
  ranges     - Q8.24 interval analysis flagging int32 overflow and
               ``fixed_mul`` precondition violations (``analysis.ranges``)
  budget     - ROM + LUT + peak-activation live-set vs the paper's
               64 kB target (``analysis.budget``)
  geometry   - each CUDA kernel launch's grid, threads and shared memory
               against the H100's limits (``analysis.geometry``)

CLI::

    python -m repro_torch.analysis check --config kwt_tiny --backend cuda

The checker is self-testing: ``analysis.mutations`` seeds a float leak /
a wrapping shift / an oversized LUT bank, and tests/test_torch_analysis.py
asserts each one flips the verdict to FAIL.
"""

from __future__ import annotations

import torch

from repro_torch.analysis.report import Finding, PassResult, Report  # noqa: F401
from repro_torch.device import resolve_device

PASSES = ("residency", "ranges", "budget", "geometry")


def example_input(cfg, batch: int = 1, device=None) -> torch.Tensor:
    """A representative input for tracing ``cfg``'s forward program, on
    ``device`` (``None`` is the card)."""
    device = resolve_device(device)
    if cfg.family == "kwt":
        f, t = cfg.input_dim
        return torch.zeros((batch, f, t), dtype=torch.float32, device=device)
    return torch.zeros((batch, 8), dtype=torch.int32, device=device)


def check_engine(engine, x=None, passes=PASSES,
                 budget: int | None = None, strict: bool = False) -> Report:
    """Run the pass pipeline over one Engine plan, on its device: the
    passes run the plan's programs, so a ``cuda`` plan on the card
    launches its kernels (and the launch counters count them).

    ``strict=True`` hardens the residency pass into the full-integer
    gate: the plan must be integer-executing with ``float_leak_count``
    zero and no whole-tensor float weight views (residency module
    docstring).

    Caches the one-line verdict on the Engine so ``describe()`` reports
    it (``Engine.describe(analyze=True)`` calls back into here).
    """
    from repro_torch.analysis import budget as budget_pass
    from repro_torch.analysis import geometry, ranges, residency

    if x is None:
        x = example_input(engine.exec_cfg, device=engine.device)
    results = []
    for name in passes:
        if name == "residency":
            results.append(residency.check_residency(engine, x,
                                                     strict=strict))
        elif name == "ranges":
            results.append(ranges.check_ranges(engine, x))
        elif name == "budget":
            results.append(budget_pass.check_budget(engine, x, budget))
        elif name == "geometry":
            results.append(geometry.check_geometry(engine, x))
        else:
            raise ValueError(f"unknown analysis pass {name!r}")
    report = Report(engine.describe(), results)
    engine._analysis_verdict = report.verdict()
    return report
