"""repro_torch.analysis — program walks over the port's Engine plans.

Only what the cost model (:mod:`repro_torch.perf.cost`) needs is ported
so far: :func:`example_input` and the ATen op recorder
(:mod:`repro_torch.analysis.op_walk`, the twin of the reference's jaxpr
walker).  The reference's verification passes — residency, Q8.24 ranges,
the ROM/RAM budget, the mutation self-tests, the report and the CLI —
are ROADMAP queue A item 5, and will walk the same records.
"""

from __future__ import annotations

import torch

from repro_torch.device import resolve_device


def example_input(cfg, batch: int = 1, device=None) -> torch.Tensor:
    """A representative input for tracing ``cfg``'s forward program, on
    ``device`` (``None`` is the card)."""
    device = resolve_device(device)
    if cfg.family == "kwt":
        f, t = cfg.input_dim
        return torch.zeros((batch, f, t), dtype=torch.float32, device=device)
    return torch.zeros((batch, 8), dtype=torch.int32, device=device)
