"""repro_torch.perf — the performance-accounting layer of the port.

The paper's claim structure is a cost ledger (per-op cycles, 26M →
5.5M); this package gives every Engine plan the same treatment:

* :mod:`repro_torch.perf.cost` — static FLOPs / bytes-moved / arithmetic-
  intensity model over a plan's recorded ATen ops and kernel charges,
  attributed to named stages (unpack / featurise / embed / encode) and op
  classes (matmul / softmax / gelu / norm / fft / requant), with a
  paper-style estimated-cycles column;
* :mod:`repro_torch.perf.roofline` — machine models (the paper's RV32
  MCU, the H100 SXM datasheet, a *measured* calibration of the device)
  and the ``achieved_pct_of_roof`` / bound-verdict annotation of a timed
  row;
* :mod:`repro_torch.perf.ledger` — the append-only bench ledger with
  provenance, and the rolling-baseline regression gate behind
  ``python -m repro_torch.perf regress``.

The serve-side counterpart is :class:`repro_torch.telemetry.flight
.FlightRecorder`, which uses :func:`cost.stream_hop_cost` stage weights
to attribute anomalous hops post-mortem.
"""

from repro_torch.perf.cost import (CostLine, CostReport, engine_cost,
                                   program_cost, stream_hop_cost)
from repro_torch.perf.ledger import (HISTORY_PATH, Verdict, append, entry,
                                     git_commit, provenance, read, regress)
from repro_torch.perf.roofline import (H100, PAPER_MCU, MachineModel,
                                       annotate_row, calibrate, host_machine,
                                       roofline_terms)

__all__ = [
    "CostLine", "CostReport", "engine_cost", "program_cost",
    "stream_hop_cost",
    "MachineModel", "PAPER_MCU", "H100", "calibrate", "host_machine",
    "annotate_row", "roofline_terms",
    "HISTORY_PATH", "Verdict", "append", "entry", "git_commit",
    "provenance", "read", "regress",
]
