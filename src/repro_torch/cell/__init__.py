"""repro_torch.cell — the serving cell: everything between a request and
an Engine.

* :mod:`repro_torch.cell.scheduler` — continuous batching for LM lanes:
  per-lane decode depth, in-flight join via fresh prefill + per-lane
  state merge, per-slot EOS/evict, no drain barrier.
* :mod:`repro_torch.cell.admission` — bounded queues, token-bucket rate
  limiting, deadline shedding, and the cell-wide chunk-hops degrade
  stage, every decision a ``cell_admission_total`` counter.
* :mod:`repro_torch.cell.pipeline`  — the featurise/encode split of the
  streaming hop, double-buffered on two CUDA streams, bit-identical to
  the fused ``stream_step`` per backend.
* :mod:`repro_torch.cell.hotswap`   — checkpoint-watching hot-swap: load a
  freshly published packed artifact, warm it, gate it on probe-logit
  parity, install it atomically without dropping lanes.
* :mod:`repro_torch.cell.cell`      — :class:`ServeCell` composing the
  above; ``launch/stream_serve.py`` and ``launch/serve.py`` are thin CLIs
  over it.
"""

from repro_torch.cell.admission import (AdmissionConfig, AdmissionController,
                                        Decision)
from repro_torch.cell.cell import ServeCell, StreamLanes
from repro_torch.cell.hotswap import (CheckpointWatcher, SwapRejected,
                                      hot_swap, poll_and_swap)
from repro_torch.cell.pipeline import HopPipeline
from repro_torch.cell.scheduler import LMScheduler, Request, TokenEvent

__all__ = ["AdmissionConfig", "AdmissionController", "CheckpointWatcher",
           "Decision", "HopPipeline", "LMScheduler", "Request", "ServeCell",
           "StreamLanes", "SwapRejected", "TokenEvent", "hot_swap",
           "poll_and_swap"]
