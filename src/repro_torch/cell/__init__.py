"""repro_torch.cell — the serving cell: everything between a request and
an Engine.

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
  above; ``launch/stream_serve.py`` is a thin CLI over it.

The reference's LM lanes (``cell/scheduler.py``: ``LMScheduler``,
continuous batching of decode requests) need ``models.transformer`` and
wait for ROADMAP queue A item 3; ``ServeCell.lm_scheduler`` raises.
"""

from repro_torch.cell.admission import (AdmissionConfig, AdmissionController,
                                        Decision)
from repro_torch.cell.cell import ServeCell, StreamLanes
from repro_torch.cell.hotswap import (CheckpointWatcher, SwapRejected,
                                      hot_swap, poll_and_swap)
from repro_torch.cell.pipeline import HopPipeline

__all__ = ["AdmissionConfig", "AdmissionController", "CheckpointWatcher",
           "Decision", "HopPipeline", "ServeCell", "StreamLanes",
           "SwapRejected", "hot_swap", "poll_and_swap"]
