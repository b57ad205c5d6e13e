"""ServeCell: everything between a request and an Engine, on one host.

One cell owns:

* a swap-safe :class:`runtime.EngineHandle` (``cell.hotswap`` replaces
  the Engine under it without touching lane state),
* a pool of ``slots`` batch lanes — streaming-KWS lanes
  (:class:`StreamLanes`, the engine+detector hop); the reference's LM
  request lanes wait for the LM families (ROADMAP queue A item 3),
* an :class:`cell.admission.AdmissionController` in front of the lanes,
* the ``cell_*`` metric bundle on the run's telemetry registry,
* optionally a :class:`cell.hotswap.CheckpointWatcher` on a directory
  where training publishes packed artifacts,
* optionally a :class:`telemetry.FlightRecorder` fed by every hop.

Entering the cell (``with cell:``) activates the host mesh and the
``dist.ctx`` data-parallel context, which are no-ops on the port's one
device (ROADMAP queue A item 4 brings meshes).  ``launch/stream_serve.py``
is a thin CLI over this class.
"""

from __future__ import annotations

import contextlib
import time
from typing import Any, Optional

import torch

from repro_torch import runtime
from repro_torch import telemetry
from repro_torch.cell import admission as admission_mod
from repro_torch.cell import hotswap as hotswap_mod
from repro_torch.cell import pipeline as pipeline_mod
from repro_torch.dist import ctx
from repro_torch.launch import mesh as meshlib
from repro_torch.stream import detector as det
from repro_torch.stream import engine as stream_engine
from repro_torch.telemetry import flight as flight_mod
from repro_torch.telemetry.cell import make_cell_metrics


class ServeCell:
    """One host's serving cell: EngineHandle + lanes + admission + swap."""

    def __init__(self, engine, *, slots: int,
                 registry: Optional[telemetry.Registry] = None,
                 admission: Optional[admission_mod.AdmissionConfig] = None,
                 watch_dir: Optional[str] = None,
                 watch_like: Any = None,
                 probe: Any = None,
                 flight: Any = None,
                 mesh=None, poll_s: float = 0.5):
        self.handle = engine if isinstance(engine, runtime.EngineHandle) \
            else runtime.EngineHandle(engine)
        self.slots = slots
        self.metrics = make_cell_metrics(registry if registry is not None
                                         else telemetry.default_registry())
        self.admission = admission_mod.AdmissionController(
            admission or admission_mod.AdmissionConfig(),
            metrics=self.metrics)
        self.watcher = None
        self._watch_like, self._probe = watch_like, probe
        if watch_dir is not None:
            assert watch_like is not None and probe is not None, \
                "a watching cell needs a restore template and a probe batch"
            self.watcher = hotswap_mod.CheckpointWatcher(watch_dir,
                                                         poll_s=poll_s)
        self.mesh = meshlib.make_host_mesh() if mesh is None else mesh
        self.metrics.engine_generation.set(self.handle.generation)
        # black box: ``flight`` is a FlightRecorder, a FlightConfig, or
        # True for defaults; every lane hop feeds it (StreamLanes.hop)
        # and swap attempts re-check its triggers (maybe_swap).
        if flight is True:
            flight = flight_mod.FlightConfig()
        if isinstance(flight, flight_mod.FlightConfig):
            flight = flight_mod.FlightRecorder(self.metrics, flight)
        self.flight: Optional[flight_mod.FlightRecorder] = flight
        self._stack = None

    @property
    def engine(self) -> runtime.Engine:
        return self.handle.engine

    # -- mesh activation ---------------------------------------------------

    def __enter__(self) -> "ServeCell":
        assert self._stack is None, "cell already active"
        self._stack = contextlib.ExitStack()
        self._stack.enter_context(self.mesh)
        self._stack.enter_context(
            ctx.mesh_context(meshlib.dp_axes(self.mesh)))
        return self

    def __exit__(self, *exc) -> None:
        stack, self._stack = self._stack, None
        stack.close()

    # -- lane pools --------------------------------------------------------

    def stream_lanes(self, fcfg, dcfg, *, chunk_hops: int = 1,
                     keep_features: bool = False,
                     pipelined: bool = False,
                     feature_ingest: bool = False) -> "StreamLanes":
        return StreamLanes(self, fcfg, dcfg, chunk_hops=chunk_hops,
                           keep_features=keep_features, pipelined=pipelined,
                           feature_ingest=feature_ingest)

    def lm_scheduler(self, *, max_len: int, eos_id: Optional[int] = None,
                     prefill_len: Optional[int] = None):
        raise NotImplementedError(
            "ServeCell.lm_scheduler: LMScheduler (cell/scheduler.py) needs "
            "models.transformer, which waits for ROADMAP queue A item 3 (LM "
            "families)")

    # -- checkpoint hot-swap ----------------------------------------------

    def maybe_swap(self) -> bool:
        """One watch tick (call between hops): swap in a freshly published
        complete checkpoint, if any.  Never drops a lane — see
        ``cell.hotswap``."""
        if self.watcher is None:
            return False
        swapped = hotswap_mod.poll_and_swap(
            self.handle, self.watcher, self._watch_like, self._probe,
            metrics=self.metrics)
        if self.flight is not None:
            # a probe-parity failure bumps swap_failures; re-check the
            # triggers now instead of waiting for the next hop
            self.flight.check()
        return swapped


def _to_host(events: dict) -> dict:
    return {k: v.cpu().numpy() for k, v in events.items()}


class StreamLanes:
    """``slots`` hop-synchronous audio lanes under one cell.

    Owns the engine + detector state and the per-lane lifecycle:
    ``join(lane)`` zeroes BOTH the stream state and the detector state of
    the lane (a recycled lane must not inherit the previous stream's
    hysteresis/refractory/warm-up — stream.detector), ``hop(chunk)``
    advances every lane by ``chunk_hops`` hops through the engine+detector
    step, ``evict(lane)`` frees it.

    Modes: *joint* (default) runs the fused ``stream_step`` — through
    ``Engine.stream_step``, with its spans, while a tracer is active;
    *pipelined* runs the featurise/encode split of ``cell.pipeline``,
    featurise on a side CUDA stream and encode + detector on the current
    one (:meth:`run` overlaps featurise t+1 with encode t across a
    sequence of chunks); *feature ingest* takes pre-featurised frames
    [B, chunk_hops, F] instead of raw audio [B, chunk_samples] — the
    deployment where edge devices featurise next to the microphone.
    Frames produced by ``features.frontend_push`` yield bit-identical
    scores on either path, and every mode gives the joint mode's scores
    bit for bit (tests/test_torch_cell.py, chip_smoke.py).

    Hop accounting: ``cell_hops_total`` counts hops ingested per ACTIVE
    lane — the quantity a soak reconciles against the offered source hops
    to assert zero drops across churn and hot-swaps.
    """

    def __init__(self, cell: ServeCell, fcfg, dcfg, *, chunk_hops: int = 1,
                 keep_features: bool = False, pipelined: bool = False,
                 feature_ingest: bool = False):
        eng = cell.engine
        assert eng.exec_cfg.family == "kwt", \
            "stream lanes drive the KWT family"
        assert not (pipelined and feature_ingest), \
            "feature ingest has no featurise stage to pipeline"
        self.cell, self.fcfg, self.dcfg = cell, fcfg, dcfg
        self.chunk_hops = chunk_hops
        self.feature_ingest = feature_ingest
        self.device = eng.device
        self.active = [False] * cell.slots
        self.state = stream_engine.init_stream_state(
            eng.exec_cfg, fcfg, cell.slots, keep_features=keep_features,
            device=self.device)
        self.dstate = det.detector_init(dcfg, cell.slots, device=self.device)
        self._pipe = pipeline_mod.HopPipeline(
            cell.handle, fcfg, keep_features=keep_features) \
            if pipelined else None
        # The reference installs static stage weights for flight dumps from
        # its cost model (perf.stream_hop_cost); the port's cost model is
        # ROADMAP queue A item 2, so none is installed and the recorder
        # falls back as the reference's does when given none.

    @property
    def chunk_samples(self) -> int:
        return self.chunk_hops * self.fcfg.hop_len

    def set_chunk_hops(self, k: int) -> None:
        """Adopt the admission controller's degrade signal.  Lane state is
        hop-count agnostic (rings advance per frame), so the width can
        change between steps."""
        self.chunk_hops = int(k)

    @property
    def n_active(self) -> int:
        return sum(self.active)

    def free_lanes(self) -> list[int]:
        return [i for i, a in enumerate(self.active) if not a]

    def join(self, lane: int) -> None:
        """Claim a lane for a new stream: zero its ring/frontend/detector
        state so nothing leaks from the previous occupant."""
        assert not self.active[lane], f"lane {lane} is occupied"
        with torch.inference_mode():
            self.state = stream_engine.reset_lane(self.state, lane)
            self.dstate = det.detector_reset_lane(self.dstate, lane)
        self.active[lane] = True
        m = self.cell.metrics
        m.joins.inc()
        m.occupancy.set(self.n_active / len(self.active))

    def evict(self, lane: int) -> None:
        assert self.active[lane], f"lane {lane} is already free"
        self.active[lane] = False
        m = self.cell.metrics
        m.evictions.inc()
        m.occupancy.set(self.n_active / len(self.active))

    # -- the hop -----------------------------------------------------------

    def _encode_step(self, p, chunk):
        """(state, chunk) -> logits, advancing ``self.state``."""
        eng = self.cell.engine
        if self.feature_ingest:
            self.state, logits = stream_engine.stream_step_frames(
                p, self.state, torch.as_tensor(chunk).to(self.device),
                eng.exec_cfg)
        elif self._pipe is None:
            if telemetry.active_tracer() is not None:
                # the traced entry point: stream_step / hop spans
                self.state, logits = eng.stream_step(self.state, chunk,
                                                     self.fcfg)
            else:
                self.state, logits = stream_engine.stream_step(
                    p, self.state, torch.as_tensor(chunk).to(self.device),
                    eng.exec_cfg, self.fcfg)
        else:
            # one hop of the two-stream loop: featurise on the side stream,
            # encode on the current one
            self.state, logits = next(self._pipe.run(self.state, (chunk,)))
        return logits

    def _account(self, t0: float, ingest) -> None:
        m = self.cell.metrics
        dur_ms = 1e3 * (time.perf_counter() - t0)
        m.hop_ms.observe(dur_ms)
        m.hops.inc(int(sum(ingest)) if ingest is not None
                   else self.chunk_hops * self.n_active)
        if self.cell.flight is not None:
            self.cell.flight.record_hop(dur_ms)

    def hop(self, chunk, ingest=None) -> dict:
        """Advance all lanes by ``chunk`` — raw audio
        [slots, chunk_samples], or pre-featurised frames
        [slots, chunk_hops, F] under ``feature_ingest``; returns the
        detector events ``{"fired": [B], "score": [B], "hop": ()}`` as
        host numpy (the per-hop sync point).

        ``ingest`` ([slots] ints) overrides the per-lane hop accounting
        for steps whose trailing chunk is zero-padded past a stream's end;
        default: ``chunk_hops`` for every active lane."""
        t0 = time.perf_counter()
        p = self.cell.handle.live_params()
        with torch.inference_mode():
            logits = self._encode_step(p, chunk)
            self.dstate, events = det.detector_step(
                self.dstate, stream_engine.posteriors(logits), self.dcfg,
                warm=stream_engine.warm(self.state))
            events = _to_host(events)
        self._account(t0, ingest)
        return events

    def run(self, chunks, ingest=None):
        """Pipelined lanes over a sequence of chunks, with no join or evict
        in between: ``featurise`` of chunk t+1 runs on the side stream
        while ``encode`` and the detector of chunk t run on the current
        one (``HopPipeline.run``).  Yields each hop's events as :meth:`hop`
        returns them; a hop's latency is the wall time since the previous
        one's events.  Params are read once, at the start."""
        assert self._pipe is not None, "run() drives pipelined lanes"
        t0 = time.perf_counter()
        for state, logits in self._pipe.run(self.state, chunks):
            with torch.inference_mode():
                self.state = state
                self.dstate, events = det.detector_step(
                    self.dstate, stream_engine.posteriors(logits), self.dcfg,
                    warm=stream_engine.warm(state))
                events = _to_host(events)
            self._account(t0, ingest)
            t0 = time.perf_counter()
            yield events
