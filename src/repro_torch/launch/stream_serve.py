"""Multi-stream streaming-KWS server: a thin CLI over ``repro_torch.cell``.

The lane pool, admission control, per-lane lifecycle, hop accounting and
checkpoint hot-swap all live in :class:`repro_torch.cell.ServeCell`; this
launcher only builds the Engine, synthesises stream sources, and feeds
chunks.  Every hop, one chunk per lane is packed into a single
``[B, k*hop]`` batch and pushed through the cell's engine+detector step;
finished streams free their lane, which is zeroed and refilled from the
admission queue — the step always runs at full batch, with no drain
barrier.

Execution policy is the serving flag of ``runtime.compile_model``:
``--backend float|lut_float|lut|cuda`` (``cuda``: the hand-written
kernels, on the card); streaming logits stay bit-identical to that
engine's offline forward of the window either way.  ``--device`` names
the device; without it the server runs on the card and raises where
there is none.

Overload behaviour (``repro_torch.cell.admission``): offered streams
beyond ``--max-queue`` (or past ``--deadline-ms`` of queue wait) are shed
BEFORE any audio is ingested; with ``--degrade-queue`` set, a backed-up
cell first degrades to ``--degrade-chunk-hops`` hops per engine step —
trading detection latency for throughput — and only then rejects.
``--watch-dir`` points the cell at a checkpoint directory for in-flight
hot-swap of freshly published artifacts.

Usage (CPU, reduced):
  PYTHONPATH=src python -m repro_torch.launch.stream_serve --device cpu \\
      --backend lut --streams 8 --slots 4 --hops 60 --telemetry-out /tmp/t.json
  python -m repro_torch.telemetry /tmp/t.json
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch import cell as cellmod
from repro_torch import runtime
from repro_torch import telemetry
from repro_torch.configs import registry
from repro_torch.data import pipeline
from repro_torch.device import resolve_device
from repro_torch.launch import serve_common
from repro_torch.models import kwt
from repro_torch.stream import detector as det
from repro_torch.stream import engine
from repro_torch.stream import features


def frontend_for(cfg) -> features.FrontendConfig:
    """The frontend that feeds ``cfg``: the default one, with as many MFCC
    coefficients as the model's input has rows."""
    return features.FrontendConfig(n_mfcc=cfg.input_dim[0])


def train_params(cfg, fcfg, n_steps: int, seed: int, device=None,
                 init=None):
    """Quick end-to-end float training from raw audio (waveform -> MFCC ->
    KWT) through ``steps.make_train_step``, so served detections are
    meaningful; ``n_steps=0`` returns random init.  The initial weights
    come from a ``torch.Generator`` seeded with ``seed`` (the reference's
    from ``jax.random``) unless ``init`` gives them (a tree on
    ``device``); the audio is the reference's
    (``data.pipeline.keyword_audio_batch``)."""
    device = resolve_device(device)
    params = init if init is not None else \
        kwt.init_params(cfg, torch.Generator().manual_seed(seed), device)
    if n_steps <= 0:
        return params
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.launch import steps
    from repro_torch.optim import adamw
    hp = adamw.HParams(lr=3e-3, warmup_steps=max(2, n_steps // 10),
                       total_steps=n_steps, weight_decay=0.0)
    opt = adamw.init(params, hp)
    n = engine.window_frames(cfg) * fcfg.hop_len
    shape = ShapeSpec("stream_train", engine.window_frames(cfg), 64, "train")
    step = steps.make_train_step(cfg, shape, hp, n_micro=1)

    log_every = max(1, n_steps // 8)
    for i in range(n_steps):
        raw = pipeline.keyword_audio_batch(seed, i, batch=64, n_samples=n)
        mfcc = features.mfcc(raw["audio"].to(device), fcfg)
        params, opt, m = step(params, opt, {"mfcc": mfcc,
                                            "labels": raw["labels"]})
        if (i + 1) % log_every == 0 or i + 1 == n_steps:
            telemetry.log("train_step", step=i + 1, of=n_steps,
                          loss=float(m["loss"]), lr=float(m["lr"]),
                          grad_norm=float(m["grad_norm"]))
    telemetry.log("train_done", steps=n_steps, loss=float(m["loss"]),
                  source="audio-derived MFCC")
    return params


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="kwt-tiny")
    ap.add_argument("--streams", type=int, default=8,
                    help="total streams to serve")
    ap.add_argument("--slots", type=int, default=4, help="batch lanes")
    ap.add_argument("--hops", type=int, default=120,
                    help="mean stream length in hops")
    ap.add_argument("--chunk-hops", type=int, default=1,
                    help="hops ingested per engine step")
    ap.add_argument("--backend", default="float",
                    choices=runtime.available_backends(),
                    help="execution backend (runtime.compile_model); "
                         "cuda runs the hand-written kernels on the card")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card; raises without "
                         "one); 'cpu' runs everything on the host")
    ap.add_argument("--train-steps", type=int, default=80,
                    help="0 = serve a randomly initialised model")
    ap.add_argument("--seed", type=int, default=0)
    # admission control (repro_torch.cell.admission); defaults admit all
    ap.add_argument("--max-queue", type=int, default=None,
                    help="bounded wait queue (default: --streams)")
    ap.add_argument("--deadline-ms", type=float, default=None,
                    help="shed streams that waited longer than this")
    ap.add_argument("--degrade-queue", type=int, default=0,
                    help=">0: degrade to --degrade-chunk-hops when the "
                         "queue is deeper than this")
    ap.add_argument("--degrade-chunk-hops", type=int, default=4)
    ap.add_argument("--watch-dir", default=None,
                    help="hot-swap checkpoints published here "
                         "(repro_torch.cell.hotswap)")
    serve_common.add_telemetry_args(ap)
    args = ap.parse_args(argv)
    backend = args.backend
    device = resolve_device(args.device)

    entry = registry.get(args.arch)
    base_cfg = entry.smoke
    assert base_cfg.family == "kwt", "streaming serve drives the KWT family"
    fcfg = frontend_for(base_cfg)
    dcfg = det.DetectorConfig()

    # training always runs the float path; the engine then owns PTQ + mode
    # selection for serving.
    fparams = train_params(base_cfg, fcfg, args.train_steps, args.seed,
                           device)
    eng = runtime.compile_model(base_cfg, fparams, backend=backend,
                                device=device)
    telemetry.log("engine", plan=eng.describe())

    B, k = args.slots, args.chunk_hops
    queue = list(range(args.streams))
    rng = np.random.RandomState(args.seed)
    sources = {}
    for sid in queue:
        # whole chunks, at least one (wide --chunk-hops must not floor to 0)
        hops = max(k, int(rng.randint(args.hops // 2, args.hops * 2))
                   // k * k)
        audio, events = pipeline.keyword_event_stream(
            args.seed, sid, n_hops=hops, hop_len=fcfg.hop_len)
        sources[sid] = {"audio": audio, "events": events, "hops": hops}

    adm = cellmod.AdmissionConfig(
        max_queue=args.max_queue if args.max_queue is not None
        else max(args.streams, 1),
        deadline_ms=args.deadline_ms,
        degrade_queue=args.degrade_queue if args.degrade_queue > 0
        else args.streams + 1,
        degraded_chunk_hops=max(args.degrade_chunk_hops, k))

    with serve_common.session(args.telemetry_out) as (tracer, met):
        # the hot-swap gate's probe: seeded MFCC-like values inside the
        # eq-9 input grid (|x| < 4 at the Table V exponent), where the
        # integer-executing plan and its float view must agree
        probe = np.random.RandomState(args.seed).normal(
            0, 0.5, (1,) + tuple(base_cfg.input_dim)).astype(np.float32) \
            if args.watch_dir else None
        cell = cellmod.ServeCell(
            eng, slots=B, registry=met, admission=adm,
            watch_dir=args.watch_dir,
            watch_like=eng.params if args.watch_dir else None,
            probe=probe)
        with cell:
            fired = _serve(cell, sources, queue, fcfg, dcfg, k, met)
    return fired


def _serve(cell, sources, queue, fcfg, dcfg, chunk_hops, met):
    """The serve loop proper: offer -> join -> hop -> evict, to drain."""
    lanes = cell.stream_lanes(fcfg, dcfg, chunk_hops=chunk_hops)
    B = cell.slots
    shed = []
    for sid in queue:
        if not cell.admission.offer(sid).admitted:
            shed.append(sid)
    n_to_serve = len(queue) - len(shed)

    events_ctr = met.counter("serve_detector_events_total",
                             "keyword detections fired")
    rtf = met.histogram("serve_stream_rtf", "per-stream real-time "
                        "factor (wall seconds / audio seconds; <1 is "
                        "faster than realtime)", unit="x")

    active = [None] * B          # stream id per lane
    offset = np.zeros(B, np.int64)
    started = np.zeros(B, np.float64)      # lane fill wall time
    fired, done = [], []
    eng = cell.engine
    t0 = time.time()
    while len(done) < n_to_serve:
        cell.maybe_swap()
        with telemetry.span("refill"):
            for lane in lanes.free_lanes():
                sid = cell.admission.pop()
                if sid is None:
                    break
                lanes.join(lane)
                active[lane] = sid
                offset[lane] = 0
                started[lane] = time.time()
        # overload degrade: a backed-up queue widens the chunk cell-wide
        lanes.set_chunk_hops(max(chunk_hops, cell.admission.chunk_hops()))
        cs = lanes.chunk_samples
        chunk = np.zeros((B, cs), np.float32)
        ingest = np.zeros(B, np.int64)
        with telemetry.span("pack"):
            for i in range(B):
                sid = active[i]
                if sid is None:
                    continue
                a = sources[sid]["audio"]
                end = sources[sid]["hops"] * fcfg.hop_len
                n = int(min(cs, end - offset[i]))
                chunk[i, :n] = a[offset[i]:offset[i] + n]
                offset[i] += n
                ingest[i] = n // fcfg.hop_len
        events = lanes.hop(chunk, ingest=ingest)   # records its own span
        with telemetry.span("events"):
            for i in range(B):
                sid = active[i]
                if sid is None:
                    continue
                if events["fired"][i]:
                    hop = int(offset[i] // fcfg.hop_len)
                    fired.append((sid, hop))
                    events_ctr.inc()
                    telemetry.log(
                        "detector_event", stream=sid,
                        t_s=det.event_time_s(hop, fcfg),
                        score=float(events["score"][i]),
                        backend=eng.backend_name)
                if offset[i] >= sources[sid]["hops"] * fcfg.hop_len:
                    done.append(sid)
                    lanes.evict(i)
                    active[i] = None
                    audio_s_i = sources[sid]["hops"] \
                        * fcfg.hop_len / fcfg.sample_rate
                    rtf.observe((time.time() - started[i]) / audio_s_i)
    dt = time.time() - t0
    served = [s for sid, s in sources.items() if sid in done]
    audio_s = sum(s["hops"] for s in served) * fcfg.hop_len / fcfg.sample_rate
    truth = sum(len(s["events"]) for s in served)
    telemetry.log("serve_done", streams=n_to_serve, shed=len(shed),
                  audio_s=audio_s, wall_s=dt, realtime_x=audio_s / dt,
                  fired=len(fired), keywords=truth,
                  ingested_hops=int(met.counter("cell_hops_total").value),
                  offered_hops=sum(s["hops"] for s in served),
                  backend=eng.backend_name,
                  **met.histogram("cell_hop_latency_ms").summary())
    return fired


if __name__ == "__main__":
    main()
