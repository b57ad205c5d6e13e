"""Streaming keyword spotting, end to end from the waveform.

1. Train KWT-Tiny from raw audio: synthetic chirp-keyword clips ->
   streaming MFCC frontend (repro_torch.stream.features) -> KWT (paper
   §III, with audio standing in for the GSC recordings).
2. Run the always-on path on a continuous stream: ring-buffer incremental
   inference (repro_torch.stream.engine) under a ``runtime.compile_model``
   engine (``--backend float|lut_float|lut|cuda``) + posterior
   smoothing / hysteresis triggering (repro_torch.stream.detector).
3. Print detected keyword events vs the ground-truth event intervals.

Run:  PYTHONPATH=src python -m repro_torch.examples.stream_kws
          [--train-steps 150] [--backend lut] [--device cpu]
Exits non-zero if the detector misses every keyword (CI smoke contract).
"""

from __future__ import annotations

import argparse
import sys

import torch

from repro_torch import runtime
from repro_torch.configs import registry
from repro_torch.data import pipeline
from repro_torch.device import resolve_device
from repro_torch.examples._common import add_device_arg, plan
from repro_torch.launch import steps
from repro_torch.launch.stream_serve import train_params
from repro_torch.stream import detector as det
from repro_torch.stream import engine
from repro_torch.stream import features


def report(cfg, fparams, backend: str, stream_hops: int, chunk_hops: int,
           seed: int, device) -> dict:
    """Serve one continuous stream through ``backend`` and the detector;
    returns ``{"rc", "fired", "scores", "truth", "hits"}``."""
    fcfg = features.FrontendConfig()
    dcfg = det.DetectorConfig()
    eng = plan(cfg, fparams, backend, device)
    print(eng.describe())

    audio, truth = pipeline.keyword_event_stream(
        seed + 1, 0, n_hops=stream_hops, hop_len=fcfg.hop_len)
    print(f"stream: {len(audio)/fcfg.sample_rate:.1f}s, "
          f"{len(truth)} keyword occurrences at hops {truth}")

    k = chunk_hops
    chunk_samples = k * fcfg.hop_len
    state = engine.init_stream_state(eng.exec_cfg, fcfg, 1, device=device)
    dstate = det.detector_init(dcfg, 1, device=device)
    fired, scores = [], []
    with torch.inference_mode():
        for h in range(0, stream_hops, k):
            chunk = torch.from_numpy(audio[None, h * fcfg.hop_len:
                                           h * fcfg.hop_len + chunk_samples])
            state, logits = eng.stream_step(state, chunk, fcfg)
            dstate, events = det.detector_step(
                dstate, engine.posteriors(logits), dcfg,
                warm=engine.warm(state))
            if bool(events["fired"][0]):
                hop = h + k
                score = float(events["score"][0])
                fired.append(hop)
                scores.append(score)
                print(f"[event] keyword @ {det.event_time_s(hop, fcfg):.2f}s "
                      f"(hop {hop}, score {score:.2f})")

    hits = sum(1 for (s, e) in truth
               if any(s <= f <= e + dcfg.smooth_hops for f in fired))
    print(f"detected {len(fired)} events; {hits}/{len(truth)} keywords hit")
    out = {"fired": fired, "scores": scores, "truth": truth, "hits": hits}
    if truth and hits == 0:
        print("FAIL: detector missed every keyword", file=sys.stderr)
        return {"rc": 1, **out}
    print("streaming demo complete.")
    return {"rc": 0, **out}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--train-steps", type=int, default=150)
    ap.add_argument("--stream-hops", type=int, default=400,
                    help="stream length (hops of 10ms)")
    ap.add_argument("--chunk-hops", type=int, default=2)
    ap.add_argument("--backend", default="float",
                    choices=runtime.available_backends())
    ap.add_argument("--seed", type=int, default=0)
    add_device_arg(ap)
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    steps.no_tf32()

    cfg = registry.get("kwt-tiny").config
    fcfg = features.FrontendConfig()
    t = engine.window_frames(cfg)
    print(f"KWT-Tiny streaming: window {t} frames = "
          f"{fcfg.receptive_field(t)/fcfg.sample_rate*1e3:.0f}ms, "
          f"hop {fcfg.hop_len/fcfg.sample_rate*1e3:.0f}ms")

    fparams = train_params(cfg, fcfg, args.train_steps, args.seed, device)
    return report(cfg, fparams, args.backend, args.stream_hops,
                  args.chunk_hops, args.seed, device)["rc"]


if __name__ == "__main__":
    sys.exit(main())
