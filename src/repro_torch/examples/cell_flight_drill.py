"""Flight-recorder drill: inject a deadline-shed spike, demand a dump.

The observability counterpart of ``cell_soak``: instead of proving the
cell serves correctly under churn, this drill proves the black box
notices when it doesn't.  It runs a :class:`repro_torch.cell.ServeCell`
with a :class:`repro_torch.telemetry.FlightRecorder` riding along, drives
healthy traffic, then *injects an incident* — a burst of offered streams
whose queue wait blows a tight admission deadline, so the controller
sheds them in a spike — and asserts the recorder:

1. dumped exactly one post-mortem (one incident -> one artifact, the
   armed/tripped edge, not one dump per hop),
2. with ``reason == "shed_spike"`` and the window's rejected-counter
   delta visible in the artifact,
3. whose stage attribution names a real stage of this hop program
   (featurise/embed/encode — static cost-model weights here, since
   cell hops are untraced in production),
4. and that the ring holds the last hops as a readable trace.

Exits non-zero if any of that fails.

Usage:  PYTHONPATH=src python -m repro_torch.examples.cell_flight_drill
            [--hops 24] [--backend lut|cuda] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from repro_torch import cell as cellmod
from repro_torch import telemetry
from repro_torch.configs import registry
from repro_torch.device import resolve_device
from repro_torch.examples._common import add_device_arg, plan
from repro_torch.launch import steps
from repro_torch.models import kwt
from repro_torch.stream import detector as det
from repro_torch.stream import features

SLOTS = 4
SPIKE = 6          # streams shed in the injected incident
DEADLINE_MS = 5.0  # admission queue-wait budget (tight, so the drill
                   # sheds in milliseconds instead of serving minutes)
INCIDENT_HOPS = 4  # hops after the spike that land it in the window


def drill(cfg, params, backend: str, hops: int, dump_dir: str,
          device) -> dict:
    """The drill on ``params``: healthy hops, the shed spike, the checks.
    Returns ``{"rc", "failures", "dumps", "artifact"}``."""
    eng = plan(cfg, params, backend, device)
    fcfg = features.FrontendConfig()
    dcfg = det.DetectorConfig()

    cell = cellmod.ServeCell(
        eng, slots=SLOTS, registry=telemetry.Registry(),
        admission=cellmod.AdmissionConfig(deadline_ms=DEADLINE_MS),
        flight=telemetry.FlightConfig(capacity=64, shed_spike=SPIKE,
                                      dump_dir=dump_dir))
    rng = np.random.RandomState(0)
    failures = []

    def check(ok, msg):
        print(("ok  " if ok else "FAIL") + f" {msg}")
        if not ok:
            failures.append(msg)

    with cell:
        lanes = cell.stream_lanes(fcfg, dcfg)
        # healthy phase: admit through the front door, serve every lane
        for lane in range(SLOTS):
            assert cell.admission.offer(f"s{lane}").admitted
            assert cell.admission.pop() is not None
            lanes.join(lane)
        chunk = 0.1 * rng.randn(SLOTS, fcfg.hop_len).astype(np.float32)
        for _ in range(hops):
            lanes.hop(chunk)
        check(not cell.flight.dumps,
              f"healthy phase: {hops} hops, no dump")

        # the incident: a burst arrives while every lane is busy; the
        # queue waits blow the deadline and pop() sheds the whole burst
        for i in range(SPIKE):
            cell.admission.offer(f"burst{i}")
        time.sleep(3 * DEADLINE_MS / 1e3)
        while cell.admission.pop() is not None:
            pass                      # nothing survives the deadline
        shed = int(cell.metrics.rejected.value)
        check(shed >= SPIKE, f"injected spike: {shed} streams shed")

        # the next hop lands the spike inside the recorder's window
        for _ in range(INCIDENT_HOPS):
            lanes.hop(chunk)

    fr = cell.flight
    art = None
    check(len(fr.dumps) == 1,
          f"one incident -> one dump (got {len(fr.dumps)})")
    if fr.dumps:
        with open(fr.dumps[0]) as f:
            art = json.load(f)
        att = art["attribution"]
        check(art["reason"] == "shed_spike",
              f"dump reason: {art['reason']}")
        check(art["admission"]["rejected_in_window"] >= SPIKE,
              f"window shed delta: {art['admission']['rejected_in_window']}")
        check(att["slowest_stage"] in ("featurise", "embed", "encode",
                                       "unpack"),
              f"slow hops attributed to stage {att['slowest_stage']!r} "
              f"({att['method']}: {att['stage_ms']})")
        check(art["window_hops"] > 0 and len(art["trace"])
              == art["window_hops"],
              f"trace holds the last {art['window_hops']} hops")
        check("git_commit" in art["provenance"],
              f"provenance: {art['provenance']['git_commit']}")
        print(f"post-mortem: {fr.dumps[0]}")

    out = {"failures": failures, "dumps": list(fr.dumps), "artifact": art}
    if failures:
        print(f"\nFLIGHT DRILL FAILED ({len(failures)}):", file=sys.stderr)
        for m in failures:
            print(f"  - {m}", file=sys.stderr)
        return {"rc": 1, **out}
    print("\nflight drill passed: shed spike detected, dumped once, "
          "attributed to a named stage.")
    return {"rc": 0, **out}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--hops", type=int, default=24,
                    help="healthy hops before and after the incident")
    ap.add_argument("--backend", default="lut")
    ap.add_argument("--dump-dir", default="flight_dumps")
    add_device_arg(ap)
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    steps.no_tf32()

    cfg = registry.get("kwt-tiny").smoke
    params = kwt.init_params(cfg, torch.Generator().manual_seed(0), device)
    return drill(cfg, params, args.backend, args.hops, args.dump_dir,
                 device)["rc"]


if __name__ == "__main__":
    sys.exit(main())
