"""CLI: python -m repro_torch.analysis check --config kwt_tiny --backend cuda

Runs the static-analysis pass pipeline over one compiled Engine plan and
exits nonzero when any pass reports a violation — the analysis gate.
``--mutate`` seeds a known violation (mutation testing: the gate must
FAIL on each one).  The plan is built on the card unless ``--device``
names another device; ``--backend cuda --device cpu`` plans the kernels'
plain versions (the records, and so the verdict, are the card's).
"""

from __future__ import annotations

import argparse
import sys

import torch

from repro_torch import analysis
from repro_torch.analysis import mutations


def _build_engine(config: str, backend: str, seed: int, device):
    from repro_torch import runtime
    from repro_torch.configs import registry
    from repro_torch.device import resolve_device

    cfg = registry.get(config.replace("_", "-")).config
    if cfg.family != "kwt":
        raise SystemExit(
            f"config {cfg.name!r}: the analysis CLI builds params for the "
            "kwt family; analyse other families via analysis.check_engine")
    from repro_torch.models import kwt
    device = resolve_device(device)
    params = kwt.init_params(cfg, torch.Generator().manual_seed(seed), device)
    return runtime.compile_model(
        cfg, params, backend=backend, device=device,
        plain_kernels=backend == "cuda" and device.type == "cpu")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.analysis")
    sub = ap.add_subparsers(dest="cmd", required=True)
    chk = sub.add_parser("check", help="run the pass pipeline on one plan")
    chk.add_argument("--config", default="kwt_tiny",
                     help="registry config name (kwt_tiny / kwt_1)")
    chk.add_argument("--backend", default="lut",
                     help="runtime backend (float / lut_float / lut / cuda)")
    chk.add_argument("--passes", default=",".join(analysis.PASSES),
                     help="comma-separated subset of "
                          f"{','.join(analysis.PASSES)}")
    chk.add_argument("--budget", type=int, default=None,
                     help="override the RAM gate in bytes (default: 64 kB "
                          "for the paper's deployment config)")
    chk.add_argument("--mutate", default="none",
                     choices=("none",) + mutations.MUTATIONS,
                     help="seed a known violation (checker self-test)")
    chk.add_argument("--strict", action="store_true",
                     help="full-integer gate: residency pass demands an "
                          "integer-executing plan with float_leak_count==0 "
                          "and no whole-tensor float weight views")
    chk.add_argument("--seed", type=int, default=0)
    chk.add_argument("--device", default=None,
                     help="torch device (default: the card)")
    args = ap.parse_args(argv)

    with mutations.apply(args.mutate):
        engine = _build_engine(args.config, args.backend, args.seed,
                               args.device)
        report = analysis.check_engine(
            engine, passes=tuple(args.passes.split(",")),
            budget=args.budget, strict=args.strict)
    print(report.render())
    if args.mutate != "none":
        print(f"[mutation {args.mutate!r} seeded: "
              f"{'CAUGHT' if not report.ok else 'MISSED'}]")
    return 0 if report.ok else 1


if __name__ == "__main__":
    sys.exit(main())
