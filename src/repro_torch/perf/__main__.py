"""CLI: cost tables, device calibration, and the bench regression gate.

    python -m repro_torch.perf cost --arch kwt-tiny --backends cuda [--mcu]
    python -m repro_torch.perf cost --arch internlm2-1.8b --smoke \
        --backends lut cuda --device cpu
    python -m repro_torch.perf calibrate [--reps 5]
    python -m repro_torch.perf regress [--history BENCH_torch_history.jsonl]
    python -m repro_torch.perf regress --selftest

``cost`` and ``calibrate`` run on the card unless ``--device cpu`` is
given; on the CPU a ``cuda`` plan is priced through its plain versions
(``runtime.compile_model(..., plain_kernels=True)``), which the cost model prices as the
kernels.  ``regress`` exits non-zero on any gated regression.
``--selftest`` proves the gate can fail: it seeds a throwaway ledger with
a healthy baseline plus a 2× latency regression and a 1-byte ROM growth,
and exits 0 only if the gate (a) trips on both and (b) passes once the
regressions are removed.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile


def _cmd_cost(args) -> int:
    import torch

    from repro_torch import perf, runtime
    from repro_torch.configs import registry
    from repro_torch.device import resolve_device
    from repro_torch.launch import steps

    dev = resolve_device(args.device)
    entry = registry.get(args.arch)
    cfg = entry.smoke if args.smoke else entry.config
    params = steps.model_module(cfg).init_params(
        cfg, torch.Generator().manual_seed(0), dev)
    machine = perf.PAPER_MCU if args.mcu else perf.host_machine(device=dev)
    for backend in args.backends:
        eng = runtime.compile_model(cfg, params, backend=backend,
                                    device=dev,
                                    plain_kernels=dev.type == "cpu")
        rep = perf.engine_cost(eng, batch=args.batch)
        print(f"\n## {args.arch} · backend={backend} · batch={args.batch} "
              f"· device={dev} · machine={machine.name}")
        print(rep.table(machine))
        t = machine.time_s(rep.flops, rep.bytes)
        print(f"roofline bound: {machine.verdict(rep.intensity)} "
              f"(AI {rep.intensity:.2f} vs ridge {machine.ridge:.2f}), "
              f"est {machine.cycles(rep.flops, rep.bytes):.3g} cycles "
              f"({t * 1e6:.3f} us at {machine.clock_hz / 1e6:.0f} MHz)")
    return 0


def _cmd_calibrate(args) -> int:
    from repro_torch import perf

    m = perf.calibrate(reps=args.reps, device=args.device)
    print(json.dumps(m.to_dict(), indent=2))
    print(f"ridge point: {m.ridge:.2f} flops/byte", file=sys.stderr)
    return 0


def _selftest() -> int:
    """Seed a throwaway ledger; the gate must trip on a 2× latency and a
    ROM-bytes regression, and pass with the regressions removed."""
    from repro_torch import perf

    prov = {"git_commit": "selftest", "torch_version": "-", "device": "-",
            "timestamp": "-", "calibration": None}
    base = [perf.entry("kwt-tiny", "cuda", 64, 600.0 + i, "mean_us",
                       rom_bytes=1500, prov=prov) for i in range(3)]

    with tempfile.TemporaryDirectory() as td:
        bad = os.path.join(td, "bad.jsonl")
        perf.append(bad, base + [perf.entry(
            "kwt-tiny", "cuda", 64, 1200.0, "mean_us",
            rom_bytes=1501, prov=prov)])
        v_bad = perf.regress(bad)
        good = os.path.join(td, "good.jsonl")
        perf.append(good, base + [perf.entry(
            "kwt-tiny", "cuda", 64, 610.0, "mean_us",
            rom_bytes=1500, prov=prov)])
        v_good = perf.regress(good)

    ok = (len(v_bad.failures) == 2 and not v_bad.ok and v_good.ok)
    print(v_bad.summary())
    print(v_good.summary())
    print(f"selftest: gate {'trips and clears as required' if ok else 'BROKEN'}")
    return 0 if ok else 1


def _cmd_regress(args) -> int:
    from repro_torch import perf

    if args.selftest:
        return _selftest()
    v = perf.regress(args.history, tol=args.tol, window=args.window)
    print(v.summary())
    return 0 if v.ok else 1


def main(argv=None) -> int:
    from repro_torch.perf import ledger

    ap = argparse.ArgumentParser(prog="python -m repro_torch.perf")
    sub = ap.add_subparsers(dest="cmd", required=True)

    c = sub.add_parser("cost", help="static cost table of an Engine plan")
    c.add_argument("--arch", default="kwt-tiny")
    c.add_argument("--backends", nargs="+", default=["cuda"])
    c.add_argument("--batch", type=int, default=1)
    c.add_argument("--smoke", action="store_true",
                   help="use the arch's smoke config")
    c.add_argument("--mcu", action="store_true",
                   help="price on the paper's RV32 MCU model instead of "
                        "the device's calibrated envelope")
    c.add_argument("--device", default=None,
                   help="torch device (default: the card)")
    c.set_defaults(fn=_cmd_cost)

    c = sub.add_parser("calibrate", help="measure the device's roofline")
    c.add_argument("--reps", type=int, default=5)
    c.add_argument("--device", default=None,
                   help="torch device (default: the card)")
    c.set_defaults(fn=_cmd_calibrate)

    c = sub.add_parser("regress", help="gate newest bench entries against "
                                       "their rolling baselines")
    c.add_argument("--history", default=ledger.HISTORY_PATH)
    c.add_argument("--tol", type=float, default=ledger.DEFAULT_TOL)
    c.add_argument("--window", type=int, default=ledger.DEFAULT_WINDOW)
    c.add_argument("--selftest", action="store_true",
                   help="prove the gate trips on a seeded 2x regression")
    c.set_defaults(fn=_cmd_regress)

    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
