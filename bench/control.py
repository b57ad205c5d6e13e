"""Read a cell's compared numbers over many seeds, for the program or for
its control, in one process (set-up paid once for the imports and the
kernel build): the readings the limits in ``bench/workloads/*.json`` are
set from.  Not run by the benchmark's own runs.

    python3 bench/control.py --workload <cell> --seeds 1,2,3 \\
        [--control NAME] [--seconds S]

``--control NAME`` reads one of the workload file's ``controls`` (its
``control`` names the one the output limits are set against): ``plan``
overrides the program's plan (``int4``: the program's own int4 path),
``tf32: true`` switches on TF32 for float32 products once set-up is done
(the program's own TF32 path: torch's matmul setting).  One JSON line a
seed.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control", default=None)
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]

    from bench.core import precision, runner
    from bench.core.spec import Spec

    spec = Spec(ROOT)
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        ctx = runner.context(spec, args.workload, seed, args.device)
        switch = None
        if args.control:
            control = ctx.workload["controls"][args.control]
            ctx.plan = {**ctx.plan, **control.get("plan", {})}
            if control.get("tf32"):
                switch = lambda: precision.allow_tf32(True)  # noqa: E731
        res = runner.run(ctx, args.seconds, False, t0, after_setup=switch)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "control": args.control, "calls": res["attempted"],
                          "metrics": res["metrics"],
                          "checks": res["checks"],
                          "seconds": time.perf_counter() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
