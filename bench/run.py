"""Run one cell of the benchmark once and print its result.

    python3 bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout that holds ``BENCHMARK.json``, ``bench/`` and
the port (``src/repro_torch``), on a machine with the cards the cell asks
for.  The last line of standard output is the result as one JSON object;
the numbers the check compared, each beside its limit, are the last
lines of standard error and the last key of that object.  Without the
cards, without the port, or with JAX or the JAX package loaded once the
window has closed, it prints no result and exits non-zero.

Kernel builds and caches stay inside the checkout (``build/``), so only a
checkout's first run builds.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's
    (compared whole: ``repro_torch`` is not ``repro``)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton")):
        os.environ[var] = str(ROOT / "build" / "bench" / sub)
    os.environ.setdefault("USE_FLAX", "0")
    if not (ROOT / "src" / "repro_torch").is_dir():
        print("bench: no src/repro_torch beside BENCHMARK.json; nothing to "
              "measure", file=sys.stderr)
        return 2
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]

    import torch

    from bench.core import runner
    from bench.core.spec import Spec

    spec = Spec(ROOT)
    chips = spec.cells[args.workload]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"bench: {args.workload} needs {chips} CUDA device(s); "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    ctx = runner.context(spec, args.workload, args.seed, "cuda")
    result = runner.run(ctx, args.seconds, bool(args.trace), T_START,
                        log=lambda line: print("bench:", line,
                                               file=sys.stderr))
    found = forbidden_modules()
    if found:
        print(f"bench: loaded in this process: {', '.join(found)}",
              file=sys.stderr)
        return 3
    for c in result["checks"]:
        print(f"check {c['name']} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
