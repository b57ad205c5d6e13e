"""Batched serving of a small LM with continuous batching and the paper's
quantised+LUT path — compares float vs quantised throughput and outputs.

  PYTHONPATH=src python -m repro_torch.examples.serve_batched \\
      [--arch internlm2-1.8b] [--device cpu]
"""

from __future__ import annotations

import argparse
import sys

from repro_torch.examples._common import add_device_arg
from repro_torch.launch import serve


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="internlm2-1.8b")
    add_device_arg(ap)
    args = ap.parse_args(argv)
    base = ["--arch", args.arch, "--smoke", "--requests", "8",
            "--slots", "4", "--max-len", "48"]
    if args.device is not None:
        base += ["--device", args.device]
    print("== float path ==")
    serve.main(base)
    print("== quantised + LUT path (paper §IV+§VI) ==")
    serve.main(base + ["--backend", "lut_float"])
    return 0


if __name__ == "__main__":
    sys.exit(main())
