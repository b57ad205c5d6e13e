"""End-to-end LM training with fault tolerance.

Default is a small run (the 2-layer reduced granite-8b family); the
~100M configuration (``--hundred-m``) takes the same code path as the
production launcher — checkpoint/restore, straggler monitor,
deterministic resume:

  # quick demo (2-layer reduced granite-8b family):
  PYTHONPATH=src python -m repro_torch.examples.train_lm --steps 30 \\
      [--device cpu]

  # ~100M-parameter run (12L x 768d, a few hundred steps):
  PYTHONPATH=src python -m repro_torch.examples.train_lm --hundred-m \\
      --steps 300 --ckpt-dir /tmp/lm100m
"""

from __future__ import annotations

import argparse
import dataclasses
import sys

from repro_torch.examples._common import add_device_arg
from repro_torch.launch import train


def hundred_m_config():
    """~110M params: 12L x 768d x 32k vocab (llama-family), the granite-8b
    family's config resized."""
    import repro_torch.configs.granite_8b as g
    return g.CONFIG.with_(n_layers=12, d_model=768, n_heads=12,
                          n_kv_heads=4, head_dim=64, d_ff=2048,
                          vocab_size=32000, dtype="float32", remat=False)


def launcher_argv(args) -> list:
    """The ``launch.train`` command line the twin runs."""
    argv = ["--arch", "granite-8b", "--smoke", "--steps", str(args.steps),
            "--global-batch", "8",
            "--seq-len", "256" if args.hundred_m else "64"]
    if args.ckpt_dir:
        argv += ["--ckpt-dir", args.ckpt_dir]
    if args.device is not None:
        argv += ["--device", args.device]
    return argv


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--hundred-m", action="store_true")
    ap.add_argument("--ckpt-dir", default=None)
    add_device_arg(ap)
    return ap


def main(argv=None) -> int:
    args = parser().parse_args(argv)
    argv = launcher_argv(args)
    if not args.hundred_m:
        train.main(argv)
        return 0
    # the registry reads the module's ENTRY at every call: the 110M config
    # stands in for the smoke config for this run only
    import repro_torch.configs.granite_8b as g
    entry = g.ENTRY
    g.ENTRY = dataclasses.replace(entry, smoke=hundred_m_config())
    try:
        train.main(argv)
    finally:
        g.ENTRY = entry
    return 0


if __name__ == "__main__":
    sys.exit(main())
