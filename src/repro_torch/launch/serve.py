"""Batched LM serving launcher: a thin CLI over ``repro_torch.cell``.

Continuous batching (``cell.scheduler.LMScheduler``): a fixed pool of
batch slots where new requests prefill into free lanes while resident
lanes keep decoding — per-lane decode depths, per-slot EOS/evict, no
drain barrier.

Execution policy is one flag: ``--backend float|lut_float|lut|cuda``
resolves through ``runtime.compile_model`` to an Engine that owns the
paper's pipeline end to end (power-of-2 PTQ weights + LUT softmax /
activations for the quantising backends; on ``cuda`` the hand-written
kernels: the LUT softmax in every layer — and in every moe router — and
the int8 matmul for the packed head).  ``--arch`` takes the dense and the
moe configs (granite-moe-3b-a800m, deepseek-moe-16b).  Weights are
random, drawn from ``--seed`` on the device (full width on the card:
about 1.9 B parameters for internlm2-1.8b, 3.9 B for granite-moe-3b-a800m).

``--device`` defaults to the card and raises where there is none.  With
``--device cpu`` a ``cuda`` plan runs its kernels' plain versions
(``compile_model(plain_kernels=True)``): the kernel plan's rehearsal on
the host.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.serve --arch internlm2-1.8b \\
      --smoke --device cpu --backend cuda --requests 4 --max-len 32
  PYTHONPATH=src python -m repro_torch.launch.serve --arch internlm2-1.8b \\
      --backend cuda --requests 8 --slots 4 --max-len 256      # the card
  PYTHONPATH=src python -m repro_torch.launch.serve \\
      --arch granite-moe-3b-a800m --backend cuda --requests 8 --slots 4 \\
      --max-len 256                                            # the card
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
from repro_torch.device import resolve_device
from repro_torch.launch import serve_common
from repro_torch.launch import steps


def build_engine(cfg, backend: str, seed: int, device, *,
                 attention: str | None = None):
    """Seeded random weights for ``cfg`` drawn on ``device``, planned under
    ``backend``; the float tree is not kept beside the plan."""
    device = resolve_device(device)
    mod = steps.model_module(cfg)
    params = mod.init_params(
        cfg, torch.Generator(device=device).manual_seed(seed), device)
    return runtime.compile_model(cfg, params, backend=backend,
                                 attention=attention, device=device,
                                 plain_kernels=device.type == "cpu")


def make_requests(cfg, n: int, max_len: int, seed: int) -> list:
    """The reference's request mix: prompts of 4 .. max_len/4 tokens,
    budgets of 4 .. max_len/2 tokens, from a numpy seed."""
    rng = np.random.RandomState(seed)
    return [{"id": i,
             "prompt": rng.randint(0, cfg.vocab_size,
                                   size=rng.randint(4, max_len // 4)),
             "gen": int(rng.randint(4, max_len // 2))}
            for i in range(n)]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="internlm2-1.8b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-len", type=int, default=64)
    ap.add_argument("--backend", default="float",
                    choices=runtime.available_backends(),
                    help="execution backend (runtime.compile_model); cuda "
                         "runs the hand-written kernels on the card")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card; raises without "
                         "one); 'cpu' runs everything on the host, a cuda "
                         "plan through its kernels' plain versions")
    ap.add_argument("--eos-id", type=int, default=None,
                    help="evict a lane early when it emits this token")
    ap.add_argument("--seed", type=int, default=0)
    serve_common.add_telemetry_args(ap)
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    entry = registry.get(args.arch)
    cfg = entry.smoke if args.smoke else entry.config
    if cfg.family == "encdec":
        # as the reference's launcher refuses it: the family runs at
        # module level only (ROADMAP C11)
        raise ValueError(
            f"launch.serve does not serve the encdec family ({args.arch}): "
            "drive repro_torch.models.encdec (prefill, decode_step) with "
            "float params and the plan's exec_cfg (ROADMAP C11)")
    requests = make_requests(cfg, args.requests, args.max_len, args.seed)

    with serve_common.session(args.telemetry_out) as (tracer, met):
        eng = build_engine(cfg, args.backend, args.seed, device)
        telemetry.log("engine", plan=eng.describe())
        cell = cellmod.ServeCell(eng, slots=args.slots, registry=met)
        with cell:
            sched = cell.lm_scheduler(max_len=args.max_len,
                                      eos_id=args.eos_id)
            for r in requests:
                sched.submit(r["id"], r["prompt"], r["gen"])
            t0 = time.perf_counter()
            out = sched.run()
            if device.type == "cuda":
                torch.cuda.synchronize(device)
        dt = time.perf_counter() - t0
        decoded = sum(len(v) for v in out.values())
        telemetry.log("serve_done", requests=args.requests, tokens=decoded,
                      wall_s=dt, tok_s=decoded / dt,
                      backend=eng.backend_name,
                      **met.histogram("cell_decode_latency_ms").summary())
    return out


if __name__ == "__main__":
    main()
