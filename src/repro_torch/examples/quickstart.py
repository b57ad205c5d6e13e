"""Quickstart: the paper's full journey on KWT-Tiny, end to end.

1. Train KWT-Tiny (1646 params — Table IV) on the synthetic 2-class GSC
   surrogate ("dog"/"notdog", paper §III).
2. Post-training power-of-2 quantisation at the Table V best exponents
   (weights 2^6, inputs 2^5) — ``runtime.QuantRecipe`` on the float backend.
3. The "+Hardware" path: the selected ``--backend`` (default ``lut`` =
   Q8.24 LUT softmax + LUT GELU; ``cuda`` = the same pipeline as the
   hand-written CUDA kernels) via ``runtime.compile_model``.
Prints the Table IX accuracy staircase.

Run:  PYTHONPATH=src python -m repro_torch.examples.quickstart [--steps 300]
          [--backend lut|cuda|lut_float|float] [--eval-n 512] [--device cpu]
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
from repro_torch.models import kwt
from repro_torch.optim import adamw


def accuracy(eng, n=512):
    correct = total = 0
    for b in pipeline.gsc_eval_set(0, n=n, input_dim=eng.cfg.input_dim):
        pred = eng.forward(b["mfcc"]).argmax(-1).cpu()
        correct += int((pred == b["labels"]).sum())
        total += int(b["labels"].numel())
    return correct / total


def train(cfg, params, n_steps: int, device, log=print):
    """The eager loop of ``kwt.loss_fn`` + ``adamw.update`` from
    ``params`` over ``keyword_batch(0, i)`` (quickstart's and
    quantize_eval's); returns the trained tree."""
    hp = adamw.HParams(lr=3e-3, warmup_steps=20, total_steps=n_steps,
                       weight_decay=0.0)
    state = adamw.init(params, hp)
    for i in range(n_steps):
        batch = steps.to_device(pipeline.keyword_batch(
            0, i, batch=64, input_dim=cfg.input_dim,
            n_classes=cfg.n_classes), device)
        loss, grads = steps.value_and_grad(
            lambda p: kwt.loss_fn(p, batch, cfg), params)
        params, state, _ = adamw.update(grads, state, params, hp,
                                        scan_stacked=False)
        if i % 50 == 0:
            log(f"step {i:4d}  loss {float(loss):.4f}")
    return params


def report(cfg, params, backend: str, eval_n: int, device) -> dict:
    """Stages 1–3 of the staircase for trained ``params``: the float
    accuracy, PTQ on the float backend (and its packed ROM bytes), and
    ``backend``.  Returns the numbers it prints."""
    eng_f = plan(cfg, params, "float", device)
    acc = accuracy(eng_f, eval_n)
    print(f"\n[1] float32 accuracy:            {acc:.3f}")

    # stage 2: PTQ weights, still exact float ops (Table IX middle column)
    eng_q = plan(cfg, params, "float",
                 device, recipe=runtime.QuantRecipe.from_config(cfg))
    acc_q = accuracy(eng_q, eval_n)
    print(f"[2] int8 PTQ (w=2^6, Table V):   {acc_q:.3f}  "
          f"({eng_q.rom_bytes} packed int8 ROM bytes — paper: 1.65 kB "
          "incl. its int8 rank-1 params)")

    # stage 3: the accelerated path under the selected backend
    eng_h = plan(cfg, params, backend, device)
    acc_h = accuracy(eng_h, eval_n)
    print(f"[3] {eng_h.describe()}")
    print(f"    accuracy:                    {acc_h:.3f}  "
          "(paper Table IX: ~0.80 vs 0.872 float)")
    return {"float": acc, "ptq": acc_q, "backend": acc_h,
            "rom_bytes": eng_q.rom_bytes, "describe": eng_h.describe()}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--backend", default="lut",
                    choices=runtime.available_backends(),
                    help="stage-3 execution backend")
    ap.add_argument("--eval-n", type=int, default=512)
    add_device_arg(ap)
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    steps.no_tf32()

    cfg = registry.get("kwt-tiny").config
    print(f"KWT-Tiny: {cfg.n_layers} layer, DIM={cfg.d_model}, "
          f"MLP_DIM={cfg.d_ff}, SEQLEN={cfg.input_dim[1]+1}")
    params = kwt.init_params(cfg, torch.Generator().manual_seed(0), device)
    print(f"parameters: {kwt.count_params(params)} (paper Table IV: 1646)")
    params = train(cfg, params, args.steps, device)
    report(cfg, params, args.backend, args.eval_n, device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
