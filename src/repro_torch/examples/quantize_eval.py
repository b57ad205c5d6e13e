"""Table V reproduction CLI: sweep power-of-2 scale factors for any arch.

For KWT-Tiny this reproduces the paper's sweep; for the LM archs (their
reduced smoke configs) it demonstrates the technique is arch-generic:

  PYTHONPATH=src python -m repro_torch.examples.quantize_eval --arch kwt-tiny
  PYTHONPATH=src python -m repro_torch.examples.quantize_eval \\
      --arch internlm2-1.8b [--device cpu]
"""

from __future__ import annotations

import argparse
import sys

import torch

from repro_torch import runtime
from repro_torch.configs import registry
from repro_torch.core import calibrate
from repro_torch.data import pipeline
from repro_torch.device import resolve_device
from repro_torch.examples._common import add_device_arg, plan
from repro_torch.examples.quickstart import train
from repro_torch.launch import steps
from repro_torch.models import kwt
from repro_torch.models import transformer as T

PAIRS = [(3, 3), (4, 4), (5, 5), (6, 5), (6, 6)]   # Table V rows
LM_WEXPS = (3, 4, 5, 6, 7)


def report_kwt(cfg, params, device) -> list:
    """The Table V rows for trained ``params``; returns the sweep."""
    batches = [(b["mfcc"].to(device), b["labels"].to(device))
               for b in pipeline.gsc_eval_set(
                   0, n=512, input_dim=cfg.input_dim,
                   n_classes=cfg.n_classes)]
    res = calibrate.sweep_scale_factors(
        lambda p, x: kwt.forward(p, x, cfg), params, batches, pairs=PAIRS)
    print("weights, inputs, accuracy, int8 bytes   (paper Table V)")
    for r in res:
        print(f"2^{r.weight_exponent} ({2**r.weight_exponent:3d}), "
              f"2^{r.input_exponent} ({2**r.input_exponent:3d}), "
              f"{r.accuracy:.3f}, {r.quantized_bytes}")
    return res


def report_lm(name: str, cfg, params, device) -> dict:
    """Loss per weight exponent on the ``lut_float`` plan against the
    float loss (the engine's params, embed and head packed, fed to
    ``loss_fn`` under its ``exec_cfg``); returns the losses."""
    batch = steps.to_device(pipeline.lm_batch(
        0, 0, global_batch=4, seq_len=32, vocab_size=cfg.vocab_size), device)
    with torch.no_grad():
        ref_loss = float(T.loss_fn(params, batch, cfg))
    print(f"{name}: float loss {ref_loss:.4f}")
    out = {"float": ref_loss}
    for wexp in LM_WEXPS:
        eng = plan(cfg, params, "lut_float", device,
                   recipe=runtime.QuantRecipe.from_config(
                       cfg, weight_exponent=wexp))
        with torch.no_grad():
            l = float(T.loss_fn(eng.params, batch, eng.exec_cfg))
        out[wexp] = l
        print(f"  w=2^{wexp}: quantised+LUT loss {l:.4f} "
              f"(delta {l-ref_loss:+.4f})")
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="kwt-tiny")
    ap.add_argument("--steps", type=int, default=300)
    add_device_arg(ap)
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    steps.no_tf32()
    entry = registry.get(args.arch)

    if args.arch.startswith("kwt"):
        cfg = entry.config
        params = kwt.init_params(cfg, torch.Generator().manual_seed(0),
                                 device)
        report_kwt(cfg, train(cfg, params, args.steps, device,
                              log=lambda line: None), device)
        return 0

    # LM arch: perplexity degradation per weight exponent (reduced config)
    cfg = entry.smoke
    params = T.init_params(cfg, torch.Generator(device=device).manual_seed(0),
                           device)
    report_lm(args.arch, cfg, params, device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
