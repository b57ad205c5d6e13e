"""Model surgeon: the paper's §III iterative down-scaling methodology.

"Through an iterative approach, the layers with the least impact on
inference accuracy were removed.  These were found to be the depth
layers."  This tool scores each transformer block by the loss increase
when it is ablated (identity-bypassed) on a calibration set, and emits the
removal ranking that drives a KWT-1 -> KWT-Tiny style shrink.

  PYTHONPATH=src python -m repro_torch.tools.surgeon [--device cpu]

demos it on a 4-layer KWT-1; without ``--device`` it runs on the card and
raises where there is none.
"""

from __future__ import annotations

import argparse

import torch

from repro_torch.models import kwt


@torch.no_grad()
def ablation_scores(params, cfg, batches, loss_fn):
    """Loss increase per ablated block.  Returns ``(base, [(layer,
    delta_loss)])``, lowest impact first."""
    def mean_loss(p):
        return float(torch.stack([loss_fn(p, b, cfg) for b in batches]).mean())

    base = mean_loss(params)
    scores = []
    for i in range(len(params["blocks"])):
        bp = dict(params["blocks"][i])
        # identity-bypass: zero the block's output projections so the
        # residual stream passes through unchanged
        for key in ("attn", "mlp"):
            sub = dict(bp[key])
            out_w = "wo" if key == "attn" else ("w2" if "w2" in sub else "w_down")
            sub[out_w] = torch.zeros_like(sub[out_w])
            bp[key] = sub
        blocks = list(params["blocks"])
        blocks[i] = bp
        scores.append((i, mean_loss({**params, "blocks": blocks}) - base))
    return base, sorted(scores, key=lambda kv: kv[1])


def shrink_plan(scores, keep: int):
    """Blocks to delete (lowest impact first), paper §III style."""
    return [i for i, _ in scores[:len(scores) - keep]]


def shrink_params(params, scores, keep: int):
    """Apply a shrink plan: drop the ``len(blocks) - keep`` lowest-impact
    blocks and keep the survivors in their original order (residual-stream
    order matters).  The result is a valid parameter tree for
    ``cfg.with_(n_layers=keep)``."""
    drop = set(shrink_plan(scores, keep))
    blocks = [bp for i, bp in enumerate(params["blocks"]) if i not in drop]
    if len(blocks) != keep:
        raise ValueError(f"kept {len(blocks)} blocks, asked for {keep}")
    return {**params, "blocks": blocks}


def report(params, cfg, batches) -> list:
    """The demo's lines for ``params``: base loss, each block's ablation
    score, the removal order for a depth-1 target and the shrunk tree's
    size.  Returns the removal order."""
    base, scores = ablation_scores(params, cfg, batches, kwt.loss_fn)
    print(f"base loss {base:.4f}")
    for i, d in scores:
        print(f"block {i}: +{d:.5f} loss when ablated")
    order = shrink_plan(scores, keep=1)
    print("remove order for depth=1 target:", order)
    shrunk = shrink_params(params, scores, keep=1)
    print(f"shrunk tree: {len(shrunk['blocks'])} block(s), "
          f"{kwt.count_params(shrunk)} params (from {kwt.count_params(params)})")
    return order


def demo_batches(cfg, device) -> list:
    """The demo's calibration set: two keyword batches of 32."""
    from repro_torch.data import pipeline
    from repro_torch.launch import steps

    return [steps.to_device(pipeline.keyword_batch(
        0, i, batch=32, input_dim=cfg.input_dim, n_classes=cfg.n_classes),
        device) for i in range(2)]


def main(argv=None) -> int:
    from repro_torch.configs import registry
    from repro_torch.device import resolve_device

    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    cfg = registry.get("kwt-1").config.with_(n_layers=4)
    params = kwt.init_params(cfg, torch.Generator().manual_seed(0), device)
    report(params, cfg, demo_batches(cfg, device))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
