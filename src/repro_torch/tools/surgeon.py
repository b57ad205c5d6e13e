"""Model surgeon: the paper's §III iterative down-scaling methodology.

"Through an iterative approach, the layers with the least impact on
inference accuracy were removed.  These were found to be the depth
layers."  This tool scores each transformer block by the loss increase
when it is ablated (identity-bypassed) on a calibration set, and emits the
removal ranking that drives a KWT-1 -> KWT-Tiny style shrink.
"""

from __future__ import annotations

import torch


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
