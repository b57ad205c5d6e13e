"""Plain reference of the Keyword Transformer (Berg et al., arXiv:2104.00769;
KWT-Tiny, arXiv:2407.16026) as the configuration files state it.

Post-norm ViT encoder over MFCC frames: per-frame patch embedding,
class token, learned positions, ``n_layers`` blocks of single-head
attention and a GELU MLP, each followed by LayerNorm, and a linear head
on the class token.  The numerics are the paper's: weights cast once by
eq 9 (``numerics.ptq``), every linear integer-executing on an eq-9 cast
of its input with the INT16 clip, the Q8.24 LUT softmax on the attention
rows, the LUT GELU; LayerNorm, the score and P.V products in float32.

``prepare`` re-derives the cast weights from the float tree the harness
drew; the float32 products run with TF32 off.
"""

from __future__ import annotations

import torch

from bench.ref import numerics as nx

LINEARS = ("proj_w", "pos", "head_w")
BLOCK_LINEARS = (("attn", "wq"), ("attn", "wk"), ("attn", "wv"),
                 ("attn", "wo"), ("mlp", "w1"), ("mlp", "w2"))


def prepare(tree: dict, model: dict, quant: dict) -> dict:
    """The weights as the configuration deploys them: every leaf of rank
    two cast by eq 9 (grid and per-channel exponents kept for the integer
    products), vectors as they are."""
    e, bits, pc = quant["weight_exponent"], quant["bits"], quant["per_channel"]

    def cast(w):
        q, ex, fv = nx.ptq(w, e, bits, pc)
        return {"q": q, "e": ex, "f": fv}

    out = {k: cast(tree[k]) for k in LINEARS}
    out.update(proj_b=tree["proj_b"].float(), cls=tree["cls"].float(),
               head_b=tree["head_b"].float())
    out["blocks"] = []
    for bp in tree["blocks"]:
        nb = {"ln1": bp["ln1"], "ln2": bp["ln2"],
              "b": {k: bp[g][k].float() for g, k in
                    (("attn", "bq"), ("attn", "bk"), ("attn", "bv"),
                     ("attn", "bo"), ("mlp", "b1"), ("mlp", "b2"))}}
        for g, k in BLOCK_LINEARS:
            nb[k] = cast(bp[g][k])
        out["blocks"].append(nb)
    return out


def _ln(x, p, eps=1e-6):
    mu = x.mean(-1, keepdim=True)
    var = ((x - mu) ** 2).mean(-1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + eps) * p["scale"] + p["bias"]


def _lin(x, w, x_exp):
    return nx.int_linear(x, w["q"], w["e"], x_exp)


def embed(w: dict, frames: torch.Tensor, x_exp: int) -> torch.Tensor:
    """Time-major MFCC frames [B, t, F] -> patch embeddings [B, t, d]."""
    return _lin(frames.float(), w["proj_w"], x_exp) + w["proj_b"]


def encode(w: dict, emb: torch.Tensor, model: dict, x_exp: int
           ) -> torch.Tensor:
    """Embedded window [B, T, d] -> logits [B, n_classes]."""
    b = emb.shape[0]
    dh = model["head_dim"]
    x = torch.cat([w["cls"].expand(b, 1, -1), emb], 1) + w["pos"]["f"]
    for bp in w["blocks"]:
        bb = bp["b"]
        q = _lin(x, bp["wq"], x_exp) + bb["bq"]
        k = _lin(x, bp["wk"], x_exp) + bb["bk"]
        v = _lin(x, bp["wv"], x_exp) + bb["bv"]
        s = torch.matmul(q, k.transpose(1, 2)) * dh ** -0.5
        p = nx.softmax_q24(s)
        a = torch.matmul(p, v)
        a = _lin(a, bp["wo"], x_exp) + bb["bo"]
        x = _ln(x + a, bp["ln1"])
        h = nx.gelu_lut(_lin(x, bp["w1"], x_exp) + bb["b1"])
        f = _lin(h, bp["w2"], x_exp) + bb["b2"]
        x = _ln(x + f, bp["ln2"])
    return _lin(x[:, 0], w["head_w"], x_exp) + w["head_b"]


def forward(w: dict, mfcc: torch.Tensor, model: dict, x_exp: int
            ) -> torch.Tensor:
    """MFCC windows [B, F, T] -> logits [B, n_classes]."""
    return encode(w, embed(w, mfcc.transpose(1, 2), x_exp), model, x_exp)


def forward_blocks(w: dict, mfcc: torch.Tensor, model: dict, x_exp: int,
                   rows: int) -> torch.Tensor:
    """:func:`forward` over ``rows`` windows at a time."""
    return torch.cat([forward(w, mfcc[i:i + rows], model, x_exp)
                      for i in range(0, mfcc.shape[0], rows)])
