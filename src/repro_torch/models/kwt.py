"""The Keyword Transformer (paper §II-III): KWT-1 and KWT-Tiny.

ViT-style *post-norm* encoder over MFCC spectrogram patches (Fig 1):
  X [B, F, T] -> per-time-step patches [B, T, F] -> linear proj to d
  -> prepend class token -> + learned positional embeddings
  -> DEPTH transformer blocks (eq 1-6) -> class-token head (eq 8).

KWT-Tiny: INPUT_DIM [16,26], PATCH [16,1], DIM 12, DEPTH 1, HEADS 1,
MLP_DIM 24, DIM_HEAD 8, SEQLEN 27, 2 classes (Table III).  The attention
inner dim (HEADS*DIM_HEAD = 8) differs from DIM=12 — handled by
cfg.head_dim.  LayerNorm + GELU + biases everywhere, exactly the paper's
C library op set (Table VI).
"""

from __future__ import annotations

import torch

from repro_torch.core import quant
from repro_torch.core.rowwise import rowwise_matmul
from repro_torch.core.tree import tree_leaves
from repro_torch.device import resolve_device
from repro_torch.models import layers as L
from repro_torch.telemetry import taps as _health


def seqlen(cfg) -> int:
    return cfg.input_dim[1] + 1          # T time patches + class token


def init_params(cfg, generator: torch.Generator, device=None):
    """Random parameters in the reference's tree layout.  ``generator`` is
    a CPU ``torch.Generator``; its numbers differ from ``jax.random``'s, so
    parity tests carry weights across as numpy instead."""
    device = resolve_device(device)
    f, t = cfg.input_dim
    d = cfg.d_model
    dt = getattr(torch, cfg.dtype)

    def zeros(*shape):
        return torch.zeros(shape, dtype=dt, device=device)

    return {
        "proj_w": L.he(generator, (f, d), 1.0, dt, device),
        "proj_b": zeros(d),
        "cls": zeros(d),
        "pos": L.he(generator, (t + 1, d), 0.02, dt, device),
        "blocks": [
            {"ln1": L.norm_params(cfg, device=device),
             "ln2": L.norm_params(cfg, device=device),
             "attn": L.attention_params(cfg, generator, device),
             "mlp": L.mlp_params(cfg, generator, device=device)}
            for _ in range(cfg.n_layers)],
        "head_w": L.he(generator, (d, cfg.n_classes), 1.0, dt, device),
        "head_b": zeros(cfg.n_classes),
    }


def embed_frames(params, frames, cfg):
    """Patch-embed time-major frames [B, t, F] -> [B, t, d] (paper Fig 1,
    per-time-step [16, 1] patches).

    Factored out of :func:`forward` so a streaming engine can embed only
    newly arrived frames per hop.  The product contracts over F per frame;
    a float product is taken one frame at a time on the CPU
    (``core.rowwise``), so that a frame's embedding does not depend on
    which other frames share the batch.  The integer product is exact.
    """
    x = frames.to(getattr(torch, cfg.dtype))
    w, eq = params["proj_w"], "btf,fd->btd"
    if L.executes_int(w, eq, cfg):
        y = L.linear(x, w, eq, cfg)
    else:
        y = rowwise_matmul(x, L.asfloat(w))
    return y + params["proj_b"]


def encode_window(params, x, cfg):
    """Embedded window [B, T, d] -> logits [B, n_classes]: class token +
    positions + post-norm blocks + head (paper §II eqs 1-6, 8)."""
    b = x.shape[0]
    cls = params["cls"].expand(b, 1, cfg.d_model)
    # pos is a rank-2 leaf, so quantising recipes store it as a QTensor;
    # it is consumed additively, so integer-resident trees dequantise it
    # here (the same po2 de-scale a plan-time dequant would apply).
    x = torch.cat([cls, x], dim=1) + L.asfloat(params["pos"])
    _health.tap_activation("embed", x, cfg)
    for i, bp in enumerate(params["blocks"]):
        # post-norm residual blocks (paper §II eqs 1-6), full attention;
        # taps.scope names this block's health stats (block0/softmax ...)
        with _health.scope(f"block{i}"):
            a, _ = L.apply_attention(bp["attn"], x, cfg, causal=False)
            x = L.apply_norm(bp["ln1"], x + a, cfg)
            f = L.apply_mlp(bp["mlp"], x, cfg)
            x = L.apply_norm(bp["ln2"], x + f, cfg)
            _health.tap_activation("block_out", x, cfg)
    return (L.linear(x[:, 0], params["head_w"], "bd,dc->bc", cfg)
            + params["head_b"]).to(torch.float32)


def forward(params, mfcc, cfg):
    """mfcc [B, F, T] -> logits [B, n_classes]."""
    x = embed_frames(params, mfcc.transpose(1, 2), cfg)     # [B,T,d]
    return encode_window(params, x, cfg)


def loss_fn(params, batch, cfg):
    """Mean cross-entropy of the logits against ``batch["labels"]``:
    logsumexp less the gold logit, as the reference writes it."""
    logits = forward(params, batch["mfcc"], cfg)
    labels = batch["labels"]
    logz = torch.logsumexp(logits, dim=-1)
    gold = logits.gather(-1, labels[:, None])[:, 0]
    return (logz - gold).mean()


def accuracy(params, batch, cfg):
    logits = forward(params, batch["mfcc"], cfg)
    return (logits.argmax(-1) == batch["labels"]).to(torch.float32).mean()


def count_params(params) -> int:
    """Logical parameter count (a QTensor counts its unpacked elements)."""
    n = 0
    for leaf in tree_leaves(params):
        if isinstance(leaf, quant.QTensor):
            n += int(torch.Size(leaf.shape).numel())
        elif isinstance(leaf, torch.Tensor):
            n += leaf.numel()
    return n
