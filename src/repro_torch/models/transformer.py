"""Decoder-only LM assembly for the KV-cache families: dense (granite-8b,
internlm2, qwen2.5, nemotron, chameleon) and moe (granite-moe,
deepseek-moe) — embedding, the layer stack, the LM head and the prefill /
decode state machine.  Block math lives in ``layers.py`` and ``moe.py``;
a moe block is a dense one with ``moe.apply_moe`` (block key ``"moe"``)
in place of the MLP.

The reference scans its stacked layers (``lax.scan``); here the stack is
a Python loop over the same stacked leaves (``blocks``: every leaf
``[n_layers, ...]``), each layer a view ``leaf[i]``.

Decode state: ``{"layers": {"k": [L,B,S,KV,Dh], "v": ...}, "index": i}``
with ``index`` an int (every lane at one depth) or a per-lane ``[B]``
tensor (the ``cell.scheduler`` continuous-batching path).  ``prefill``
and ``decode_step`` write the new keys and values into the state's
caches in place and return the state with its index advanced; the
reference returns new caches instead.  ``merge_decode_state`` builds new
tensors, so a caller that merges never aliases the states it merges.

The rwkv and hybrid families wait for ROADMAP queue A item 3 and raise.
"""

from __future__ import annotations

import torch

from repro_torch.core import quant
from repro_torch.core.tree import tree_leaves, tree_map
from repro_torch.device import resolve_device
from repro_torch.models import layers as L
from repro_torch.models import moe as M

KV_FAMILIES = ("dense", "moe")


def _kv_family(cfg):
    if cfg.family not in KV_FAMILIES:
        raise NotImplementedError(
            f"family={cfg.family!r} is not ported yet: it waits for ROADMAP "
            f"queue A item 3 ({cfg.family})")


# ---------------------------------------------------------------------------
# Params
# ---------------------------------------------------------------------------

def block_params(cfg, generator, device="cpu"):
    _kv_family(cfg)
    p = {"ln1": L.norm_params(cfg, device=device),
         "ln2": L.norm_params(cfg, device=device),
         "attn": L.attention_params(cfg, generator, device)}
    if cfg.family == "moe":
        p["moe"] = M.moe_params(cfg, generator, device)
    else:
        p["mlp"] = L.mlp_params(cfg, generator, device=device)
    return p


def init_params(cfg, generator: torch.Generator, device=None):
    """Random parameters in the reference's tree layout: ``embed``
    ``[padded_vocab, d]``, ``blocks`` stacked ``[n_layers, ...]``,
    ``ln_f`` and the untied ``lm_head`` ``[d, padded_vocab]``.  Drawn from
    ``generator`` on its own device (a CUDA generator draws full-width
    weights on the card); the numbers differ from ``jax.random``'s, so
    parity tests carry weights across as numpy instead."""
    _kv_family(cfg)
    device = resolve_device(device)
    dt = getattr(torch, cfg.dtype)
    embed = L.he(generator, (cfg.padded_vocab, cfg.d_model), 1.0, dt, device)
    layers = [block_params(cfg, generator, device) for _ in range(cfg.n_layers)]
    blocks = tree_map(lambda *xs: torch.stack(xs), layers[0], *layers[1:])
    del layers
    p = {"embed": embed, "blocks": blocks,
         "ln_f": L.norm_params(cfg, device=device)}
    if not cfg.tie_embeddings:
        p["lm_head"] = L.he(generator, (cfg.d_model, cfg.padded_vocab), 1.0,
                            dt, device)
    return p


# ---------------------------------------------------------------------------
# Blocks
# ---------------------------------------------------------------------------

def apply_block(bp, x, cfg, state, *, positions, cache_index=None,
                kv_len_valid=None):
    """One pre-norm (or post-norm) dense or moe block; ``state`` is the
    layer's KV cache or None."""
    if cfg.post_norm:
        a, nc = L.apply_attention(bp["attn"], x, cfg, positions=positions,
                                  cache=state, cache_index=cache_index,
                                  kv_len_valid=kv_len_valid)
        x = L.apply_norm(bp["ln1"], x + a, cfg)
        return L.apply_norm(bp["ln2"], x + _ffn(bp, x, cfg), cfg), nc
    a, nc = L.apply_attention(bp["attn"], L.apply_norm(bp["ln1"], x, cfg), cfg,
                              positions=positions, cache=state,
                              cache_index=cache_index,
                              kv_len_valid=kv_len_valid)
    x = x + a
    return x + _ffn(bp, L.apply_norm(bp["ln2"], x, cfg), cfg), nc


def _ffn(bp, h, cfg):
    if cfg.family == "moe":
        return M.apply_moe(bp["moe"], h, cfg)
    return L.apply_mlp(bp["mlp"], h, cfg)


def _layer(leaf, i: int):
    if isinstance(leaf, quant.QTensor):
        raise NotImplementedError(
            "stored-integer block weights: an LM plan keeps its blocks "
            "dequantised (runtime.compile_model's partial residency)")
    return leaf[i]


def _scan_blocks(params, x, cfg, *, positions, states=None, cache_index=None,
                 kv_len_valid=None):
    """The reference's ``lax.scan`` over the stacked blocks, as a loop.
    Returns ``(x, states)``: the stacked caches, written in place."""
    for i in range(cfg.n_layers):
        bp = tree_map(lambda a, i=i: _layer(a, i), params["blocks"])
        st = None if states is None else tree_map(lambda a, i=i: a[i], states)
        x, _ = apply_block(bp, x, cfg, st, positions=positions,
                           cache_index=cache_index, kv_len_valid=kv_len_valid)
    return x, states


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------

def _head(params, x, cfg):
    head = params.get("lm_head")
    if head is None:
        # tied embeddings: contract on the table's last axis
        logits = L.linear(x, params["embed"], "...d,vd->...v", cfg)
    else:
        logits = L.linear(x, head, "...d,dv->...v", cfg)
    if cfg.padded_vocab != cfg.vocab_size:   # mask pad ids
        pad = torch.arange(cfg.padded_vocab, device=logits.device) \
            >= cfg.vocab_size
        logits = torch.where(pad, -1e30, logits)
    return logits


def _embed(params, tokens, cfg):
    return L.embed_rows(params["embed"], tokens).to(getattr(torch, cfg.dtype))


def forward(params, tokens, cfg, *, positions=None):
    """tokens [B,S] -> logits [B,S,V] (teacher-forced, no cache)."""
    _kv_family(cfg)
    s = tokens.shape[1]
    x = _embed(params, tokens, cfg)
    if positions is None:
        positions = torch.arange(s, device=x.device)
    x, _ = _scan_blocks(params, x, cfg, positions=positions)
    x = L.apply_norm(params["ln_f"], x, cfg)
    return _head(params, x, cfg)


# ---------------------------------------------------------------------------
# Decode state machine
# ---------------------------------------------------------------------------

def kv_dtype(params, cfg) -> torch.dtype:
    """The dtype the blocks compute keys and values in: the model dtype,
    or float32 where the blocks run a float32 view of stored integers (the
    integer plans' partial residency, ``runtime.compile_model``).  The
    decode state caches in it, so that a decode step attends over the
    values ``forward`` does: a bf16 cache would round the float32 keys and
    values that ``forward`` takes as they are."""
    wk = params["blocks"]["attn"]["wk"]
    wdt = torch.float32 if isinstance(wk, quant.QTensor) else wk.dtype
    return torch.promote_types(getattr(torch, cfg.dtype), wdt)


def init_decode_state(cfg, batch, max_len, device=None, dtype=None):
    """Zero caches of ``max_len`` slots, in ``dtype`` (default: the model
    dtype; ``kv_dtype`` gives the one a plan computes in)."""
    _kv_family(cfg)
    device = resolve_device(device)
    per = L.init_kv_cache(cfg, batch, max_len, dtype=dtype, device=device)
    layers = {k: v[None].repeat((cfg.n_layers,) + (1,) * v.ndim)
              for k, v in per.items()}
    return {"layers": layers, "index": 0}


def _index(idx):
    """An int, or a per-lane [B] tensor (a 0-dim tensor becomes an int)."""
    if isinstance(idx, torch.Tensor) and idx.ndim == 0:
        return int(idx)
    return idx


def prefill(params, tokens, cfg, state):
    """Prompt pass filling the decode state; returns (last_logits, state).

    Writes the whole prompt into the KV caches at the state's index.  With
    a per-lane index the pass is one token (``decode_step``): lanes
    joining mid-flight prefill a fresh state and merge it
    (``cell.scheduler``)."""
    _kv_family(cfg)
    s = tokens.shape[1]
    x = _embed(params, tokens, cfg)
    idx = _index(state["index"])
    steps = torch.arange(s, device=x.device)
    if isinstance(idx, torch.Tensor):           # per-lane [B]
        if s != 1:
            raise ValueError(
                "a per-lane decode state advances one token at a time; "
                "joins prefill a fresh state and merge (cell.scheduler)")
        idx = idx.to(x.device)
        positions = idx[:, None] + steps
    else:
        positions = idx + steps
    x, layers = _scan_blocks(params, x, cfg, positions=positions,
                             states=state["layers"], cache_index=idx,
                             kv_len_valid=idx + s)
    x = L.apply_norm(params["ln_f"], x, cfg)
    logits = _head(params, x[:, -1], cfg)
    return logits, {"layers": layers, "index": idx + s}


def decode_step(params, token, cfg, state):
    """One new token [B] against the running state -> (logits [B,V],
    state).  ``state["index"]`` may be an int or a per-lane [B] tensor."""
    return prefill(params, token[:, None], cfg, state)


def merge_decode_state(old, new, lane_mask):
    """Per-lane select between two same-shaped decode states (new
    tensors; neither input is written).

    The join half of continuous batching (``cell.scheduler``): freshly
    prefilled lanes take ``new``'s caches and index, resident lanes keep
    ``old``'s.  Every ``layers`` leaf is stacked ``[n_layers, B, ...]``;
    ``index`` may be an int on either side and merges to a per-lane [B]
    tensor."""
    dev = tree_leaves(new["layers"])[0].device
    lane_mask = torch.as_tensor(lane_mask, device=dev)
    b = lane_mask.shape[0]

    def sel(n, o):
        return torch.where(lane_mask.reshape((1, b) + (1,) * (n.ndim - 2)),
                           n, o)

    def lanes(idx):
        return torch.as_tensor(idx, dtype=torch.long, device=dev).expand(b)

    index = torch.where(lane_mask, lanes(new["index"]), lanes(old["index"]))
    return {"layers": tree_map(sel, new["layers"], old["layers"]),
            "index": index}


def forward_no_blocks(params, tokens, cfg):
    """Embed -> final norm -> head only (the cost decomposition's
    no-blocks pass)."""
    _kv_family(cfg)
    x = _embed(params, tokens, cfg)
    x = L.apply_norm(params["ln_f"], x, cfg)
    return _head(params, x, cfg)
