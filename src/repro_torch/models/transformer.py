"""Decoder-only LM assembly for every decoder-only family: dense
(granite-8b, internlm2, qwen2.5, nemotron, chameleon), moe (granite-moe,
deepseek-moe), rwkv (rwkv6-3b) and hybrid (hymba) — embedding, the layer
stack, the LM head and the prefill / decode state machine.  Block math
lives in ``layers.py``, ``moe.py``, ``rwkv.py`` and ``ssm.py``; a moe
block is a dense one with ``moe.apply_moe`` (block key ``"moe"``) in
place of the MLP.

The reference scans its stacked layers (``lax.scan``); here the stack is
a Python loop over the same stacked leaves (``blocks``: every leaf
``[n_layers, ...]``), each layer a view ``leaf[i]``.  Under ``cfg.remat``
a stateless pass that records a graph (training: ``loss_fn``) runs each
layer checkpointed, as the reference's ``jax.checkpoint`` does
(``layers.remat``); serving never does.

Decode state: ``{"layers": ..., "index": i}``, every ``layers`` leaf
stacked ``[n_layers, B, ...]``:

  dense/moe : KV caches ``{"k": [L,B,S,KV,Dh], "v": ...}`` (the int8
              cache, ``cfg.quant.quantize_kv_cache``: ``k`` / ``v`` int8
              codes beside float32 scales ``ks`` / ``vs`` [L,B,S,KV])
  rwkv      : recurrences ``{"tmix": {"S": [L,B,H,Dk,Dv], "x_prev":
              [L,B,1,D]}, "cmix": {"x_prev": ...}}``
  hybrid    : ``{"mamba": {"h": [L,B,D,N], "conv": [L,B,K-1,D]}, "kv":``
              a ring KV cache of ``min(max_len, W)`` slots (int8 as
              above under the flag) ``}``

``index`` is an int (every lane at one depth) or, for dense, moe and
rwkv, a per-lane ``[B]`` tensor (the ``cell.scheduler`` continuous-
batching path).  ``prefill`` and ``decode_step`` write the new keys,
values and recurrent states into the state's tensors in place and return
the state with its index advanced; the reference returns new ones
instead.  ``merge_decode_state`` builds new tensors, so a caller that
merges never aliases the states it merges.

The encdec family (whisper) is ``models.encdec``; it raises here.
"""

from __future__ import annotations

import torch

from repro_torch.core import quant
from repro_torch.core.tree import tree_leaves, tree_map
from repro_torch.device import resolve_device
from repro_torch.dist import ctx
from repro_torch.dist.sharding import P, stacked
from repro_torch.models import layers as L
from repro_torch.models import moe as M
from repro_torch.models import rwkv as R
from repro_torch.models import ssm as S

KV_FAMILIES = ("dense", "moe")
RECURRENT_FAMILIES = ("rwkv", "hybrid")
FAMILIES = KV_FAMILIES + RECURRENT_FAMILIES


def _lm_family(cfg):
    if cfg.family not in FAMILIES:
        raise ValueError(
            f"family={cfg.family!r} is not a decoder-only LM (the encdec "
            "family is models.encdec, kwt models.kwt)")


# ---------------------------------------------------------------------------
# Params
# ---------------------------------------------------------------------------

def block_params(cfg, generator, device="cpu"):
    _lm_family(cfg)
    if cfg.family == "rwkv":
        return R.block_params(cfg, generator, device)
    if cfg.family == "hybrid":
        return S.block_params(cfg, generator, device)
    p = {"ln1": L.norm_params(cfg, device=device),
         "ln2": L.norm_params(cfg, device=device),
         "attn": L.attention_params(cfg, generator, device)}
    if cfg.family == "moe":
        p["moe"] = M.moe_params(cfg, generator, device)
    else:
        p["mlp"] = L.mlp_params(cfg, generator, device=device)
    return p


def block_specs(cfg):
    _lm_family(cfg)
    if cfg.family == "rwkv":
        return R.block_specs(cfg)
    if cfg.family == "hybrid":
        return S.block_specs(cfg)
    s = {"ln1": L.norm_specs(cfg), "ln2": L.norm_specs(cfg),
         "attn": L.attention_specs(cfg)}
    if cfg.family == "moe":
        s["moe"] = M.moe_specs(cfg)
    else:
        s["mlp"] = L.mlp_specs(cfg)
    return s


def init_params(cfg, generator: torch.Generator, device=None):
    """Random parameters in the reference's tree layout: ``embed``
    ``[padded_vocab, d]``, ``blocks`` stacked ``[n_layers, ...]``,
    ``ln_f`` and the untied ``lm_head`` ``[d, padded_vocab]``.  Drawn from
    ``generator`` on its own device (a CUDA generator draws full-width
    weights on the card); the numbers differ from ``jax.random``'s, so
    parity tests carry weights across as numpy instead."""
    _lm_family(cfg)
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


def param_specs(cfg):
    s = {
        # embed sharded on d_model (a clean gather); the head vocab-parallel
        "embed": P(None, L.FSDP),
        "blocks": stacked(block_specs(cfg)),
        "ln_f": L.norm_specs(cfg),
    }
    if not cfg.tie_embeddings:
        s["lm_head"] = P(L.FSDP, L.TP)
    return s


# ---------------------------------------------------------------------------
# Blocks
# ---------------------------------------------------------------------------

def apply_block(bp, x, cfg, state, *, positions, cache_index=None,
                kv_len_valid=None, ring=False):
    """Dispatch one block.  ``state`` is the layer's decode state: a KV
    cache or None (dense, moe), a recurrence (rwkv, hybrid: always
    given).  Returns ``(x, new_state)``."""
    if cfg.family == "rwkv":
        return R.apply_block(bp, x, cfg, state)
    if cfg.family == "hybrid":
        return S.apply_block(bp, x, cfg, state, positions=positions,
                             cache_index=cache_index,
                             kv_len_valid=kv_len_valid, ring=ring)
    if cfg.post_norm:
        a, nc = L.apply_attention(bp["attn"], x, cfg, positions=positions,
                                  cache=state, cache_index=cache_index,
                                  kv_len_valid=kv_len_valid)
        x = L.apply_norm(bp["ln1"], x + a, cfg)
        return L.apply_norm(bp["ln2"], x + _ffn(bp, x, cfg), cfg), nc
    # under Megatron-SP x is this rank's sequence chunk (the residual
    # stream between blocks); each sub-layer runs on the gathered
    # sequence, its norm included (so that no weight sees a chunk and
    # every rank's weight gradient is whole), and its residual takes the
    # chunk back (what GSPMD inserts there)
    h = L.apply_norm(bp["ln1"], ctx.unshard_seq(x), cfg)
    a, nc = L.apply_attention(bp["attn"], h, cfg, positions=positions,
                              cache=state, cache_index=cache_index,
                              kv_len_valid=kv_len_valid)
    x = x + ctx.shard_activations(a)
    h = L.apply_norm(bp["ln2"], ctx.unshard_seq(x), cfg)
    return x + ctx.shard_activations(_ffn(bp, h, cfg)), nc


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


def _fresh_state(cfg, batch, device):
    """Zero per-layer recurrence for a stateless pass (rwkv, hybrid)."""
    if cfg.family == "rwkv":
        return R.init_layer_state(cfg, batch, device)
    if cfg.family == "hybrid":
        return {"mamba": S.init_mamba_state(cfg, batch, device)}
    return None


def _write_state(dst, src):
    """Copy a layer's new recurrent state into its slices of the stacked
    state; a tensor the layer wrote in place (the ring KV cache, float or
    int8 codes and scales) is skipped.  No cast: each new tensor has its
    slot's dtype."""
    for key, new in src.items():
        old = dst[key]
        if isinstance(new, dict):
            _write_state(old, new)
        elif new is not old:
            if new.dtype != old.dtype:
                raise TypeError(f"decode state {key!r}: {new.dtype} into "
                                f"{old.dtype}")
            old.copy_(new)


def _scan_blocks(params, x, cfg, *, positions, states=None, cache_index=None,
                 kv_len_valid=None, ring=False):
    """The reference's ``lax.scan`` over the stacked blocks, as a loop.
    Returns ``(x, states)``: the stacked caches and recurrences, written in
    place (layer i's new recurrence into ``states[...][i]``).  Without
    ``states`` a recurrent family starts every layer from zeros."""
    recurrent = cfg.family in RECURRENT_FAMILIES
    if ctx._seq_sharded() and (
            recurrent or cfg.post_norm):
        raise NotImplementedError(
            "Megatron-SP (seq_axis) runs the pre-norm dense and moe blocks "
            "(the archs of launch.steps.SEQ_SHARD)")
    fresh = _fresh_state(cfg, x.shape[0], x.device) \
        if states is None and recurrent else None
    for i in range(cfg.n_layers):
        bp = tree_map(lambda a, i=i: _layer(a, i), params["blocks"])
        if states is None:
            # stateless (forward, training): a dropped state, so a layer
            # may be checkpointed (the reference's remat)
            x = L.remat(cfg, lambda h, bp=bp: ctx.shard_activations(
                apply_block(bp, ctx.shard_activations(h), cfg, fresh,
                            positions=positions, cache_index=cache_index,
                            kv_len_valid=kv_len_valid, ring=ring)[0]),
                x, bp)
            continue
        st = tree_map(lambda a, i=i: a[i], states)
        x, new = apply_block(bp, ctx.shard_activations(x), cfg, st,
                             positions=positions, cache_index=cache_index,
                             kv_len_valid=kv_len_valid, ring=ring)
        x = ctx.shard_activations(x)
        if recurrent:
            _write_state(st, new)
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
    return ctx.embed_lookup(L.embed_rows(params["embed"], tokens)).to(
        getattr(torch, cfg.dtype))


def forward(params, tokens, cfg, *, positions=None):
    """tokens [B,S] -> logits [B,S,V] (teacher-forced, no cache; a
    recurrent family starts from a zero state)."""
    _lm_family(cfg)
    s = tokens.shape[1]
    with ctx.sequence(s):
        x = ctx.shard_activations(_embed(params, tokens, cfg))
        if positions is None:
            positions = torch.arange(s, device=x.device)
        x, _ = _scan_blocks(params, x, cfg, positions=positions)
        x = L.apply_norm(params["ln_f"], ctx.unshard_seq(x), cfg)
        return ctx.shard_logits(_head(params, x, cfg))


def loss_fn(params, batch, cfg):
    """Next-token cross-entropy of ``forward``: float32 logsumexp less the
    gold logit, the mean over tokens, or with ``batch["mask"]`` the
    masked mean ``sum(nll * mask) / max(sum(mask), 1)``."""
    logits = forward(params, batch["tokens"], cfg).to(torch.float32)
    logz = torch.logsumexp(logits, dim=-1)
    gold = logits.gather(-1, batch["labels"].long()[..., None])[..., 0]
    nll = logz - gold
    mask = batch.get("mask")
    if mask is None:
        return nll.mean()
    mask = mask.to(nll.dtype)
    return (nll * mask).sum() / mask.sum().clamp(min=1.0)


# ---------------------------------------------------------------------------
# Decode state machine
# ---------------------------------------------------------------------------

def kv_dtype(params, cfg) -> torch.dtype:
    """The dtype the blocks compute keys and values in: the model dtype,
    or float32 where the blocks run a float32 view of stored integers (the
    integer plans' partial residency, ``runtime.compile_model``).  The
    decode state caches in it, so that a decode step attends over the
    values ``forward`` does: a bf16 cache would round the float32 keys and
    values that ``forward`` takes as they are.  Hybrid keeps its conv tail
    in it too.  A family with no attention (rwkv) has no keys and values:
    the model dtype, which its token-shift tails are kept in."""
    attn = params["blocks"].get("attn")
    if attn is None:
        return getattr(torch, cfg.dtype)
    wk = attn["wk"]
    wdt = torch.float32 if isinstance(wk, quant.QTensor) else wk.dtype
    return torch.promote_types(getattr(torch, cfg.dtype), wdt)


def init_decode_state(cfg, batch, max_len, device=None, dtype=None):
    """Zero decode state at index 0: KV caches of ``max_len`` slots in
    ``dtype`` (default: the model dtype; ``kv_dtype`` gives the one a plan
    computes in), or int8 codes and float32 scales under
    ``cfg.quant.quantize_kv_cache`` (``dtype`` then ignored, as in the
    reference: attention decodes them into the activations' dtype);
    rwkv's recurrences (S float32, the token-shift tails in
    the model dtype); hybrid's mamba state (h float32, the conv tail in
    ``dtype``) beside a ring KV cache of ``min(max_len, sliding_window)``
    slots in ``dtype``."""
    _lm_family(cfg)
    device = resolve_device(device)
    if cfg.family == "rwkv":
        per = R.init_layer_state(cfg, batch, device)
    elif cfg.family == "hybrid":
        per = {"mamba": S.init_mamba_state(cfg, batch, device, dtype),
               "kv": L.init_kv_cache(cfg, batch,
                                     min(max_len, cfg.sliding_window),
                                     dtype=dtype, device=device)}
    else:
        per = L.init_kv_cache(cfg, batch, max_len, dtype=dtype, device=device)
    layers = tree_map(
        lambda v: v[None].repeat((cfg.n_layers,) + (1,) * v.ndim), per)
    return {"layers": layers, "index": 0}


def decode_state_specs(cfg, dp=("data",), tp_size=16):
    _lm_family(cfg)
    if cfg.family == "rwkv":
        per = R.state_specs(cfg, dp)
    elif cfg.family == "hybrid":
        per = {"mamba": S.mamba_state_specs(cfg, dp),
               "kv": L.kv_cache_specs(cfg, dp, tp_size)}
    else:
        per = L.kv_cache_specs(cfg, dp, tp_size)
    return {"layers": stacked(per), "index": P()}


def _index(idx):
    """An int, or a per-lane [B] tensor (a 0-dim tensor becomes an int)."""
    if isinstance(idx, torch.Tensor) and idx.ndim == 0:
        return int(idx)
    return idx


def prefill(params, tokens, cfg, state):
    """Prompt pass filling the decode state; returns (last_logits, state).

    dense/moe: writes the whole prompt into the KV caches at the state's
    index.  With a per-lane index the pass is one token (``decode_step``):
    lanes joining mid-flight prefill a fresh state and merge it
    (``cell.scheduler``).
    rwkv: runs the recurrence from the state's; the final state is the
    cache (any index, per-lane included).
    hybrid: a prompt longer than the window runs banded attention and
    threads the mamba state, and leaves the ring cache as it is (the
    reference's own behaviour, ROADMAP C10); ``1 < s <= W`` is a causal
    chunk written at ``index mod W``; ``s == 1`` a ring decode step.  A
    per-lane index raises, as in the reference."""
    _lm_family(cfg)
    s = tokens.shape[1]
    x = _embed(params, tokens, cfg)
    idx = _index(state["index"])
    steps = torch.arange(s, device=x.device)
    if cfg.family in RECURRENT_FAMILIES:
        x, layers = _recurrent_prefill(params, x, cfg, state, idx, steps)
    else:
        if isinstance(idx, torch.Tensor):           # per-lane [B]
            if s != 1:
                raise ValueError(
                    "a per-lane decode state advances one token at a time; "
                    "joins prefill a fresh state and merge (cell.scheduler)")
            idx = idx.to(x.device)
            positions = idx[:, None] + steps
        else:
            positions = idx + steps
        with ctx.sequence(s):
            x, layers = _scan_blocks(params, x, cfg, positions=positions,
                                     states=state["layers"], cache_index=idx,
                                     kv_len_valid=idx + s)
            x = ctx.unshard_seq(x)
    x = L.apply_norm(params["ln_f"], x, cfg)
    logits = _head(params, x[:, -1], cfg)
    return logits, {"layers": layers, "index": idx + s}


def _recurrent_prefill(params, x, cfg, state, idx, steps):
    if cfg.family == "rwkv":
        return _scan_blocks(params, x, cfg, positions=None,
                            states=state["layers"])
    if isinstance(idx, torch.Tensor):
        raise ValueError("per-lane decode indices cover dense/moe/rwkv; "
                         "hybrid ring caches keep the shared-cursor path")
    s, w = x.shape[1], cfg.sliding_window
    positions = idx + steps
    if s > w:
        # long prompt: banded attention, no cache fill (C10)
        x, _ = _scan_blocks(params, x, cfg, positions=positions,
                            states={"mamba": state["layers"]["mamba"]})
        return x, state["layers"]
    # s == 1: a ring decode step (slots may be rotated: positional
    # causality means nothing there, the validity bound alone masks);
    # s > 1: a prompt chunk in monotone slots, ordinary causal masks
    return _scan_blocks(params, x, cfg, positions=positions,
                        states=state["layers"], cache_index=idx % w,
                        kv_len_valid=min(idx + s, w), ring=s == 1)


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
    _lm_family(cfg)
    x = _embed(params, tokens, cfg)
    x = L.apply_norm(params["ln_f"], x, cfg)
    return _head(params, x, cfg)
