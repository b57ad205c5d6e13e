"""Whisper-style encoder-decoder (whisper-large-v3 backbone).

The conv frontend is a stub, as in the reference: the encoder takes
precomputed frame embeddings ``[B, enc_seq, d_model]``.  Encoder:
pre-norm bidirectional self-attention blocks and GELU MLPs (the paper's
LUT GELU, and its LUT softmax on unmasked rows of ``enc_seq`` keys),
then a final LayerNorm.  Decoder: causal self-attention over a KV cache,
cross-attention to the encoder memory (its keys and values cached at
prefill), a GELU MLP and the head tied to the embedding table.
Sinusoidal positions, no RoPE.

The contract is module level (ROADMAP C11): the reference runs this
family only as ``encdec.*(float params, ..., cfg)``, where under a plan
``cfg`` is that plan's ``exec_cfg`` (``runtime.get_backend(name)
.configure(cfg)``), so the softmax, the GELU and, with
``attention="flash_lut"``, the encoder's cacheless self-attention take
the plan's modes — on the ``cuda`` plan the hand-written kernels.  The
weights stay float: the tied head is a float product on ``embed``,
outside every kernel, as in the reference.  ``runtime.Engine`` plans the
family but does not drive it (its ``prefill`` / ``decode_step`` /
``forward`` raise).

As in ``models.transformer``, the stacked layers are walked in a Python
loop (each layer a view ``leaf[i]``; checkpointed under ``cfg.remat``
where a graph is recorded, ``layers.remat``), and ``prefill`` /
``decode_step`` write the decode state in place and return it with its
index advanced: the self-attention caches by ``layers.apply_attention``,
the cross-attention cache by ``prefill``, which fills it from the encoder
memory (the reference returns new caches instead).  The index is an int:
the reference has no per-lane path for this family.

Decode state: ``{"layers": {"kv": {"k", "v"}, "cross": {"k", "v"}},
"index": i}``, every leaf stacked ``[n_layers, B, ...]``: self caches of
``max_len`` slots, cross caches of ``enc_seq``.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from repro_torch.core.tree import tree_leaves, tree_map
from repro_torch.device import resolve_device
from repro_torch.dist import ctx
from repro_torch.dist.sharding import P, stacked
from repro_torch.models import layers as L


@functools.lru_cache(maxsize=8)
def _freqs(half: int, device: torch.device) -> torch.Tensor:
    """The ``half`` geometric frequencies in the reference's float32
    arithmetic, computed on the host (so the card and the CPU take the
    same ones) and kept per device; callers only read them."""
    ar = torch.arange(half, dtype=torch.float32)
    c = torch.tensor(-np.log(10000.0), dtype=torch.float32)
    return torch.exp(c * ar / torch.tensor(float(half))).to(device)


def sinusoid(positions: torch.Tensor, d: int) -> torch.Tensor:
    """positions [...] -> [..., d]: ``sin`` then ``cos`` of the positions
    over ``d / 2`` geometric frequencies, in float32."""
    ang = positions.to(torch.float32)[..., None] \
        * _freqs(d // 2, positions.device)
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


# ---------------------------------------------------------------------------
# Params
# ---------------------------------------------------------------------------

def cross_attention_params(cfg, generator, device="cpu"):
    """Q/K/V/O of the cross-attention; biases on Q, V and O (none on K)."""
    d, h, dh = cfg.d_model, cfg.n_heads, cfg.resolved_head_dim
    dt = L._dtype(cfg)

    def zeros(n):
        return torch.zeros((n,), dtype=dt, device=device)

    return {"wq": L.he(generator, (d, h * dh), 1.0, dt, device),
            "wk": L.he(generator, (d, h * dh), 1.0, dt, device),
            "wv": L.he(generator, (d, h * dh), 1.0, dt, device),
            "wo": L.he(generator, (h * dh, d), 1.0, dt, device),
            "bq": zeros(h * dh), "bv": zeros(h * dh), "bo": zeros(d)}


def enc_block_params(cfg, generator, device="cpu"):
    return {"ln1": L.norm_params(cfg, device=device),
            "ln2": L.norm_params(cfg, device=device),
            "attn": L.attention_params(cfg, generator, device),
            "mlp": L.mlp_params(cfg, generator, device=device)}


def dec_block_params(cfg, generator, device="cpu"):
    return {"ln1": L.norm_params(cfg, device=device),
            "ln2": L.norm_params(cfg, device=device),
            "ln3": L.norm_params(cfg, device=device),
            "self_attn": L.attention_params(cfg, generator, device),
            "cross_attn": cross_attention_params(cfg, generator, device),
            "mlp": L.mlp_params(cfg, generator, device=device)}


def _stacked(make, n: int):
    layers = [make() for _ in range(n)]
    return tree_map(lambda *xs: torch.stack(xs), layers[0], *layers[1:])


def init_params(cfg, generator: torch.Generator, device=None):
    """Random parameters in the reference's tree layout: ``embed``
    ``[padded_vocab, d]`` (also the head), ``enc_blocks`` and
    ``dec_blocks`` stacked ``[n_layers, ...]``, ``ln_enc`` and
    ``ln_dec``.  Drawn from ``generator`` on its own device; the numbers
    differ from ``jax.random``'s, so parity tests carry weights across as
    numpy."""
    device = resolve_device(device)
    dt = L._dtype(cfg)
    embed = L.he(generator, (cfg.padded_vocab, cfg.d_model), 1.0, dt, device)
    enc = _stacked(lambda: enc_block_params(cfg, generator, device),
                   cfg.n_enc_layers)
    dec = _stacked(lambda: dec_block_params(cfg, generator, device),
                   cfg.n_layers)
    return {"embed": embed, "enc_blocks": enc, "dec_blocks": dec,
            "ln_enc": L.norm_params(cfg, device=device),
            "ln_dec": L.norm_params(cfg, device=device)}


def _mask_pad(logits, cfg):
    if cfg.padded_vocab != cfg.vocab_size:
        pad = torch.arange(cfg.padded_vocab, device=logits.device) \
            >= cfg.vocab_size
        logits = torch.where(pad, -1e30, logits)
    return logits


def cross_attention_specs(cfg):
    return {"wq": P(L.FSDP, L.TP), "wk": P(L.FSDP, L.TP),
            "wv": P(L.FSDP, L.TP), "wo": P(L.TP, L.FSDP),
            "bq": P(L.TP), "bv": P(L.TP), "bo": P(None)}


def enc_block_specs(cfg):
    return {"ln1": L.norm_specs(cfg), "ln2": L.norm_specs(cfg),
            "attn": L.attention_specs(cfg), "mlp": L.mlp_specs(cfg)}


def dec_block_specs(cfg):
    return {"ln1": L.norm_specs(cfg), "ln2": L.norm_specs(cfg),
            "ln3": L.norm_specs(cfg),
            "self_attn": L.attention_specs(cfg),
            "cross_attn": cross_attention_specs(cfg),
            "mlp": L.mlp_specs(cfg)}


def param_specs(cfg):
    return {"embed": P(None, L.FSDP),
            "enc_blocks": stacked(enc_block_specs(cfg)),
            "dec_blocks": stacked(dec_block_specs(cfg)),
            "ln_enc": L.norm_specs(cfg), "ln_dec": L.norm_specs(cfg)}


def decode_state_specs(cfg, dp=("data",), tp_size=16):
    # cross-KV stays DP-sharded / TP-replicated (the reference's choice:
    # enc_seq 1500 and 20 heads both resist a 16-way split)
    per = {"kv": L.kv_cache_specs(cfg, dp, tp_size),
           "cross": {"k": P(dp, None, None, None),
                     "v": P(dp, None, None, None)}}
    return {"layers": stacked(per), "index": P()}


# ---------------------------------------------------------------------------
# Apply
# ---------------------------------------------------------------------------

def apply_cross_attention(p, x, cfg, *, memory=None, mem_kv=None):
    """x [B,Sq,D]; memory [B,Sk,D], or its keys and values ``mem_kv``
    (the decode cache).  Returns ``(out, mem_kv)``.  Every product is a
    float einsum, as in the reference; the softmax takes the plan's mode
    on unmasked rows of Sk keys."""
    b, sq, _ = x.shape
    h, dh = cfg.n_heads, cfg.resolved_head_dim
    q = (L.linear(x, p["wq"], "bsd,df->bsf") + p["bq"]).reshape(b, sq, h, dh)
    if mem_kv is None:
        sk = memory.shape[1]
        k = L.linear(memory, p["wk"], "bsd,df->bsf")
        v = L.linear(memory, p["wv"], "bsd,df->bsf") + p["bv"]
        mem_kv = {"k": k.reshape(b, sk, h, dh), "v": v.reshape(b, sk, h, dh)}
    out = L.sdpa(q, mem_kv["k"], mem_kv["v"], cfg, q_offset=0,
                 kv_len_valid=None, causal=False)
    out = L.linear(out.reshape(b, sq, h * dh), p["wo"], "bsf,fd->bsd")
    return (out + p["bo"]).to(x.dtype), mem_kv


def apply_enc_block(bp, x, cfg):
    """Pre-norm, non-causal, cacheless: under ``attention="flash_lut"``
    the self-attention is the flash-LUT attention."""
    h = L.apply_norm(bp["ln1"], x, cfg)
    a, _ = L.apply_attention(bp["attn"], h, cfg, causal=False)
    x = x + a
    return x + L.apply_mlp(bp["mlp"], L.apply_norm(bp["ln2"], x, cfg), cfg)


def apply_dec_block(bp, x, cfg, *, positions, memory=None, state=None,
                    cache_index=None):
    """``state`` = dict(kv=self cache, cross=mem_kv or None) or None
    (teacher-forced).  The self cache is written in place; the returned
    state holds it and the cross keys and values used."""
    h = L.apply_norm(bp["ln1"], x, cfg)
    a, new_kv = L.apply_attention(
        bp["self_attn"], h, cfg, positions=positions,
        cache=None if state is None else state["kv"], cache_index=cache_index)
    x = x + a
    h = L.apply_norm(bp["ln2"], x, cfg)
    c, mem_kv = apply_cross_attention(
        bp["cross_attn"], h, cfg, memory=memory,
        mem_kv=None if state is None else state.get("cross"))
    x = x + c
    x = x + L.apply_mlp(bp["mlp"], L.apply_norm(bp["ln3"], x, cfg), cfg)
    new_state = None if state is None else {"kv": new_kv, "cross": mem_kv}
    return x, new_state


def _layers(blocks):
    """Each layer's weights: views ``leaf[i]`` of the stacked leaves."""
    n = tree_leaves(blocks)[0].shape[0]
    for i in range(n):
        yield tree_map(lambda a, i=i: a[i], blocks)


def _embed(params, tokens, cfg, start: int = 0):
    """Token rows of the float table plus their sinusoid positions
    ``start ..``."""
    x = params["embed"][tokens.long()].to(L._dtype(cfg))
    pos = start + torch.arange(tokens.shape[1], device=x.device)
    return x + sinusoid(pos, cfg.d_model).to(x.dtype), pos


def _head(params, x, cfg):
    """The tied head: a float product on ``embed``, pad ids masked."""
    return _mask_pad(L.linear(x, params["embed"], "...d,vd->...v"), cfg)


def encode(params, frames, cfg):
    """frames [B,Senc,D] (the stub frontend's output) -> memory
    [B,Senc,D]."""
    _no_seq_axis()
    x = frames.to(L._dtype(cfg))
    x = x + sinusoid(torch.arange(x.shape[1], device=x.device),
                     cfg.d_model).to(x.dtype)
    for bp in _layers(params["enc_blocks"]):
        x = L.remat(cfg, lambda h, bp=bp: ctx.shard_activations(
            apply_enc_block(bp, ctx.shard_activations(h), cfg)), x, bp)
    return L.apply_norm(params["ln_enc"], x, cfg)


def decode_train(params, memory, tokens, cfg):
    """Teacher-forced decoder pass -> logits [B,S,V]."""
    _no_seq_axis()
    x, pos = _embed(params, tokens, cfg)
    for bp in _layers(params["dec_blocks"]):
        x = L.remat(cfg, lambda h, bp=bp: ctx.shard_activations(
            apply_dec_block(bp, ctx.shard_activations(h), cfg, positions=pos,
                            memory=memory)[0]), x, bp)
    x = L.apply_norm(params["ln_dec"], x, cfg)
    return ctx.shard_logits(_head(params, x, cfg))


def _no_seq_axis():
    if ctx._seq_sharded():
        raise NotImplementedError(
            "Megatron-SP (seq_axis) runs the pre-norm dense and moe blocks "
            "(the archs of launch.steps.SEQ_SHARD), not the encoder-decoder")


def loss_fn(params, batch, cfg):
    """Mean token cross-entropy of ``decode_train`` on ``encode(frames)``."""
    memory = encode(params, batch["frames"], cfg)
    logits = decode_train(params, memory, batch["tokens"], cfg).to(
        torch.float32)
    logz = torch.logsumexp(logits, dim=-1)
    gold = logits.gather(-1, batch["labels"].long()[..., None])[..., 0]
    return (logz - gold).mean()


# ---------------------------------------------------------------------------
# Serving
# ---------------------------------------------------------------------------

def init_decode_state(cfg, batch, max_len, device=None):
    """Zero decode state at index 0: self caches of ``max_len`` slots and
    cross caches of ``enc_seq``, in the model dtype; under
    ``cfg.quant.quantize_kv_cache`` the self caches are int8 codes and
    float32 scales (``layers.init_kv_cache``) and the cross caches stay
    float, as in the reference."""
    device = resolve_device(device)
    h, dh = cfg.n_heads, cfg.resolved_head_dim
    dt = L._dtype(cfg)
    per = {"kv": L.init_kv_cache(cfg, batch, max_len, dtype=dt,
                                 device=device),
           "cross": {"k": torch.zeros((batch, cfg.enc_seq, h, dh), dtype=dt,
                                      device=device)}}
    per["cross"]["v"] = torch.zeros_like(per["cross"]["k"])
    layers = tree_map(
        lambda v: v[None].repeat((cfg.n_layers,) + (1,) * v.ndim), per)
    return {"layers": layers, "index": 0}


def _index(state) -> int:
    idx = state["index"]
    if isinstance(idx, torch.Tensor):
        if idx.ndim:
            raise ValueError("the encdec decode state has one index for "
                             "every lane, as in the reference")
        idx = int(idx)
    return idx


def _decoder(params, x, cfg, state, pos, idx, memory=None):
    """The decoder layers over ``state`` (in place), then the final norm
    and the head on the last position."""
    layers = state["layers"]
    for i, bp in enumerate(_layers(params["dec_blocks"])):
        st = tree_map(lambda a, i=i: a[i], layers)
        x, new = apply_dec_block(
            bp, x, cfg, positions=pos, memory=memory, cache_index=idx,
            state={"kv": st["kv"],
                   "cross": None if memory is not None else st["cross"]})
        if memory is not None:                # fill the cross cache
            for key, t in new["cross"].items():
                if t.dtype != st["cross"][key].dtype:
                    raise TypeError(f"cross cache {key!r}: {t.dtype} into "
                                    f"{st['cross'][key].dtype}")
                st["cross"][key].copy_(t)
    x = L.apply_norm(params["ln_dec"], x, cfg)
    return _head(params, x[:, -1], cfg)


def prefill(params, frames, tokens, cfg, state):
    """Encode the audio, fill the cross caches from its memory, then run
    the prompt tokens into the self caches.  Returns (last logits [B,V],
    state)."""
    memory = encode(params, frames, cfg)
    idx = _index(state)
    x, pos = _embed(params, tokens, cfg, idx)
    logits = _decoder(params, x, cfg, state, pos, idx, memory)
    return logits, {"layers": state["layers"], "index": idx + tokens.shape[1]}


def decode_step(params, token, cfg, state):
    """One decoder token [B] against the self caches and the cached cross
    keys and values -> (logits [B,V], state)."""
    idx = _index(state)
    x, pos = _embed(params, token[:, None], cfg, idx)
    logits = _decoder(params, x, cfg, state, pos, idx)
    return logits, {"layers": state["layers"], "index": idx + 1}
