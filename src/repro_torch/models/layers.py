"""Shared transformer layers: norms, RoPE, GQA attention with a KV cache,
(gated) MLP — for KWT and the decoder-only LMs.

Functional style: ``*_params(cfg, generator)`` builds a dict of weights,
``*_specs(cfg)`` the same-structured dict of partition specs
(``dist.sharding.P``: FSDP over 'data' x TP over 'model', the
reference's), ``apply_*`` runs the math on ``[B, T, d]`` tensors.  The paper's technique
enters through ``cfg.softmax_mode`` / ``cfg.act_approx`` (LUT
approximations, ``"cuda"`` = the hand-written kernels) and through
QTensor weights (int8 / nibble-packed int4).

Cacheless attention runs either the plain einsum path (``sdpa``,
``cfg.attn_impl == "xla"``) or the flash-LUT attention
(``attn_impl == "flash_lut"``): the hand-written kernel on the ``cuda``
plan, its plain version on every other plan.  Attention over a KV cache
(``prefill`` / ``decode_step`` of ``models.transformer``) always takes
``sdpa``, with causal masks, per-lane query offsets and validity bounds,
as the reference does.  The cache is updated in place (the reference
returns new caches): the layer writes this call's keys and values into
the caller's tensors and returns the same tensors.

A sliding window (``cfg.sliding_window``, the hybrid family) bands the
causal mask (``kpos > qpos - W``) and, in query chunks, slices each
chunk's keys to its band; a ring cache (hybrid decode) passes
``causal=False`` and an explicit validity bound instead, the window being
kept by overwrite.

``apply_attention`` and ``apply_mlp`` emit the quantisation-health taps
of their inputs (``telemetry.taps``; a no-op without a collector).  Under
an active ``telemetry`` tracer ``apply_attention``, ``apply_mlp`` and
``apply_norm`` record the spans ``attention``, ``mlp`` and ``norm``: every
family that builds its layers from them (KWT and the dense LMs among
them) is split by layer in a trace; a residual add stays in the caller's
span.

The int8 KV cache (``cfg.quant.quantize_kv_cache``, the paper's eq 9 on
the cache): each (token, KV head) vector is stored as int8 codes and one
power-of-two float32 scale (``_q8_vec``), written in place like the float
cache, and attention runs over the decoded values (``_q8_vec_decode``) in
the activations' dtype.  The scale's exponent is computed exactly from
the float's bits (ROADMAP C12: XLA:CPU's ``log2`` / ``exp2`` are not
exact at some powers of two, so the reference can pick one exponent
higher there).
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import approx
from repro_torch.core import quant
from repro_torch.core.tree import tree_leaves
from repro_torch.dist.sharding import P
from repro_torch.telemetry import taps as _health
from repro_torch.telemetry import trace as _trace

def executes_int(w, eq: str, cfg) -> bool:
    """Whether ``linear`` multiplies the stored integers of ``w`` (an
    exact product whose rows do not depend on each other)."""
    return isinstance(w, quant.QTensor) and cfg is not None and \
        cfg.int_exec and quant.int_exec_supported(w, eq)


def linear(x, w, eq: str, cfg=None):
    """One linear layer, weight either float or a stored-integer QTensor.

    Integer-EXECUTING plans (``cfg.int_exec``, pinned by
    ``runtime.compile_model`` on the lut/cuda backends) quantise the
    input with the eq-9 activation quantiser and multiply the stored
    int8 / nibble-packed int4 payload directly, with a per-channel po2
    requant epilogue (``quant.int_exec_einsum``) — no float weight view.
    On the ``cuda`` plan that product IS the CUDA int8 matmul kernel, for
    every linear of the model.  Non-executing resident plans materialise
    the exact float view per call (``quant.qt_einsum``), bit-identical to
    dequantise-first.
    """
    if executes_int(w, eq, cfg):
        q = cfg.quant
        return quant.int_exec_einsum(
            eq, x, w,
            x_exp=q.input_exponent if q is not None else 5,
            residual_bits=q.residual_bits if q is not None else 16,
            use_kernel=(cfg.act_approx == "cuda"))
    if isinstance(w, quant.QTensor):
        return quant.qt_einsum(eq, x, w)
    if x.dtype != w.dtype:      # jnp.einsum promotes (bf16 x f32 -> f32)
        dt = torch.promote_types(x.dtype, w.dtype)
        x, w = x.to(dt), w.to(dt)
    return torch.einsum(eq, x, w)


def remat(cfg, fn, x, weights):
    """``fn(x)`` for one layer, under activation checkpointing where the
    reference's ``jax.checkpoint`` would apply: ``cfg.remat`` set and an
    autograd graph being recorded through ``x`` or the layer's
    ``weights`` (a tree).  Then the layer is one
    ``torch.utils.checkpoint.checkpoint(..., use_reentrant=False)``: its
    activations are dropped after the forward and the backward reruns
    it (every approx op of the rerun again, the kernels behind the STEs
    included).  Otherwise — ``remat`` off, or no graph (every serving
    path) — ``fn(x)`` as it is, with no op added."""
    if not (cfg.remat and torch.is_grad_enabled()) or not (
            x.requires_grad
            or any(isinstance(w, torch.Tensor) and w.requires_grad
                   for w in tree_leaves(weights))):
        return fn(x)
    from torch.utils.checkpoint import checkpoint

    from repro_torch.dist import ctx

    # the recompute runs in backward, on autograd's device thread on the
    # card: it takes this thread's mesh declarations along
    snap = ctx.snapshot()

    def run(h):
        with ctx.resumed(snap):
            return fn(h)
    return checkpoint(run, x, use_reentrant=False)


def keep_dtype(y, x):
    """A recurrent block's output in the dtype of the block's input
    (ROADMAP C9).  Under an integer plan's float32 block view a bf16
    model's projections come out float32 and would widen the residual
    stream (the reference raises there); wherever the reference runs this
    is a no-op."""
    return y.to(x.dtype)


def embed_rows(embed, tokens):
    """Embedding lookup, table either float or a stored-integer QTensor.

    QTensor tables gather integer rows and descale only what was looked
    up (``quant.gather_descale``); the full table never materialises as
    float."""
    if isinstance(embed, quant.QTensor):
        return quant.gather_descale(embed, tokens)
    return embed[tokens.long()]


def asfloat(w):
    """Dequantise a QTensor consumed outside a matmul (e.g. additive
    positional embeddings); floats pass through untouched."""
    return quant.resident_values(w) if isinstance(w, quant.QTensor) else w


def _dtype(cfg):
    return getattr(torch, cfg.dtype)


# Mesh axis conventions (launch/mesh.py):
FSDP = "data"     # parameter shard axis (ZeRO-3 style)
TP = "model"      # tensor-parallel axis


def fsdp_axis(cfg):
    """Weight shard axis/axes: ``pure_fsdp`` shards over the whole mesh
    (no TP), ``tp_only`` keeps weights TP-resident (no FSDP)."""
    if cfg.pure_fsdp:
        return ("data", "model")
    if cfg.tp_only:
        return None
    return FSDP


def tp_axis(cfg):
    return None if cfg.pure_fsdp else TP


def he(generator, shape, scale, dtype, device="cpu"):
    """Scaled-normal initialiser.  Drawn from ``generator`` on the
    generator's own device (a CPU generator gives one stream of numbers
    whatever the target device; a CUDA one draws full-width LM weights on
    the card), then moved.  On the ``meta`` device nothing is drawn: a
    tree of shapes and dtypes (``launch.steps.params_shape``)."""
    if torch.device(device).type == "meta":
        return torch.empty(shape, dtype=dtype, device="meta")
    fan_in = shape[0] if len(shape) > 1 else max(shape[0], 1)
    w = torch.randn(shape, generator=generator, dtype=torch.float32,
                    device=generator.device)
    # scaled in place: one float32 copy of a leaf at a time (nemotron's
    # embed is 18.9 GB in float32)
    return w.mul_(scale / np.sqrt(fan_in)).to(dtype).to(device)


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------

def norm_params(cfg, d=None, device="cpu"):
    d = d or cfg.d_model
    if cfg.norm == "layernorm":
        return {"scale": torch.ones((d,), dtype=torch.float32, device=device),
                "bias": torch.zeros((d,), dtype=torch.float32, device=device)}
    return {"scale": torch.ones((d,), dtype=torch.float32, device=device)}


def norm_specs(cfg):
    if cfg.norm == "layernorm":
        return {"scale": P(None), "bias": P(None)}
    return {"scale": P(None)}


def apply_norm(p, x, cfg, eps=1e-6):
    with _trace.span("norm"):
        x = x.to(torch.float32)
        if cfg.norm == "layernorm":
            # paper eqs (4)-(5): mean/variance normalise, then gamma/beta.
            mu = x.mean(dim=-1, keepdim=True)
            var = x.var(dim=-1, keepdim=True, unbiased=False)
            y = (x - mu) * torch.rsqrt(var + eps)
            return (y * p["scale"] + p["bias"]).to(_dtype(cfg))
        ms = x.square().mean(dim=-1, keepdim=True)
        return (x * torch.rsqrt(ms + eps) * p["scale"]).to(_dtype(cfg))


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------

def rope_tables(positions: torch.Tensor, head_dim: int, theta: float):
    """positions [S] (or [B,S]) -> cos/sin tables [..., S, head_dim//2]."""
    half = head_dim // 2
    freqs = 1.0 / (theta ** (torch.arange(half, dtype=torch.float32,
                                          device=positions.device) / half))
    ang = positions.to(torch.float32)[..., None] * freqs
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor):
    """x [..., S, H, D]; cos/sin broadcastable [..., S, 1, D/2]."""
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Attention (GQA, optional qk-norm / qkv-bias / KV cache)
# ---------------------------------------------------------------------------

def attention_params(cfg, generator, device="cpu"):
    d, h, kv, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    dt = _dtype(cfg)
    p = {
        "wq": he(generator, (d, h * dh), 1.0, dt, device),
        "wk": he(generator, (d, kv * dh), 1.0, dt, device),
        "wv": he(generator, (d, kv * dh), 1.0, dt, device),
        "wo": he(generator, (h * dh, d), 1.0, dt, device),
    }
    if cfg.qkv_bias or cfg.bias:
        p["bq"] = torch.zeros((h * dh,), dtype=dt, device=device)
        p["bk"] = torch.zeros((kv * dh,), dtype=dt, device=device)
        p["bv"] = torch.zeros((kv * dh,), dtype=dt, device=device)
    if cfg.bias:
        p["bo"] = torch.zeros((d,), dtype=dt, device=device)
    if cfg.qk_norm:
        p["q_norm"] = torch.ones((dh,), dtype=torch.float32, device=device)
        p["k_norm"] = torch.ones((dh,), dtype=torch.float32, device=device)
    return p


def attention_specs(cfg):
    f, t = fsdp_axis(cfg), tp_axis(cfg)
    s = {"wq": P(f, t), "wk": P(f, t), "wv": P(f, t), "wo": P(t, f)}
    if cfg.qkv_bias or cfg.bias:
        s.update({"bq": P(t), "bk": P(t), "bv": P(t)})
    if cfg.bias:
        s["bo"] = P(None)
    if cfg.qk_norm:
        s.update({"q_norm": P(None), "k_norm": P(None)})
    return s


def _rms(x, scale, eps=1e-6):
    x = x.to(torch.float32)
    return x * torch.rsqrt(x.square().mean(dim=-1, keepdim=True) + eps) * scale


Q_CHUNK = 512       # query-chunked attention: bounds the score tile


def _f32(t: torch.Tensor) -> torch.Tensor:
    """``t`` in float32, with no op where it already is (each op costs the
    host a dispatch on the small KWT shapes)."""
    return t if t.dtype == torch.float32 else t.to(torch.float32)


def _per_lane(t) -> bool:
    return isinstance(t, torch.Tensor) and t.ndim == 1


def _sdpa_block(q, k, v, cfg, *, q0, k0, q_offset, kv_len_valid, causal):
    """One [qc, kc] tile of masked attention.  q [B,qc,H,D]; k/v [B,kc,KV,D].

    ``q0`` / ``k0``: tile offsets within the (chunked) sequence;
    ``q_offset``: absolute position of the sequence start — an int, or a
    per-lane [B] tensor when lanes decode at their own depths (the
    ``cell.scheduler`` continuous-batching path; ``kv_len_valid`` then
    carries the matching per-lane validity bound).

    Both products take float32 operands (the reference multiplies the
    model-dtype operands with float32 accumulation: the same products);
    the probabilities are rounded to V's dtype before P·V, as there.
    Where ``cfg.scores_dtype`` is ``"bfloat16"`` the score product is
    rounded to bf16 and scaled in bf16 (the reference's
    ``preferred_element_type``), and the exact softmax keeps it bf16.
    """
    b, sq, h, dh = q.shape
    sk, kv = k.shape[1], k.shape[2]
    g = h // kv
    qf = q.reshape(b, sq, kv, g, dh)
    s = torch.einsum("bqhgd,bkhd->bhgqk", _f32(qf), _f32(k))
    if cfg.scores_dtype == "float32":
        s = s * (dh ** -0.5)
    else:
        sdt = getattr(torch, cfg.scores_dtype)
        s = s.to(sdt) * torch.tensor(dh ** -0.5, dtype=sdt, device=s.device)
    # mask stays None when nothing masks (full bidirectional attention,
    # e.g. KWT): the softmax paths then skip the select ops entirely and
    # the cuda mode is the raw kernel output, bit-identical to
    # kernels.ops.lut_softmax.
    mask = None
    if causal or kv_len_valid is not None:
        dev = q.device
        kpos = k0 + torch.arange(sk, device=dev)
        if causal:
            qpos = q0 + torch.arange(sq, device=dev)
            if _per_lane(q_offset):
                qpos = q_offset.to(dev)[:, None] + qpos        # [B, sq]
            else:
                qpos = qpos + int(q_offset)                   # [sq]
            mask = qpos[..., :, None] >= kpos
            if cfg.sliding_window:
                # ring caches (causal=False) keep the window by overwrite;
                # the band applies to contiguous layouts only
                mask = mask & (kpos > qpos[..., :, None] - cfg.sliding_window)
        if kv_len_valid is not None:
            if _per_lane(kv_len_valid):
                valid = kpos < kv_len_valid.to(dev)[:, None, None]  # [B,1,sk]
            else:
                valid = (kpos < int(kv_len_valid))[None, :].expand(sq, sk)
            mask = valid if mask is None else mask & valid
        if mask.ndim == 2:                          # [sq, sk]: shared lanes
            mask = mask[None, None, None]           # broadcast over b, kv, g
        else:                                       # [B, ., sk]: per-lane
            mask = mask.expand(b, sq, sk)[:, None, None]
    p = approx.masked_softmax(s, mask, mode=cfg.softmax_mode)
    out = torch.einsum("bhgqk,bkhd->bqhgd", _f32(p.to(v.dtype)), _f32(v))
    return out.reshape(b, sq, h, dh).to(q.dtype)


def sdpa(q, k, v, cfg, *, q_offset=0, kv_len_valid=None, causal=True):
    """Masked GQA attention, plain path, query-chunked.

    The float score product and P·V are outside any hand-written kernel
    in the reference as well and stay plain einsums; the softmax between
    them is ``approx.masked_softmax`` in the plan's mode (the softmax
    kernel on the ``cuda`` plan).  Sequences longer than ``Q_CHUNK``
    queries go in chunks of it, each against the keys it can see (with a
    sliding window, only the keys of its band); that applies only at a
    start position of 0 (a prefill of a fresh cache, or a cacheless
    forward).
    """
    sq, sk = q.shape[1], k.shape[1]
    if sq <= Q_CHUNK:
        return _sdpa_block(q, k, v, cfg, q0=0, k0=0, q_offset=q_offset,
                           kv_len_valid=kv_len_valid, causal=causal)
    if _per_lane(q_offset) or int(q_offset) != 0:
        raise ValueError("chunked attention assumes a start position of 0")
    outs = []
    for q0 in range(0, sq, Q_CHUNK):
        qc = q[:, q0:q0 + Q_CHUNK]
        # the key window of this chunk (positions are left-aligned: a query
        # and a key at the same index share a position)
        khi = min(sk, q0 + qc.shape[1]) if causal else sk
        klo = max(0, q0 - cfg.sliding_window + 1) if cfg.sliding_window else 0
        outs.append(_sdpa_block(
            qc, k[:, klo:khi], v[:, klo:khi], cfg, q0=q0, k0=klo, q_offset=0,
            kv_len_valid=kv_len_valid, causal=causal))
    return torch.cat(outs, dim=1)


def _kv_quantized(cfg) -> bool:
    return bool(cfg.quant and cfg.quant.quantize_kv_cache)


def _use_flash_lut(cfg, kv_len_valid) -> bool:
    """The flash-LUT attention serves the cacheless full / causal layouts;
    an explicit validity bound needs ``sdpa``'s masks."""
    return cfg.attn_impl == "flash_lut" and kv_len_valid is None \
        and not cfg.sliding_window


def apply_attention(p, x, cfg, *, positions=None, cache=None,
                    cache_index=None, kv_len_valid=None, causal=True):
    """Returns (out, new_cache).  ``cache`` = dict(k=[B,S,KV,D], v=...)
    (the int8 cache: ``k`` / ``v`` codes and ``ks`` / ``vs`` scales) or
    None; with a cache, this call's keys and values are written into it
    in place at ``cache_index`` (an int, or a per-lane [B] tensor for a
    one-token decode) and the same dict is returned.  A ring cache (the
    hybrid family's sliding window) passes ``causal=False`` and an explicit
    ``kv_len_valid``: every live slot is a valid past key."""
    if cfg.attn_impl not in ("xla", "flash_lut"):
        raise ValueError(f"unknown attn_impl {cfg.attn_impl!r}")
    with _trace.span("attention"):
        b, sq, d = x.shape
        h, kv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
        _health.tap_activation("attn_in", x, cfg)
        wq, wk, wv = p["wq"], p["wk"], p["wv"]
        if (cfg.int_exec and cfg.act_approx != "cuda"
                and all(isinstance(w, quant.QTensor)
                        and quant.int_exec_supported(w, "bsd,df->bsf")
                        for w in (wq, wk, wv))):
            # one fused integer projection instead of three — bitwise
            # equal to the separate calls (see quant.int_exec_qkv).  The
            # cuda plan sends Q, K and V through the matmul kernel one by
            # one, as the reference's compiled kernel plan does.
            qm = cfg.quant
            q, k, v = quant.int_exec_qkv(
                x, (wq, wk, wv),
                x_exp=qm.input_exponent if qm is not None else 5,
                residual_bits=qm.residual_bits if qm is not None else 16)
        else:
            q = linear(x, wq, "bsd,df->bsf", cfg)
            k = linear(x, wk, "bsd,df->bsf", cfg)
            v = linear(x, wv, "bsd,df->bsf", cfg)
        if "bq" in p:
            q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
        q = q.reshape(b, sq, h, dh)
        k = k.reshape(b, sq, kv, dh)
        v = v.reshape(b, sq, kv, dh)
        if cfg.qk_norm:
            q = _rms(q, p["q_norm"]).to(x.dtype)
            k = _rms(k, p["k_norm"]).to(x.dtype)
        if cfg.use_rope:
            if positions is None:
                positions = torch.arange(sq, device=x.device)
            cos, sin = rope_tables(torch.as_tensor(positions, device=x.device),
                                   dh, cfg.rope_theta)
            cos, sin = cos[..., :, None, :], sin[..., :, None, :]
            q = apply_rope(q, cos, sin)
            k = apply_rope(k, cos, sin)

        if cache is None:
            if _use_flash_lut(cfg, kv_len_valid):
                out = _flash(q, k, v, cfg, causal)
            else:
                out = sdpa(q, k, v, cfg, q_offset=0, kv_len_valid=kv_len_valid,
                           causal=causal)
            new_cache = None
        else:
            idx = cache_index
            if _kv_quantized(cfg):
                (kq, ks), (vq, vs) = _q8_vec(k), _q8_vec(v)
                idx = _write_cache(cache, {"k": kq, "ks": ks, "v": vq,
                                           "vs": vs}, idx, sq)
                ck = _q8_vec_decode(cache["k"], cache["ks"], x.dtype)
                cv = _q8_vec_decode(cache["v"], cache["vs"], x.dtype)
            else:
                idx = _write_cache(cache, {"k": k, "v": v}, idx, sq)
                ck, cv = cache["k"], cache["v"]
            valid = (idx + sq) if kv_len_valid is None else kv_len_valid
            # a write of more than Q_CHUNK tokens is the prefill of a fresh
            # cache (index 0): a start of 0 lets sdpa chunk the queries
            q_off = idx if sq <= Q_CHUNK else 0
            out = sdpa(q, ck, cv, cfg, q_offset=q_off, kv_len_valid=valid,
                       causal=causal)
            new_cache = cache
        out = linear(out.reshape(b, sq, h * dh), p["wo"], "bsf,fd->bsd", cfg)
        if "bo" in p:
            out = out + p["bo"]
        return out.to(x.dtype), new_cache


def _write_cache(cache, new, idx, sq):
    """Write this call's leaves ``new`` (``[B, sq, ...]`` each) into the
    cache's tensors of the same keys, in place, at ``idx``: an int (a
    start that would overrun the cache is clamped, as
    ``lax.dynamic_update_slice`` clamps it in the reference) or a per-lane
    ``[B]`` tensor (one token).  Returns ``idx`` (an int where it was one)."""
    if _per_lane(idx):                       # per-lane decode (cell)
        if sq != 1:
            raise ValueError("a per-lane cache_index is a one-token "
                             "decode path")
        dev = cache["k"].device
        lanes = torch.arange(idx.shape[0], device=dev)
        li = idx.to(dev).long()
        for key, t in new.items():
            cache[key].index_put_((lanes, li), t[:, 0].to(cache[key].dtype))
        return idx
    idx = int(idx)
    at = max(0, min(idx, cache["k"].shape[1] - sq))
    for key, t in new.items():
        cache[key][:, at:at + sq] = t
    return idx


def _flash(q, k, v, cfg, causal):
    """Flash-LUT attention: online softmax with the paper's LUT exp, in
    the [B, H, L, D] layout, as views of the [B, L, H, D] projections: the
    kernel reads them where they lie and lays its output out so that the
    transpose back and the reshape after it are views too.  The cuda plan
    launches the kernel (kernels.ops); every other plan takes its plain
    version at the same key tiles, so a launch counter counts the cuda
    plan only.  The kernel takes one dtype for q, k and v (qk-norm may
    leave v wider)."""
    if not (q.dtype == k.dtype == v.dtype):
        dt = torch.promote_types(torch.promote_types(q.dtype, k.dtype),
                                 v.dtype)
        q, k, v = q.to(dt), k.to(dt), v.to(dt)
    qh, kh, vh = (t.transpose(1, 2) for t in (q, k, v))
    from repro_torch.kernels import ops
    if cfg.act_approx == "cuda":
        out = ops.lut_attention(qh, kh, vh, causal=causal)
    else:
        out = ops.lut_attention_plain(qh, kh, vh, causal=causal)
    return out.transpose(1, 2)


def init_kv_cache(cfg, batch, max_len, dtype=None, device="cpu"):
    """Zero K/V caches [batch, max_len, KV, D]: float in ``dtype``
    (default: the model dtype), or, with ``cfg.quant.quantize_kv_cache``,
    int8 codes ``k`` / ``v`` beside float32 scales ``ks`` / ``vs``
    [batch, max_len, KV] of ones (``dtype`` is then ignored, as in the
    reference: attention decodes the codes into the activations' dtype)."""
    kv, dh = cfg.n_kv_heads, cfg.resolved_head_dim
    if _kv_quantized(cfg):
        codes = (batch, max_len, kv, dh)
        return {"k": torch.zeros(codes, dtype=torch.int8, device=device),
                "ks": torch.ones(codes[:3], dtype=torch.float32,
                                 device=device),
                "v": torch.zeros(codes, dtype=torch.int8, device=device),
                "vs": torch.ones(codes[:3], dtype=torch.float32,
                                 device=device)}
    dt = dtype or _dtype(cfg)
    return {"k": torch.zeros((batch, max_len, kv, dh), dtype=dt, device=device),
            "v": torch.zeros((batch, max_len, kv, dh), dtype=dt, device=device)}


def _q8_vec(x):
    """Per-(token, KV head) power-of-two int8 quantisation of [B,S,KV,D]:
    codes ``round(x / 2^e)`` (half to even) clipped to ±127 and float32
    scales ``2^e``, ``e = ceil(log2(max(maxabs, 1e-30) / 127))``.

    ``e`` is read off the float's bits: ``y = maxabs / 127`` is normal
    (at least 1e-30 / 127), so ``ceil(log2 y)`` is its unbiased exponent,
    plus one unless its mantissa is zero (``y`` a power of two); the scale
    is built from the bits as well.  Both are exact on every device
    (ROADMAP C12)."""
    xf = _f32(x)
    y = xf.abs().amax(dim=-1).clamp(min=1e-30) / 127.0
    bits = y.view(torch.int32)
    e = ((bits >> 23) & 0xFF) - 127 + ((bits & 0x7FFFFF) != 0).to(torch.int32)
    scale = ((e + 127) << 23).view(torch.float32)
    q = torch.round(xf / scale[..., None]).clamp(-127, 127).to(torch.int8)
    return q, scale


def _q8_vec_decode(q, scale, dt):
    """Codes times their scales, in ``dt``."""
    return (q.to(torch.float32) * scale[..., None]).to(dt)


# ---------------------------------------------------------------------------
# MLP (paper eq 6: FFN(x) = act(xW1 + b1)W2 + b2; gated for SiLU-family)
# ---------------------------------------------------------------------------

def kv_cache_specs(cfg, dp=("data",), tp_size=16):
    """Batch over DP; KV heads over TP when they divide by the TP size,
    otherwise the cache's sequence dim over TP."""
    if cfg.n_kv_heads % tp_size == 0:
        s = {"k": P(dp, None, TP, None), "v": P(dp, None, TP, None)}
        if _kv_quantized(cfg):
            s.update({"ks": P(dp, None, TP), "vs": P(dp, None, TP)})
        return s
    s = {"k": P(dp, TP, None, None), "v": P(dp, TP, None, None)}
    if _kv_quantized(cfg):
        s.update({"ks": P(dp, TP, None), "vs": P(dp, TP, None)})
    return s


def mlp_params(cfg, generator, d_ff=None, device="cpu"):
    d, f = cfg.d_model, d_ff or cfg.d_ff
    dt = _dtype(cfg)
    if cfg.gated_mlp:
        return {"w_gate": he(generator, (d, f), 1.0, dt, device),
                "w_up": he(generator, (d, f), 1.0, dt, device),
                "w_down": he(generator, (f, d), 1.0, dt, device)}
    p = {"w1": he(generator, (d, f), 1.0, dt, device),
         "w2": he(generator, (f, d), 1.0, dt, device)}
    if cfg.bias:
        p["b1"] = torch.zeros((f,), dtype=dt, device=device)
        p["b2"] = torch.zeros((d,), dtype=dt, device=device)
    return p


def mlp_specs(cfg):
    f, t = fsdp_axis(cfg), tp_axis(cfg)
    if cfg.gated_mlp:
        return {"w_gate": P(f, t), "w_up": P(f, t), "w_down": P(t, f)}
    s = {"w1": P(f, t), "w2": P(t, f)}
    if cfg.bias:
        s.update({"b1": P(t), "b2": P(None)})
    return s


def apply_mlp(p, x, cfg):
    with _trace.span("mlp"):
        _health.tap_activation("mlp_in", x, cfg)
        act = approx.activation(cfg.activation, cfg.act_approx)
        if cfg.gated_mlp:
            gate = act(linear(x, p["w_gate"], "bsd,df->bsf", cfg))
            up = linear(x, p["w_up"], "bsd,df->bsf", cfg)
            return linear((gate * up).to(x.dtype), p["w_down"],
                          "bsf,fd->bsd", cfg).to(x.dtype)
        h = linear(x, p["w1"], "bsd,df->bsf", cfg)
        if "b1" in p:
            h = h + p["b1"]
        h = act(h).to(x.dtype)
        out = linear(h, p["w2"], "bsf,fd->bsd", cfg)
        if "b2" in p:
            out = out + p["b2"]
        return out.to(x.dtype)
