"""Shared transformer layers, KWT subset: LayerNorm, cacheless attention,
ungated MLP.

Functional style: ``*_params(cfg, generator)`` builds a dict of weights,
``apply_*`` runs the math on ``[B, T, d]`` tensors.  The paper's technique
enters through ``cfg.softmax_mode`` / ``cfg.act_approx`` (LUT
approximations, ``"cuda"`` = the hand-written kernels) and through
QTensor weights (int8 / nibble-packed int4).

Cacheless attention runs either the plain einsum path (``sdpa``,
``cfg.attn_impl == "xla"``) or the flash-LUT attention
(``attn_impl == "flash_lut"``): the hand-written kernel on the ``cuda``
plan, its plain version on every other plan.

``apply_attention`` and ``apply_mlp`` emit the quantisation-health taps
of their inputs (``telemetry.taps``; a no-op without a collector).

Waiting for ROADMAP queue A item 3 (LM families): RMSNorm, RoPE, qk-norm,
GQA KV caches, sliding windows, query-chunked attention and gated MLPs.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import approx
from repro_torch.core import quant
from repro_torch.telemetry import taps as _health

_LATER = "is not ported yet: it waits for ROADMAP queue A item 3 (LM families)"


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
    return torch.einsum(eq, x, w)


def asfloat(w):
    """Dequantise a QTensor consumed outside a matmul (e.g. additive
    positional embeddings); floats pass through untouched."""
    return quant.resident_values(w) if isinstance(w, quant.QTensor) else w


def _dtype(cfg):
    return getattr(torch, cfg.dtype)


def he(generator, shape, scale, dtype, device="cpu"):
    """Scaled-normal initialiser.  Drawn on the CPU from ``generator``
    (one stream of numbers whatever the target device), then moved."""
    fan_in = shape[0] if len(shape) > 1 else max(shape[0], 1)
    w = torch.randn(shape, generator=generator, dtype=torch.float32)
    return (w * (scale / np.sqrt(fan_in))).to(dtype).to(device)


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------

def norm_params(cfg, d=None, device="cpu"):
    d = d or cfg.d_model
    if cfg.norm != "layernorm":
        raise NotImplementedError(f"norm {cfg.norm!r} {_LATER}")
    return {"scale": torch.ones((d,), dtype=torch.float32, device=device),
            "bias": torch.zeros((d,), dtype=torch.float32, device=device)}


def apply_norm(p, x, cfg, eps=1e-6):
    if cfg.norm != "layernorm":
        raise NotImplementedError(f"norm {cfg.norm!r} {_LATER}")
    x = x.to(torch.float32)
    # paper eqs (4)-(5): mean/variance normalise, then gamma/beta.
    mu = x.mean(dim=-1, keepdim=True)
    var = x.var(dim=-1, keepdim=True, unbiased=False)
    y = (x - mu) * torch.rsqrt(var + eps)
    return (y * p["scale"] + p["bias"]).to(_dtype(cfg))


# ---------------------------------------------------------------------------
# Attention (cacheless; full or causal)
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
        raise NotImplementedError(f"qk_norm {_LATER}")
    return p


def sdpa(q, k, v, cfg, *, causal=True):
    """Masked GQA attention in one tile.  q [B,Sq,H,D]; k/v [B,Sk,KV,D].

    The float score product and P·V are outside any hand-written kernel
    in the reference as well and stay plain einsums; the softmax between
    them is ``approx.masked_softmax`` in the plan's mode.
    """
    b, sq, h, dh = q.shape
    sk, kv = k.shape[1], k.shape[2]
    g = h // kv
    qf = q.reshape(b, sq, kv, g, dh)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qf, k).to(torch.float32)
    s = s * (dh ** -0.5)
    # mask stays None when nothing masks (full bidirectional attention,
    # e.g. KWT): the softmax paths then skip the select ops entirely and
    # the cuda mode is the raw kernel output, bit-identical to
    # kernels.ops.lut_softmax.
    mask = None
    if causal:
        qpos = torch.arange(sq, device=q.device)
        kpos = torch.arange(sk, device=q.device)
        mask = (qpos[:, None] >= kpos)[None, None, None]
    p = approx.masked_softmax(s, mask, mode=cfg.softmax_mode)
    out = torch.einsum("bhgqk,bkhd->bqhgd", p.to(v.dtype), v)
    return out.reshape(b, sq, h, dh).to(q.dtype)


def apply_attention(p, x, cfg, *, positions=None, cache=None,
                    kv_len_valid=None, causal=True):
    """Returns (out, new_cache); this slice is cacheless, so the cache is
    always None."""
    if cache is not None or kv_len_valid is not None:
        raise NotImplementedError(f"KV-cache attention {_LATER}")
    if cfg.use_rope or cfg.qk_norm or cfg.sliding_window:
        raise NotImplementedError(f"RoPE / qk-norm / sliding window {_LATER}")
    if cfg.attn_impl not in ("xla", "flash_lut"):
        raise ValueError(f"unknown attn_impl {cfg.attn_impl!r}")
    b, sq, d = x.shape
    h, kv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    _health.tap_activation("attn_in", x, cfg)
    wq, wk, wv = p["wq"], p["wk"], p["wv"]
    if (cfg.int_exec and cfg.act_approx != "cuda"
            and all(isinstance(w, quant.QTensor)
                    and quant.int_exec_supported(w, "bsd,df->bsf")
                    for w in (wq, wk, wv))):
        # one fused integer projection instead of three — bitwise equal to
        # the separate calls (see quant.int_exec_qkv).  The cuda plan sends
        # Q, K and V through the matmul kernel one by one, as the
        # reference's compiled kernel plan does.
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
    if cfg.attn_impl == "flash_lut":
        # flash-LUT attention: online softmax with the paper's LUT exp, in
        # the [B, H, L, D] layout, as views of the [B, L, H, D]
        # projections: the kernel reads them where they lie and lays its
        # output out so that the transpose back and the reshape below are
        # views too.  The cuda plan launches the kernel (kernels.ops);
        # every other plan takes its plain version, so a launch counter
        # counts the cuda plan only.  (The reference sends cached and
        # windowed layouts to sdpa instead; this slice has neither.)
        qh, kh, vh = (t.transpose(1, 2) for t in (q, k, v))
        if cfg.act_approx == "cuda":
            from repro_torch.kernels import ops
            out = ops.lut_attention(qh, kh, vh, causal=causal)
        else:
            from repro_torch.kernels import ref
            out = ref.lut_attention(qh, kh, vh, causal=causal,
                                    softmax_mode="lut")
        out = out.transpose(1, 2)
    else:
        out = sdpa(q, k, v, cfg, causal=causal)
    out = linear(out.reshape(b, sq, h * dh), p["wo"], "bsf,fd->bsd", cfg)
    if "bo" in p:
        out = out + p["bo"]
    return out.to(x.dtype), None


# ---------------------------------------------------------------------------
# MLP (paper eq 6: FFN(x) = act(xW1 + b1)W2 + b2)
# ---------------------------------------------------------------------------

def mlp_params(cfg, generator, d_ff=None, device="cpu"):
    d, f = cfg.d_model, d_ff or cfg.d_ff
    dt = _dtype(cfg)
    if cfg.gated_mlp:
        raise NotImplementedError(f"gated MLP {_LATER}")
    p = {"w1": he(generator, (d, f), 1.0, dt, device),
         "w2": he(generator, (f, d), 1.0, dt, device)}
    if cfg.bias:
        p["b1"] = torch.zeros((f,), dtype=dt, device=device)
        p["b2"] = torch.zeros((d,), dtype=dt, device=device)
    return p


def apply_mlp(p, x, cfg):
    if cfg.gated_mlp:
        raise NotImplementedError(f"gated MLP {_LATER}")
    _health.tap_activation("mlp_in", x, cfg)
    act = approx.activation(cfg.activation, cfg.act_approx)
    h = linear(x, p["w1"], "bsd,df->bsf", cfg)
    if "b1" in p:
        h = h + p["b1"]
    h = act(h).to(x.dtype)
    out = linear(h, p["w2"], "bsf,fd->bsd", cfg)
    if "b2" in p:
        out = out + p["b2"]
    return out.to(x.dtype)
