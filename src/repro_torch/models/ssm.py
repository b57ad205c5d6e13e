"""Selective SSM (Mamba-style) + the Hymba hybrid block (hymba-1.5b).

Hymba runs attention and SSM heads in parallel inside one layer
(arXiv:2411.13676): the block output is the mean of the per-branch
RMS-normalised outputs.  The attention half uses a sliding window
(``cfg.sliding_window``; banded masks in ``layers.sdpa``, a ring KV cache
in decode), beside the O(1)-state mamba half.

The selective scan uses the same chunked log-space-exact formulation as
``rwkv.py`` (a pairwise difference tensor inside the chunk, a Python loop
across chunks where the reference scans).  ``ssm_scan`` builds the
``[B, c, D, N]`` decay of one chunk at a time, never of the whole
sequence.  Plain PyTorch, as it is plain ``jnp`` in the reference.

Technique hooks: SiLU and softplus run through the bounded-domain sigmoid
LUT when ``cfg.act_approx != "exact"`` (``cuda`` included; neither has a
kernel); the attention softmax through ``approx.masked_softmax`` (the
softmax kernel on the ``cuda`` plan).

Dtypes (ROADMAP C9): the block returns the dtype it was given — the mean
of the two branches is cast to the residual's dtype (a no-op wherever the
reference runs), since under an integer plan's float32 block view the
mamba branch comes out float32.  The carried conv tail keeps the dtype of
the state it is written into: ``transformer.init_decode_state`` makes it
in the dtype the blocks compute in (``kv_dtype``), so a decode step's conv
sees the inputs the forward's does.  The reference rounds it to the model
dtype, which is the same wherever it runs; on a bf16 integer plan that
rounding alone set decode 1.4-2.3 % apart from forward on the smoke config
(and flipped a greedy token), against 0.0 unrounded.
"""

from __future__ import annotations

import torch

from repro_torch.core import approx
from repro_torch.dist.sharding import P
from repro_torch.models import layers as L

CHUNK = 16


def mamba_params(cfg, generator, device="cpu"):
    d = cfg.d_model                  # d_inner == d_model (parallel-head budget)
    n = cfg.ssm_state
    dt_rank = cfg.dt_rank or max(d // 16, 1)
    dt = getattr(torch, cfg.dtype)
    f32 = torch.float32
    a = torch.arange(1, n + 1, dtype=f32, device=device)[None].repeat(d, 1)
    return {
        "in_proj": L.he(generator, (d, 2 * d), 1.0, dt, device),
        "conv_w": L.he(generator, (cfg.conv_width, d), 1.0, f32, device),
        "conv_b": torch.zeros((d,), dtype=f32, device=device),
        "x_proj": L.he(generator, (d, dt_rank + 2 * n), 1.0, dt, device),
        "dt_proj": L.he(generator, (dt_rank, d), 1.0, f32, device),
        "dt_bias": torch.full((d,), -4.0, dtype=f32, device=device),
        "A_log": torch.log(a),
        "D": torch.ones((d,), dtype=f32, device=device),
        "out_proj": L.he(generator, (d, d), 1.0, dt, device),
    }


def mamba_specs(cfg):
    return {"in_proj": P(L.FSDP, L.TP), "conv_w": P(None, L.TP),
            "conv_b": P(L.TP), "x_proj": P(L.TP, None),
            "dt_proj": P(None, L.TP), "dt_bias": P(L.TP),
            "A_log": P(L.TP, None), "D": P(L.TP),
            "out_proj": P(L.TP, L.FSDP)}


def mamba_chunk_body(h, chunk, A=None):
    """One chunk of the selective scan.

    h [B,D,N]; chunk = dict(la, dbx [B,c,D,N], C [B,c,N]) — or, so that
    ``[B,S,D,N]`` is never built for a whole sequence, dict(delta, xin
    [B,c,D], bt, C [B,c,N]) with A [D,N], from which la / dbx are built
    for this chunk.  Returns (h_new, y [B,c,D]).
    """
    if "la" in chunk:
        la, dbx, C = chunk["la"], chunk["dbx"], chunk["C"]
    else:
        delta, xin, bt, C = (chunk["delta"], chunk["xin"], chunk["bt"],
                             chunk["C"])
        la = delta[..., None] * A[None, None]                # [B,c,D,N]
        dbx = (delta * xin)[..., None] * bt[:, :, None, :]
    cum = torch.cumsum(la, dim=1)                       # inclusive [B,c,D,N]
    # inter: y_t += C_t . (e^{cum_t} (.) h)
    y = torch.einsum("btn,btdn,bdn->btd", C, torch.exp(cum), h)
    # intra: exact pairwise decay, inclusive lower triangle (j <= t)
    c = la.shape[1]
    diff = cum[:, :, None] - cum[:, None, :]            # [B,c,c,D,N]
    tri = torch.tril(torch.ones((c, c), dtype=torch.bool, device=la.device))
    w = torch.where(tri[None, :, :, None, None], torch.exp(diff), 0.0)
    y = y + torch.einsum("btn,bjdn,btjdn->btd", C, dbx, w)
    total = cum[:, -1:]                                 # [B,1,D,N]
    h_new = (torch.exp(total[:, 0]) * h
             + (dbx * torch.exp(total - cum)).sum(dim=1))
    return h_new, y


def ssm_scan(delta, xin, bt, C, A, h0):
    """delta/xin [B,S,D], bt/C [B,S,N], A [D,N] -> y [B,S,D], h_final.

    Any S: full chunks one after another, then the remainder; the
    ``[B,c,D,N]`` decay tensors are built per chunk."""
    s = delta.shape[1]
    h = h0
    parts = []
    for c0 in range(0, s, CHUNK):
        c1 = min(c0 + CHUNK, s)
        h, y = mamba_chunk_body(
            h, {"delta": delta[:, c0:c1], "xin": xin[:, c0:c1],
                "bt": bt[:, c0:c1], "C": C[:, c0:c1]}, A)
        parts.append(y)
    y = parts[0] if len(parts) == 1 else torch.cat(parts, dim=1)
    return y, h


def ssm_naive(la, dbx, C, h0):
    """Token-at-a-time oracle for tests."""
    h = h0
    ys = []
    for t in range(la.shape[1]):
        h = torch.exp(la[:, t]) * h + dbx[:, t]
        ys.append(torch.einsum("bn,bdn->bd", C[:, t], h))
    return torch.stack(ys, dim=1), h


def apply_mamba(p, x, cfg, state):
    """x [B,S,D]; state = dict(h [B,D,N], conv [B,K-1,D]); returns (out,
    state), the state as new tensors."""
    s = x.shape[1]
    n = cfg.ssm_state
    kw = cfg.conv_width
    xz = L.linear(x, p["in_proj"], "bsd,df->bsf")
    xin, z = xz.chunk(2, dim=-1)
    # causal depthwise conv as kw shifted adds over the carried tail
    xpad = torch.cat([state["conv"].to(xin.dtype), xin], dim=1)
    conv = xpad[:, 0:s] * p["conv_w"][0]
    for i in range(1, kw):
        conv = conv + xpad[:, i:i + s] * p["conv_w"][i]
    conv = conv + p["conv_b"]
    new_conv = xpad[:, -(kw - 1):] if kw > 1 else state["conv"]
    xc = approx.silu(conv, mode=cfg.act_approx).to(x.dtype)
    dbn = L.linear(xc, p["x_proj"], "bsd,df->bsf").to(torch.float32)
    dt_rank = p["dt_proj"].shape[0]
    dtr, B_t, C_t = dbn.split([dt_rank, n, n], dim=-1)
    delta = approx.softplus(L.linear(dtr, p["dt_proj"], "bsr,rd->bsd")
                            + p["dt_bias"], mode=cfg.act_approx)
    A = -torch.exp(p["A_log"])                          # [D,N]
    y, h = ssm_scan(delta, xc.to(torch.float32), B_t, C_t, A, state["h"])
    y = y + p["D"] * xc.to(torch.float32)
    y = y * approx.silu(z.to(torch.float32), mode=cfg.act_approx)
    out = L.linear(y.to(x.dtype), p["out_proj"], "bsd,df->bsf")
    return out, {"h": h, "conv": new_conv.to(state["conv"].dtype)}


def init_mamba_state(cfg, batch, device="cpu", dtype=None):
    """Zero mamba state: h float32, the conv tail in ``dtype`` (default:
    the model dtype)."""
    d, n, kw = cfg.d_model, cfg.ssm_state, cfg.conv_width
    return {"h": torch.zeros((batch, d, n), dtype=torch.float32,
                             device=device),
            "conv": torch.zeros((batch, kw - 1, d),
                                dtype=dtype or getattr(torch, cfg.dtype),
                                device=device)}


def mamba_state_specs(cfg, dp=("data",)):
    return {"h": P(dp, L.TP, None), "conv": P(dp, None, L.TP)}


# ---------------------------------------------------------------------------
# Hymba hybrid block: parallel attention + mamba heads
# ---------------------------------------------------------------------------

def block_params(cfg, generator, device="cpu"):
    return {"ln1": L.norm_params(cfg, device=device),
            "ln2": L.norm_params(cfg, device=device),
            "attn": L.attention_params(cfg, generator, device),
            "mamba": mamba_params(cfg, generator, device),
            "out_norm_a": torch.ones((cfg.d_model,), dtype=torch.float32,
                                     device=device),
            "out_norm_m": torch.ones((cfg.d_model,), dtype=torch.float32,
                                     device=device),
            "mlp": L.mlp_params(cfg, generator, device=device)}


def block_specs(cfg):
    return {"ln1": L.norm_specs(cfg), "ln2": L.norm_specs(cfg),
            "attn": L.attention_specs(cfg), "mamba": mamba_specs(cfg),
            "out_norm_a": P(None), "out_norm_m": P(None),
            "mlp": L.mlp_specs(cfg)}


def _rmsn(x, scale):
    xf = x.to(torch.float32)
    return (xf * torch.rsqrt(xf.square().mean(dim=-1, keepdim=True) + 1e-6)
            * scale).to(x.dtype)


def apply_block(bp, x, cfg, state, *, positions, cache_index=None,
                kv_len_valid=None, ring=False):
    """state = dict(mamba=..., kv=ring cache or absent).  Returns (x,
    new state): the mamba state as new tensors, the ring cache written in
    place and returned as it was given."""
    h = L.apply_norm(bp["ln1"], x, cfg)
    a, new_kv = L.apply_attention(bp["attn"], h, cfg, positions=positions,
                                  cache=state.get("kv"),
                                  cache_index=cache_index,
                                  kv_len_valid=kv_len_valid,
                                  causal=not ring)
    m, new_ms = apply_mamba(bp["mamba"], h, cfg, state["mamba"])
    y = 0.5 * (_rmsn(a, bp["out_norm_a"]) + _rmsn(m, bp["out_norm_m"]))
    x = x + L.keep_dtype(y, x)
    h = L.apply_norm(bp["ln2"], x, cfg)
    x = x + L.apply_mlp(bp["mlp"], h, cfg)
    new_state = {"mamba": new_ms}
    if new_kv is not None:
        new_state["kv"] = new_kv
    return x, new_state
