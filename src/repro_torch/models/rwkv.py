"""RWKV-6 "Finch" (attention-free, data-dependent decay) — rwkv6-3b.

Time-mix recurrence per head (head_dim=64):
    S_t = diag(w_t) S_{t-1} + k_t^T v_t          (w_t in (0,1), per channel)
    y_t = r_t (S_{t-1} + diag(u) k_t^T v_t)
with w_t data-dependent (LoRA on the decay, the Finch hallmark).

Computed in chunks of ``CHUNK`` tokens: within a chunk the pairwise decay
factor exp(cum_t - cum_j) is materialised as an exact log-space difference
tensor [B,H,c,c,Dh] — numerically exact, no decay clamping; across chunks
a Python loop carries S (the reference's ``lax.scan``).  The recurrence is
plain PyTorch, as it is plain ``jnp`` in the reference: no kernel of the
reference reaches it.

The paper's technique hooks: RWKV has no softmax; channel-mix's ReLU^2 is
polynomial; the receptance sigmoid uses the bounded-domain LUT when
``cfg.act_approx != "exact"`` (the ``cuda`` plan included); int8 PTQ
applies to every leaf of rank >= 2 (``runtime.QuantRecipe``).

Dtypes (ROADMAP C9): a block returns the dtype it was given.  Under an
integer-executing plan the blocks are a float32 view of the stored
integers, so at ``dtype="bfloat16"`` the projections come out float32;
the reference then widens the residual stream inside its layer scan and
raises.  Here the time-mix and channel-mix outputs are cast to the
input's dtype, which is a no-op wherever the reference runs.

Projections are plain einsums that promote as ``jnp.einsum`` does
(``layers.linear`` without a config): the reference multiplies with
``jnp.einsum`` too, never through the integer matmul.
"""

from __future__ import annotations

import torch

from repro_torch.core import approx
from repro_torch.dist.sharding import P
from repro_torch.models import layers as L

CHUNK = 16
HEAD_DIM = 64
LORA_DIM = 64


def n_heads(cfg) -> int:
    """Head count, padded to a multiple of 16 when ``cfg.rwkv_head_pad``
    (zero-initialised pad heads are function-preserving)."""
    h = cfg.d_model // HEAD_DIM
    if cfg.rwkv_head_pad:
        h = -(-h // 16) * 16
    return h


def _pad_cols(w, inner, d_out):
    """Zero-pad a [*, inner_real] projection to [*, d_out] (pad heads)."""
    if w.shape[-1] == d_out:
        return w
    pad = torch.zeros(w.shape[:-1] + (d_out - w.shape[-1],), dtype=w.dtype,
                      device=w.device)
    return torch.cat([w, pad], dim=-1)


def _sigmoid(x, cfg):
    return (approx.sigmoid_lut(x) if cfg.act_approx != "exact"
            else torch.sigmoid(x.to(torch.float32)))


def time_mix_params(cfg, generator, device="cpu"):
    d = cfg.d_model
    dt = getattr(torch, cfg.dtype)
    h = n_heads(cfg)
    di = h * HEAD_DIM                 # inner width (padded when head_pad)
    f32 = torch.float32

    def proj():
        return _pad_cols(L.he(generator, (d, d), 1.0, dt, device), d, di)

    if cfg.rwkv_fused_proj:
        mats = {"wrkvg": torch.cat([proj() for _ in range(4)], dim=1)}
    else:
        mats = {name: proj() for name in ("wr", "wk", "wv", "wg")}
    wo = L.he(generator, (d, d), 1.0, dt, device)
    if di != d:
        wo = torch.cat([wo, torch.zeros((di - d, d), dtype=dt, device=device)])
    return {
        # static token-shift interpolation vectors (mu_r/k/v/w/g)
        "mu": torch.full((5, d), 0.5, dtype=f32, device=device),
        **mats,
        "wo": wo,
        # data-dependent decay: w_t = exp(-exp(w0 + tanh(x A) B))
        "w0": torch.full((di,), -5.0, dtype=f32, device=device),
        "wA": L.he(generator, (d, LORA_DIM), 1.0, f32, device),
        "wB": _pad_cols(L.he(generator, (LORA_DIM, d), 0.1, f32, device),
                        d, di),
        "u": torch.zeros((h, HEAD_DIM), dtype=f32, device=device),   # bonus
        "ln_x": torch.ones((di,), dtype=f32, device=device),  # group norm
    }


def time_mix_specs(cfg):
    tp = L.TP                                      # proj out dims always TP
    hspec = L.TP if cfg.rwkv_head_pad else None    # padded heads over TP
    proj = ({"wrkvg": P(L.FSDP, tp)} if cfg.rwkv_fused_proj else
            {"wr": P(L.FSDP, tp), "wk": P(L.FSDP, tp),
             "wv": P(L.FSDP, tp), "wg": P(L.FSDP, tp)})
    return {"mu": P(None, None), **proj,
            "wo": P(tp, L.FSDP),
            "w0": P(tp), "wA": P(None, None), "wB": P(None, tp),
            "u": P(hspec, None), "ln_x": P(tp)}


def channel_mix_params(cfg, generator, device="cpu"):
    d, f = cfg.d_model, cfg.d_ff
    dt = getattr(torch, cfg.dtype)
    return {"mu": torch.full((2, d), 0.5, dtype=torch.float32, device=device),
            "wk": L.he(generator, (d, f), 1.0, dt, device),
            "wv": L.he(generator, (f, d), 1.0, dt, device),
            "wr": L.he(generator, (d, d), 1.0, dt, device)}


def channel_mix_specs(cfg):
    f, t = L.fsdp_axis(cfg), L.tp_axis(cfg)
    return {"mu": P(None, None), "wk": P(f, t),
            "wv": P(t, f), "wr": P(f, t)}


def _token_shift(x, x_prev):
    """x [B,S,D]; x_prev [B,1,D] (last token of the previous segment)."""
    return torch.cat([x_prev, x[:, :-1]], dim=1)


def _mix(x, xx, mu):
    return x + (xx - x) * mu


def chunk_body(S, chunk, u):
    """One chunk of the wkv recurrence.

    S [B,H,Dk,Dv]; chunk = dict(r,k,v [B,H,c,Dh], lw [B,H,c,Dh] = log w).
    Returns (S_new, y [B,H,c,Dh]).
    """
    r, k, v, lw = chunk["r"], chunk["k"], chunk["v"], chunk["lw"]
    cum = torch.cumsum(lw, dim=2)                     # inclusive  [B,H,c,D]
    cumx = cum - lw                                   # exclusive
    # inter-chunk: y_t += (r_t . e^{cumx_t}) @ S
    y = torch.einsum("bhtd,bhde->bhte", r * torch.exp(cumx), S)
    # intra-chunk: exact log-space pairwise decay, strictly lower-triangular
    diff = cumx[:, :, :, None, :] - cum[:, :, None, :, :]   # [B,H,c,c,D]
    c = r.shape[2]
    tri = torch.tril(torch.ones((c, c), dtype=torch.bool, device=r.device),
                     diagonal=-1)[None, None, :, :, None]
    amat = (torch.where(tri, torch.exp(diff), 0.0)
            * r[:, :, :, None, :] * k[:, :, None, :, :]).sum(dim=-1)
    # diagonal bonus term: A[t,t] = sum_d r u k
    adiag = torch.einsum("bhtd,hd,bhtd->bht", r, u, k)
    eye = torch.eye(c, dtype=amat.dtype, device=amat.device)
    amat = amat + eye[None, None] * adiag[:, :, :, None]
    y = y + torch.einsum("bhtj,bhje->bhte", amat, v)
    # state update: S' = e^{cum_c} . S + sum_j (k_j e^{cum_c - cum_j}) v_j
    total = cum[:, :, -1:, :]                          # [B,H,1,D]
    S_new = (torch.exp(total[:, :, 0, :, None]) * S
             + torch.einsum("bhjd,bhje->bhde", k * torch.exp(total - cum), v))
    return S_new, y


def wkv_scan(r, k, v, lw, u, S0):
    """Chunked scan over time.  r/k/v/lw [B,H,S,Dh] -> y, S_final.

    Any S: full chunks one after another, then the remainder (and
    S < CHUNK, e.g. decode) as one direct ``chunk_body`` call.
    """
    s = r.shape[2]
    S = S0
    parts = []
    for c0 in range(0, s, CHUNK):
        c1 = min(c0 + CHUNK, s)
        S, y = chunk_body(S, {"r": r[:, :, c0:c1], "k": k[:, :, c0:c1],
                              "v": v[:, :, c0:c1], "lw": lw[:, :, c0:c1]}, u)
        parts.append(y)
    y = parts[0] if len(parts) == 1 else torch.cat(parts, dim=2)
    return y, S


def wkv_naive(r, k, v, lw, u, S0):
    """Step-by-step oracle for tests: same math, one token at a time."""
    S = S0
    ys = []
    for t in range(r.shape[2]):
        rt, kt, vt, lwt = r[:, :, t], k[:, :, t], v[:, :, t], lw[:, :, t]
        kv = kt[..., :, None] * vt[..., None, :]          # [B,H,Dk,Dv]
        ys.append(torch.einsum("bhd,bhde->bhe", rt,
                               S + u[None, :, :, None] * kv))
        S = torch.exp(lwt)[..., None] * S + kv
    return torch.stack(ys, dim=2), S


def apply_time_mix(p, x, cfg, state):
    """state = dict(S [B,H,Dk,Dv], x_prev [B,1,D]); returns (out, state),
    the state as new tensors."""
    b, s, d = x.shape
    h = n_heads(cfg)
    xx = _token_shift(x, state["x_prev"])
    xf, xxf = x.to(torch.float32), xx.to(torch.float32)
    mr, mk, mv, mw, mg = p["mu"].unbind(0)
    dt = x.dtype
    if "wrkvg" in p:
        # fused projection: the four token-shift mixes stacked on a new
        # leading axis and contracted in one product
        mixed = torch.stack([_mix(xf, xxf, m).to(dt)
                             for m in (mr, mk, mv, mg)], dim=0)  # [4,B,S,D]
        di = p["wrkvg"].shape[1] // 4
        w4 = p["wrkvg"].reshape(p["wrkvg"].shape[0], 4, di)
        r, k, v, g = L.linear(mixed, w4, "nbsd,dnf->nbsf").unbind(0)
    else:
        r, k, v, g = (L.linear(_mix(xf, xxf, m).to(dt), p[name], "bsd,df->bsf")
                      for m, name in ((mr, "wr"), (mk, "wk"), (mv, "wv"),
                                      (mg, "wg")))
    xw = _mix(xf, xxf, mw)
    lw_raw = p["w0"] + L.linear(
        torch.tanh(L.linear(xw, p["wA"], "bsd,dl->bsl")), p["wB"],
        "bsl,lf->bsf")
    lw = -torch.exp(lw_raw.to(torch.float32))          # log w_t  (< 0)

    di = h * HEAD_DIM

    def heads(a):
        return a.reshape(b, s, h, HEAD_DIM).transpose(1, 2).to(torch.float32)

    y, S = wkv_scan(heads(r), heads(k), heads(v), heads(lw), p["u"],
                    state["S"])
    y = y.transpose(1, 2)
    # per-head group norm + gate
    y = y * torch.rsqrt(y.square().mean(dim=-1, keepdim=True) + 1e-6)
    y = (y.reshape(b, s, di) * p["ln_x"]).to(dt)
    y = y * _sigmoid(g, cfg).to(dt)
    out = L.linear(y, p["wo"], "bsd,df->bsf")
    return L.keep_dtype(out, x), {"S": S, "x_prev": x[:, -1:, :]}


def apply_channel_mix(p, x, cfg, state):
    xx = _token_shift(x, state["x_prev"])
    xf, xxf = x.to(torch.float32), xx.to(torch.float32)
    mk, mr = p["mu"][0], p["mu"][1]
    dt = x.dtype
    k = L.linear(_mix(xf, xxf, mk).to(dt), p["wk"], "bsd,df->bsf")
    k = k.to(torch.float32).clamp(min=0.0).square().to(dt)      # ReLU^2
    v = L.linear(k, p["wv"], "bsf,fd->bsd")
    rr = L.linear(_mix(xf, xxf, mr).to(dt), p["wr"], "bsd,df->bsf")
    out = _sigmoid(rr, cfg).to(dt) * v
    return L.keep_dtype(out, x), {"x_prev": x[:, -1:, :]}


# ---------------------------------------------------------------------------
# Full block
# ---------------------------------------------------------------------------

def block_params(cfg, generator, device="cpu"):
    return {"ln1": L.norm_params(cfg, device=device),
            "ln2": L.norm_params(cfg, device=device),
            "tmix": time_mix_params(cfg, generator, device),
            "cmix": channel_mix_params(cfg, generator, device)}


def block_specs(cfg):
    return {"ln1": L.norm_specs(cfg), "ln2": L.norm_specs(cfg),
            "tmix": time_mix_specs(cfg), "cmix": channel_mix_specs(cfg)}


def apply_block(bp, x, cfg, state):
    """One block; returns (x, new per-layer state as new tensors)."""
    h, s1 = apply_time_mix(bp["tmix"], L.apply_norm(bp["ln1"], x, cfg), cfg,
                           state["tmix"])
    x = x + h
    h, s2 = apply_channel_mix(bp["cmix"], L.apply_norm(bp["ln2"], x, cfg),
                              cfg, state["cmix"])
    return x + h, {"tmix": s1, "cmix": s2}


def init_layer_state(cfg, batch, device="cpu"):
    d = cfg.d_model
    h = n_heads(cfg)
    dt = getattr(torch, cfg.dtype)
    return {
        "tmix": {"S": torch.zeros((batch, h, HEAD_DIM, HEAD_DIM),
                                  dtype=torch.float32, device=device),
                 "x_prev": torch.zeros((batch, 1, d), dtype=dt, device=device)},
        "cmix": {"x_prev": torch.zeros((batch, 1, d), dtype=dt, device=device)},
    }


def state_specs(cfg, dp=("data",)):
    hspec = L.TP if cfg.rwkv_head_pad else None
    return {
        "tmix": {"S": P(dp, hspec, None, None), "x_prev": P(dp, None, None)},
        "cmix": {"x_prev": P(dp, None, None)},
    }
