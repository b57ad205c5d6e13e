"""Plain reference of a dense decoder-only LM (internlm2, arXiv:2403.17297)
as the configuration files state it: pre-norm blocks of RMSNorm, GQA
attention with rotary positions (the two halves of each head rotated),
RMSNorm and a SiLU-gated MLP, then RMSNorm and an untied head.

The plan's numerics: every weight leaf of rank two or more cast by eq 9
per output channel (``numerics.ptq``; a stacked leaf's channel maximum
taken over its layers too); the embedding gathers rows of the cast
table; the blocks run the cast weights' float32 view with a bfloat16
residual stream (each sub-layer's output rounded to bfloat16 before the
residual add), float32 products with TF32 off; the attention is the
flash-LUT online softmax over key tiles of the largest power of two up
to 128 that divides the keys (``attention``); the SiLU
takes the 256-entry sigmoid LUT; the head integer-executes on an eq-9
cast of its input with the INT16 clip.

``logprobs`` returns each position's log-probability of the next token,
computed a layer at a time over the whole call and the head a block of
rows at a time.
"""

from __future__ import annotations

import torch

from bench.ref import numerics as nx

NEG = -1e30
KEY_TILE = 128
Q_CHUNK = 1024
HEAD_ROWS = 1024


def prepare(tree: dict, quant: dict) -> dict:
    """Cast every leaf of rank >= 2 (the stacked norm scales included);
    the head keeps its grid and exponents for the integer product."""
    e, bits, pc = quant["weight_exponent"], quant["bits"], quant["per_channel"]

    def walk(t):
        if isinstance(t, dict):
            return {k: walk(v) for k, v in t.items()}
        return nx.ptq(t, e, bits, pc)[2] if t.ndim >= 2 else t.float()

    out = walk({k: v for k, v in tree.items() if k != "lm_head"})
    q, ex, _ = nx.ptq(tree["lm_head"], e, bits, pc)
    out["lm_head"] = {"q": q.double(), "e": ex}
    return out


def _rms(x, scale, eps=1e-6):
    x = x.float()
    return (x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps)
            * scale).to(torch.bfloat16)


def _mm(x, w):
    return torch.matmul(x.float(), w)


def _rope(x, theta):
    """x [B, S, H, D] float32, positions 0..S-1."""
    s, d = x.shape[1], x.shape[-1]
    half = d // 2
    freqs = 1.0 / (theta ** (torch.arange(half, dtype=torch.float32,
                                          device=x.device) / half))
    ang = torch.arange(s, device=x.device, dtype=torch.float32)[:, None] \
        * freqs
    cos, sin = torch.cos(ang)[:, None], torch.sin(ang)[:, None]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], -1)


def key_tile(n: int) -> int:
    """The largest power of two up to ``KEY_TILE`` that divides ``n``: the
    online rescale is a LUT probe, so the result depends on the tiles."""
    b = min(KEY_TILE, n)
    while n % b:
        b //= 2
    return b


def attention(q, k, v):
    """Causal GQA attention with the LUT exp, online over key tiles:
    q [B, H, S, D], k / v [B, KV, S, D] float32.  Per tile: masked scores
    -1e30, ``m' = max(m, max s)``, ``p = E(m' - s)`` (0 where masked),
    ``l = E(m' - m) l + sum p`` (the sum in float64, rounded once),
    ``acc = E(m' - m) acc + p v``; ``out = acc / l``.  ``E`` is the LUT_EXP
    probe.  Queries go in chunks; a tile that every query of a chunk is
    masked from leaves m, l and acc as they are, so it is not walked."""
    b, h, s, d = q.shape
    kvh = k.shape[1]
    g = h // kvh
    scale = d ** -0.5
    tile = key_tile(s)
    qg = q.reshape(b, kvh, g, s, d)
    out = torch.empty_like(qg)
    for q0 in range(0, s, Q_CHUNK):
        qc = qg[:, :, :, q0:q0 + Q_CHUNK]
        n = qc.shape[3]
        qpos = torch.arange(q0, q0 + n, device=q.device)[:, None]
        m = torch.full((b, kvh, g, n, 1), NEG, device=q.device)
        l = torch.zeros_like(m)
        acc = torch.zeros_like(qc)
        for kt in range(0, q0 + n, tile):
            kk = k[:, :, None, kt:kt + tile]
            vv = v[:, :, None, kt:kt + tile]
            sc = _mm(qc, kk.transpose(-1, -2)) * scale
            valid = qpos >= torch.arange(kt, kt + kk.shape[3],
                                         device=q.device)
            sc = torch.where(valid, sc, NEG)
            m_new = torch.maximum(m, sc.amax(-1, keepdim=True))
            p = torch.where(valid, nx.exp_lut(m_new - sc), 0.0)
            alpha = nx.exp_lut(m_new - m)
            l = alpha * l + p.sum(-1, keepdim=True,
                                  dtype=torch.float64).float()
            acc = alpha * acc + _mm(p, vv)
            m = m_new
        out[:, :, :, q0:q0 + n] = acc / l.clamp(min=1e-30)
    return out.reshape(b, h, s, d)


def logprobs(w: dict, tokens: torch.Tensor, model: dict,
             x_exp: int) -> torch.Tensor:
    """tokens [B, S] -> log p(token[t + 1] | tokens[:t + 1]) [B, S - 1]."""
    bsz, s = tokens.shape
    h, kvh, dh = model["n_heads"], model["n_kv_heads"], model["head_dim"]
    x = w["embed"][tokens.long()].to(torch.bfloat16)
    blocks = w["blocks"]
    for i in range(model["n_layers"]):
        att, mlp = blocks["attn"], blocks["mlp"]
        hn = _rms(x, blocks["ln1"]["scale"][i])
        q = _mm(hn, att["wq"][i]).reshape(bsz, s, h, dh)
        k = _mm(hn, att["wk"][i]).reshape(bsz, s, kvh, dh)
        v = _mm(hn, att["wv"][i]).reshape(bsz, s, kvh, dh)
        q = _rope(q, model["rope_theta"])
        k = _rope(k, model["rope_theta"])
        o = attention(q.transpose(1, 2), k.transpose(1, 2),
                      v.transpose(1, 2))
        o = o.transpose(1, 2).reshape(bsz, s, h * dh)
        x = x + _mm(o, att["wo"][i]).to(torch.bfloat16)
        hn = _rms(x, blocks["ln2"]["scale"][i])
        gate = nx.silu_lut(_mm(hn, mlp["w_gate"][i]))
        up = _mm(hn, mlp["w_up"][i])
        f = _mm((gate * up).to(torch.bfloat16), mlp["w_down"][i])
        x = x + f.to(torch.bfloat16)
    x = _rms(x, w["ln_f"]["scale"]).reshape(bsz * s, -1)
    nxt = tokens[:, 1:].reshape(-1).long()
    rows = torch.arange(bsz * s, device=x.device).reshape(bsz, s)[:, :-1]
    rows = rows.reshape(-1)
    out = torch.empty(rows.numel(), device=x.device)
    head = w["lm_head"]
    for r0 in range(0, rows.numel(), HEAD_ROWS):
        r = rows[r0:r0 + HEAD_ROWS]
        logits = nx.int_linear(x[r], head["q"], head["e"], x_exp)
        logits[:, model["vocab_size"]:] = NEG
        out[r0:r0 + r.numel()] = logits.gather(
            1, nxt[r0:r0 + r.numel(), None])[:, 0] - logits.logsumexp(1)
    return out.reshape(bsz, s - 1)
