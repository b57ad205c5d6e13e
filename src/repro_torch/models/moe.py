"""Mixture-of-Experts block (granite-moe 40e top-8, deepseek-moe 2+64e
top-6), the reference's off-mesh path.

Routing: the router's float32 logits go through ``approx.softmax`` in the
plan's mode (the LUT softmax kernel on the ``cuda`` plan), and each token
takes its ``top_k`` experts *lower index first where probabilities tie*,
as ``jax.lax.top_k`` does: a stable descending sort sliced to k
(:func:`top_k`).  The Q8.24 LUT softmax puts many logits on one ROM
value, so ties are common, and the set of experts, their slot order (the
capacity positions) and the combine all depend on how ties break;
``torch.topk`` breaks them otherwise and is not used.

Dispatch: the reference's group-limited capacity with fixed shapes.  The
flattened ``[T*k]`` (token, choice) slots take positions in their expert
by a cumulative sum over a ``[T*k, Ep]`` one-hot, so an earlier slot has
priority; every slot at or past the capacity ``C`` (:func:`_capacity`)
is dropped, and its token gets nothing from that expert.  The kept rows
fill a ``[Ep, C, D]`` buffer by one ``index_put_``, the expert FFN runs
over all ``Ep`` experts, and the outputs are gathered back and summed
over k with the gates.  No shape depends on the routing, so a layer
needs no host sync.  Capacity drops are part of the specification: the
tokens of one call share it (ROADMAP C8).

The expert count is padded to a multiple of ``EP_PAD``, the reference's
expert-parallel axis; padded experts have weights and are never routed
to.  Dtypes follow ``jnp``'s promotion: under an integer plan the blocks
are a float32 view, so bf16 activations meet float32 expert weights and
the products run in float32, as ``jnp.einsum`` runs them.

The expert-parallel ``shard_map`` branch and ``moe_specs`` wait for
ROADMAP queue A item 4.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import approx
from repro_torch.dist import ctx
from repro_torch.models import layers as L

EP_PAD = 16   # expert count padded to a multiple of the reference's EP axis


def padded_experts(cfg) -> int:
    return -(-cfg.n_experts // EP_PAD) * EP_PAD


def moe_params(cfg, generator, device="cpu"):
    """The reference's leaves: ``router`` [D, E] float32, the expert stacks
    ``w_gate`` / ``w_up`` [Ep, D, Fe] and ``w_down`` [Ep, Fe, D] in the
    model dtype, and the shared experts as one gated MLP of
    ``n_shared_experts * Fe``."""
    E, D, Fe = cfg.n_experts, cfg.d_model, cfg.expert_d_ff
    Ep = padded_experts(cfg)
    dt = getattr(torch, cfg.dtype)
    p = {
        "router": L.he(generator, (D, E), 1.0, torch.float32, device),
        "w_gate": L.he(generator, (Ep, D, Fe), 1.0, dt, device),
        "w_up": L.he(generator, (Ep, D, Fe), 1.0, dt, device),
        "w_down": L.he(generator, (Ep, Fe, D), 1.0, dt, device),
    }
    if cfg.n_shared_experts:
        p["shared"] = L.mlp_params(cfg, generator,
                                   d_ff=cfg.n_shared_experts * Fe,
                                   device=device)
    return p


def _capacity(T: int, cfg) -> int:
    c = int(np.ceil(T * cfg.top_k * cfg.capacity_factor / cfg.n_experts))
    return max(8, -(-c // 8) * 8)   # round up to a multiple of 8


def top_k(x: torch.Tensor, k: int):
    """``jax.lax.top_k`` over the last axis: the k largest values and their
    indices, the lower index first among equal values."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _promoted(a: torch.Tensor, b: torch.Tensor):
    """Both operands in ``jnp``'s promoted dtype (bf16 x f32 -> f32)."""
    if a.dtype == b.dtype:
        return a, b
    dt = torch.promote_types(a.dtype, b.dtype)
    return a.to(dt), b.to(dt)


def _route(xt, router, cfg):
    """xt [T, D] -> (gates [T, k] renormalised, expert ids [T, k])."""
    logits = torch.matmul(*_promoted(xt.to(torch.float32), router))
    probs = approx.softmax(logits, axis=-1, mode=cfg.softmax_mode)
    gates, idx = top_k(probs, cfg.top_k)
    gates = gates / gates.sum(dim=-1, keepdim=True).clamp(min=1e-9)
    return gates, idx


def _expert_ffn(buf, wg, wu, wd, cfg):
    """The gated FFN of every expert at once: buf [E, C, D] -> [E, C, D]
    (``ecd,edf->ecf`` and ``ecf,efd->ecd`` as batched products)."""
    act = approx.activation(cfg.activation, cfg.act_approx)
    g = act(torch.bmm(*_promoted(buf, wg)))
    u = torch.bmm(*_promoted(buf, wu))
    return torch.bmm(*_promoted((g * u).to(buf.dtype), wd))


def _slots(idx, *, e_lo: int, e_n: int, C: int):
    """The capacity positions of the flattened (token, choice) slots for
    experts ``[e_lo, e_lo + e_n)``: ``(lid, pos, keep)``, each ``[T*k]``
    — the local expert id, the slot's position in it (earlier slots
    first) and whether the slot is this slice's and under capacity."""
    fid = idx.reshape(-1)
    mine = (fid >= e_lo) & (fid < e_lo + e_n)
    lid = (fid - e_lo).clamp(0, e_n - 1)
    # jax.nn.one_hot's comparison: F.one_hot checks its indices (a min and
    # a max) on the CPU only, so the card would run other ops than the host
    hot = lid[:, None] == torch.arange(e_n, device=lid.device)
    onehot = (hot & mine[:, None]).long()
    pos = (onehot.cumsum(dim=0) - 1).gather(1, lid[:, None])[:, 0]
    return lid, pos, mine & (pos < C)


def _dispatch_ffn_combine(xt, gates, idx, wg, wu, wd, cfg, *, e_lo, e_n, C):
    """Token -> expert scatter, the expert FFN, gather back and combine,
    for experts ``[e_lo, e_lo + e_n)``.  Dropped slots add zero rows at a
    clipped position (the reference's scatter-add drops them), so the one
    ``index_put_`` accumulates exactly one row into every kept place."""
    T, D = xt.shape
    k = cfg.top_k
    lid, pos, keep = _slots(idx, e_lo=e_lo, e_n=e_n, C=C)
    at = (lid, pos.clamp(0, C - 1))
    src = torch.where(keep[:, None], xt.repeat_interleave(k, dim=0), 0)
    buf = torch.zeros((e_n, C, D), dtype=xt.dtype, device=xt.device)
    buf.index_put_(at, src, accumulate=True)
    y = _expert_ffn(buf, wg, wu, wd, cfg)
    got = torch.where(keep[:, None], y[at], 0)
    return (got.reshape(T, k, D)
            * gates.reshape(T, k, 1).to(xt.dtype)).sum(dim=1)


def apply_moe(p, x, cfg):
    """x [B, S, D] -> [B, S, D]: routed experts (+ the shared ones)."""
    B, S, D = x.shape
    T = B * S
    xt = x.reshape(T, D)
    if ctx._mesh_active():
        raise NotImplementedError(
            "expert-parallel MoE dispatch on a device mesh is not ported "
            "yet: it waits for ROADMAP queue A item 4")
    gates, idx = _route(xt, p["router"], cfg)
    out = _dispatch_ffn_combine(
        xt, gates, idx, p["w_gate"], p["w_up"], p["w_down"], cfg,
        e_lo=0, e_n=padded_experts(cfg), C=_capacity(T, cfg))
    if cfg.n_shared_experts:
        out = out + L.apply_mlp(p["shared"], x, cfg).reshape(T, D)
    return out.reshape(B, S, D).to(x.dtype)


def load_balance_loss(logits: torch.Tensor, idx: torch.Tensor,
                      cfg) -> torch.Tensor:
    """Switch-style auxiliary load-balancing loss (exposed for training)."""
    E = cfg.n_experts
    probs = torch.softmax(logits, dim=-1)
    me = probs.mean(dim=0)
    ce = torch.nn.functional.one_hot(idx[..., 0].long(), E) \
        .to(torch.float32).mean(dim=0)
    return E * (me * ce).sum()
