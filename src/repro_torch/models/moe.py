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

On a device mesh (``ctx._mesh_active()``) the block runs the
reference's expert-parallel ``shard_map`` branch in local view: every
(data, model) rank routes its own data shard of the tokens and runs the
expert slice ``[m * e_n, (m + 1) * e_n)`` of its model rank ``m`` with
the group-limited capacity ``_capacity(T // dp_total)``; the slices'
outputs are summed over ``"model"``.  An expert stack placed as a
``DTensor`` (``moe_specs``: experts over ``"model"``, ``d_model`` over
``"data"``) is gathered over ``"data"`` by :func:`gather_experts` — the
reference's three ``all_gather`` s, ``w_gate`` / ``w_up`` on dim 1 and
``w_down`` on dim 2 — which ``dist.spmd`` calls when it hands a step's
forward its weights; the branch takes a stack either whole (and slices
it) or as the rank's slice.  The router and the tokens enter
the region replicated over ``"model"``, so their gradients are summed
there.  Sharded and local runs agree where routing drops nothing (C8):
the capacities differ.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import approx
from repro_torch.dist import ctx
from repro_torch.dist.sharding import P
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


def moe_specs(cfg):
    s = {
        "router": P(None, None),
        # EP over 'model' x FSDP over 'data' on the d_model dim; the
        # expert-parallel branch gathers its expert slice over 'data'
        "w_gate": P(L.TP, L.FSDP, None),
        "w_up": P(L.TP, L.FSDP, None),
        "w_down": P(L.TP, None, L.FSDP),
    }
    if cfg.n_shared_experts:
        s["shared"] = L.mlp_specs(cfg)
    return s


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


EXPERT_STACKS = ("w_gate", "w_up", "w_down")


def expert_placements(w) -> tuple:
    """The placements of an expert stack's slice on ``w``'s mesh: ``w``'s
    ``"model"`` shard kept, every other mesh dim replicated."""
    from torch.distributed.tensor import Replicate

    from repro_torch.dist import sharding
    names = sharding.axis_names(w.device_mesh)
    return tuple(pl if names[i] == L.TP else Replicate()
                 for i, pl in enumerate(w.placements))


def gather_experts(w):
    """An expert stack (``DTensor`` placed by ``moe_specs``, a leading
    layer dim allowed) gathered over every mesh axis but ``"model"``:
    this rank's expert slice with the whole ``d_model``."""
    return w.redistribute(w.device_mesh, expert_placements(w)).to_local()


def _apply_moe_ep(p, xt, cfg):
    """The expert-parallel branch over the entered mesh, in local view:
    ``xt`` is this rank's data shard of the tokens (the group-limited
    capacity is its own)."""
    from repro_torch.dist import sharding
    mesh = ctx.current_mesh()
    names = sharding.axis_names(mesh)
    tp = sharding.axis_size(mesh, L.TP)
    m = mesh.get_local_rank(L.TP)
    e_n = padded_experts(cfg) // tp
    C = _capacity(xt.shape[0], cfg)
    wg, wu, wd = (p[k] if p[k].shape[0] == e_n
                  else p[k][m * e_n:(m + 1) * e_n] for k in EXPERT_STACKS)
    router = p["router"]
    if tp > 1:
        group = mesh.get_group(names.index(L.TP))
        xt = ctx.region_enter(xt, group)
        router = ctx.region_enter(router, group)
    gates, idx = _route(xt, router, cfg)
    out = _dispatch_ffn_combine(xt, gates, idx, wg, wu, wd, cfg,
                                e_lo=m * e_n, e_n=e_n, C=C)
    if tp > 1:
        out = ctx.region_exit(out, group)
    return out


def apply_moe(p, x, cfg):
    """x [B, S, D] -> [B, S, D]: routed experts (+ the shared ones)."""
    B, S, D = x.shape
    T = B * S
    xt = x.reshape(T, D)
    if ctx._mesh_active():
        out = _apply_moe_ep(p, xt, cfg)
    else:
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
