"""AdamW with optional int8 power-of-2-quantised moments.

The int8 moments are the paper's eq-9 primitive applied to optimizer
state: each moment tensor is stored as int8 values plus one power-of-2
scale exponent (dynamic, per tensor, or per layer slice of a stacked
subtree).

Functional API on parameter trees, out of place (no tensor is written in
place, so a checkpoint thread may still be reading the old tree):
  init(params, hp)                 -> opt_state
  update(grads, state, params, hp) -> (new_params, new_state, metrics)

The reference runs stacked-layer subtrees (a leading layer axis) under a
``lax.scan`` over that axis; here that is a plain loop over the layer
slices.  KWT's blocks are a list of per-layer trees, not stacked, and its
configs turn the loop off (``scan_layers=False``).
"""

from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.core.tree import tree_leaves, tree_map


@dataclasses.dataclass(frozen=True)
class HParams:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10000
    min_lr_ratio: float = 0.1
    int8_moments: bool = False


def schedule(step: torch.Tensor, hp: HParams) -> torch.Tensor:
    """Linear warmup + cosine decay to min_lr_ratio."""
    step = step.to(torch.float32)
    warm = step / max(hp.warmup_steps, 1)
    prog = ((step - hp.warmup_steps)
            / max(hp.total_steps - hp.warmup_steps, 1)).clamp(0, 1)
    cos = hp.min_lr_ratio + (1 - hp.min_lr_ratio) * 0.5 * (
        1 + torch.cos(math.pi * prog))
    return hp.lr * torch.where(step < hp.warmup_steps, warm, cos)


# --- int8 moment codec (dynamic power-of-2 scale, eq 9) --------------------

def _q8_encode(x: torch.Tensor, reduce=None) -> dict:
    maxabs = x.abs().max() if reduce is None else reduce.maxabs(x)
    # scale = 2^e with 127 * 2^e >= maxabs  (power-of-2, paper eq 9)
    e = torch.ceil(torch.log2(maxabs.clamp(min=1e-30) / 127.0))
    scale = torch.exp2(e)
    q = torch.round(x / scale).clamp(-127, 127).to(torch.int8)
    return {"q": q, "scale": scale.to(torch.float32)}


def _q8_decode(enc: dict) -> torch.Tensor:
    return enc["q"].to(torch.float32) * enc["scale"]


STACKED_KEYS = ("blocks", "enc_blocks", "dec_blocks")


def init(params, hp: HParams) -> dict:
    """Moments mirror the params (on their devices); int8 moments carry a
    power-of-2 scale — per layer slice for stacked-layer subtrees."""
    def zero_moment(p, stacked):
        if hp.int8_moments:
            scale_shape = (p.shape[0],) if stacked else ()
            return {"q": torch.zeros(p.shape, dtype=torch.int8, device=p.device),
                    "scale": torch.ones(scale_shape, dtype=torch.float32,
                                        device=p.device)}
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)

    def tree_moment(params):
        if not isinstance(params, dict):
            raise TypeError("adamw.init takes a dict parameter tree")
        return {key: tree_map(lambda p, s=(key in STACKED_KEYS):
                              zero_moment(p, s), sub)
                for key, sub in params.items()}

    first = tree_leaves(params)[0]
    return {"m": tree_moment(params), "v": tree_moment(params),
            "step": torch.zeros((), dtype=torch.int32, device=first.device)}


def opt_state_specs(param_specs, hp: HParams):
    """Moment specs mirror the parameter specs (ZeRO-ish); an int8
    moment's scale is replicated."""
    from repro_torch.dist.sharding import P

    def like(spec, stacked):
        if hp.int8_moments:
            return {"q": spec, "scale": P(None) if stacked else P()}
        return spec

    moments = {key: tree_map(lambda sp, s=(key in STACKED_KEYS): like(sp, s),
                             sub) for key, sub in param_specs.items()}
    return {"m": moments, "v": moments, "step": P()}


def global_norm(tree) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(g.to(torch.float32)))
                          for g in tree_leaves(tree)))


def _moment_leaves(tree, hp):
    """Moment leaves in the order of the parameter leaves: an int8 moment
    ``{"q", "scale"}`` is one leaf."""
    if hp.int8_moments and isinstance(tree, dict) and set(tree) == {"q", "scale"}:
        return [tree]
    if isinstance(tree, dict):
        return [leaf for v in tree.values() for leaf in _moment_leaves(v, hp)]
    if isinstance(tree, (list, tuple)):
        return [leaf for v in tree for leaf in _moment_leaves(v, hp)]
    return [tree]


def _unflatten_like(like, leaves):
    it = iter(leaves)
    return tree_map(lambda _: next(it), like)


def _update_subtree(g_t, m_t, v_t, p_t, *, lr, clip, bc1, bc2, hp,
                    reduce=None):
    """Element-wise AdamW over one same-structure subtree.  ``bc1`` /
    ``bc2`` are the bias corrections ``1 - b^step``."""
    def leaf(g, m_enc, v_enc, p):
        g = g.to(torch.float32) * clip
        m = _q8_decode(m_enc) if hp.int8_moments else m_enc
        v = _q8_decode(v_enc) if hp.int8_moments else v_enc
        m = hp.b1 * m + (1 - hp.b1) * g
        v = hp.b2 * v + (1 - hp.b2) * torch.square(g)
        mhat = m / bc1
        vhat = v / bc2
        upd = mhat / (torch.sqrt(vhat) + hp.eps)
        if p.ndim > 1:                       # decoupled WD on matrices only
            upd = upd + hp.weight_decay * p.to(torch.float32)
        new_p = (p.to(torch.float32) - lr * upd).to(p.dtype)
        if hp.int8_moments:
            return new_p, _q8_encode(m, reduce), _q8_encode(v, reduce)
        return new_p, m, v

    out = [leaf(g, m, v, p) for g, m, v, p in
           zip(tree_leaves(g_t), _moment_leaves(m_t, hp),
               _moment_leaves(v_t, hp), tree_leaves(p_t))]
    return tuple(_unflatten_like(p_t, [o[i] for o in out]) for i in range(3))


def _update_stacked(g_t, m_t, v_t, p_t, **kw):
    """The reference's ``lax.scan`` over the leading layer axis as a loop:
    each layer slice is updated on its own (so a slice's rank, which
    decides the weight decay, and an int8 moment's scale are per slice),
    and the slices are stacked back."""
    n = tree_leaves(p_t)[0].shape[0]
    at = lambda t, i: tree_map(lambda x: x[i], t)      # noqa: E731
    outs = [_update_subtree(at(g_t, i), at(m_t, i), at(v_t, i), at(p_t, i),
                            **kw) for i in range(n)]
    return tuple(tree_map(lambda *xs: torch.stack(xs), *[o[j] for o in outs])
                 for j in range(3))


@torch.no_grad()
def update(grads, state, params, hp: HParams, *, scan_stacked: bool = True,
           reduce=None):
    """One AdamW step: ``(new_params, new_state, {"lr", "grad_norm"})``.

    Stacked-layer subtrees (params["blocks"] etc. with a leading
    n_layers axis) are updated one layer slice at a time when
    ``scan_stacked`` (the reference's scan).

    ``params`` and ``state`` placed on a ``DeviceMesh`` (``DTensor``
    leaves) are updated shard by shard on each rank
    (``dist.spmd.update_on_mesh``: ``grads`` are cut to the parameters'
    shards, ``reduce`` takes the global norm and the int8 moments'
    max-abs across the mesh)."""
    from repro_torch.dist import spmd
    if spmd.mesh_of(params) is not None:
        return spmd.update_on_mesh(update, grads, state, params, hp,
                                   scan_stacked=scan_stacked)
    step = state["step"] + 1
    lr = schedule(step, hp)
    gnorm = global_norm(grads) if reduce is None else \
        reduce.norm(tree_leaves(grads))
    floor = gnorm.clamp(min=1e-9)
    clip = torch.clamp(torch.full_like(floor, hp.grad_clip) / floor, max=1.0)
    step_f = step.to(torch.float32)
    kw = dict(lr=lr, clip=clip, bc1=1 - torch.pow(hp.b1, step_f),
              bc2=1 - torch.pow(hp.b2, step_f), hp=hp, reduce=reduce)

    new_p, new_m, new_v = {}, {}, {}
    if not isinstance(params, dict):
        raise TypeError("adamw.update takes a dict parameter tree")
    for key in params:
        g_t, m_t, v_t, p_t = (grads[key], state["m"][key], state["v"][key],
                              params[key])
        stacked = scan_stacked and key in STACKED_KEYS and \
            all(leaf.ndim >= 1 for leaf in tree_leaves(p_t))
        fn = _update_stacked if stacked else _update_subtree
        new_p[key], new_m[key], new_v[key] = fn(g_t, m_t, v_t, p_t, **kw)
    return new_p, {"m": new_m, "v": new_v, "step": step}, \
        {"lr": lr, "grad_norm": gnorm}
