#!/usr/bin/env python3
"""Where an LM's prefill + decode_step departs from its forward.

    python tools/lm_decode_gap.py [--arch internlm2-1.8b] [--smoke]
        [--device cpu] [--cpu-twin] [--kv8] [--cuda-vs-lut] [--out FILE]

The check of ``chip_smoke.py``'s phases ``lm_internlm2``,
``lm_granite_moe``, ``lm_rwkv6`` and ``lm_hymba`` (a prefill of S - 1
tokens into a decode state of S slots and one ``decode_step``, against the
last logits of ``forward``; tokens [2, 64] from numpy seed 7 — for a
hybrid config no longer than its window, so that the prefill fills the
ring cache (ROADMAP C10) —, weights from seed 0 drawn on the device; a
moe config at the drop-free capacity factor 8.0, as the phase and the
reference's own test take it), taken apart, plan by plan:

- ``layers``: for each block, the last position's output, decode against
  forward: the largest difference over the largest magnitude;
- ``head_in``: the same for the head's input (after the final norm), and
  ``codes_differ``: how many of its eq-9 codes (the integer head's
  quantised input, ``input_exponent``) differ;
- ``rel``: the logits' gap over the real vocabulary, as the phases
  compute it, with ``argmax_equal``;
  ``float_head_rel``: the gap the same two head inputs give through the
  dequantised head in float64, so that ``rel`` less it is what the head's
  quantiser adds;
- ``per_lane_equal``: the decode with a per-lane ``[B]`` index (the
  scheduler's path: scatter write, per-lane masks) against the scalar one,
  ``torch.equal`` (``null`` for hybrid, whose ring caches take a shared
  index only, as in the reference);
- moe only, ``expert_set_agree`` / ``slot_order_agree``: over (layer,
  lane), the share of the last position's routes whose set of experts,
  and whose slot order, the decode step and the forward agree on, and
  ``first_route_flip``: the first layer whose expert sets differ.

Plans: ``cuda``, and with float32 activations; ``lut`` and its variants with a LUT switched off
(``softmax=exact``, ``silu=exact`` — every activation LUT: SiLU, softplus,
rwkv's sigmoid —, both), each with bfloat16 and with float32 activations
(``[dtype]``); ``float``.
``--cpu-twin`` adds the ``cuda`` plan on the host CPU through its kernels'
plain versions, from the same weights, and the card against the host for
forward and for prefill + decode.  ``--kv8`` runs every plan on the int8
KV cache (``QuantConfig(quantize_kv_cache=True)``): the plans with both
LUTs off at float32 activations then show the cache's own share of the
gap, layer by layer (with the float cache they read ~1e-6).  One JSON
object a plan on standard output (and in ``--out``).  Without ``--device`` it takes the card.

``--cuda-vs-lut`` takes the ``cuda`` plan's forward apart from the
``lut`` plan's instead (the same tokens and weights, at the config's
capacity factor and at the drop-free one, each with the model's bf16
and with float32 activations), layer by layer: ``attn_rel``, the
attention sub-layer's output (every position) over its magnitude;
``block_rel``, the block's output; moe only, ``expert_set_agree``, the
share of tokens routed to the same set of experts, and ``dropped``,
the slots each plan drops.  Then ``forced``: the ``lut`` forward again
with each layer's attention output replaced by the ``cuda`` plan's, its
logits against the ``cuda`` plan's (``logits_max_abs``,
``argmax_agree``): zero where the two attentions' masked softmax rules
— the kernel's clip-bin leak renormalised in float32 (``cuda``) against
masked lanes dropped in Q8.24 (``lut``) — are all that sets the plans
apart.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "src"))

from repro_torch import runtime  # noqa: E402
from repro_torch.configs import registry  # noqa: E402
from repro_torch.configs.base import QuantConfig  # noqa: E402
from repro_torch.core import quant  # noqa: E402
from repro_torch.core.tree import tree_map  # noqa: E402
from repro_torch.device import resolve_device  # noqa: E402
from repro_torch.models import moe  # noqa: E402
from repro_torch.models import transformer as lm  # noqa: E402

TOKENS = (2, 64)
DROP_FREE = 8.0     # a moe capacity factor under which no slot drops


class Recorder:
    """Keeps the last position of every block output, of the head's input
    and, in a moe block, of its routes while installed
    (``models.transformer`` looks all three up at call time)."""

    def __init__(self):
        self.blocks, self.head_in, self.routes = [], None, []

    def __enter__(self):
        self._block, self._head = lm.apply_block, lm._head
        self._moe = moe.apply_moe

        def block(*a, **kw):
            x, st = self._block(*a, **kw)
            self.blocks.append(x[:, -1].double().cpu())
            return x, st

        def head(params, x, cfg):
            self.head_in = (x if x.ndim == 2 else x[:, -1]).detach().clone()
            return self._head(params, x, cfg)

        def moe_block(p, x, cfg):
            # every position, as the block routes them: a product of
            # another shape could round the router logits apart
            b, s, d = x.shape
            _, idx = moe._route(x.reshape(b * s, d), p["router"], cfg)
            self.routes.append(idx.reshape(b, s, -1)[:, -1].cpu())
            return self._moe(p, x, cfg)

        lm.apply_block, lm._head = block, head
        moe.apply_moe = moe_block
        return self

    def __exit__(self, *exc):
        lm.apply_block, lm._head = self._block, self._head
        moe.apply_moe = self._moe


def _rel(a, b) -> float:
    a, b = a.double().cpu(), b.double().cpu()
    return float((a - b).abs().max() / b.abs().max())


def _head_weight(eng):
    w = eng.params.get("lm_head")
    if isinstance(w, quant.QTensor):
        return quant.resident_values(w).double()
    return w.double()


def _routes(fwd_routes, dec_routes) -> dict:
    """Route agreement of the last position (moe; empty for dense)."""
    if not dec_routes:
        return {}
    sets = [(f.sort(-1).values == d.sort(-1).values).all(-1)
            for f, d in zip(fwd_routes, dec_routes)]
    order = [(f == d).all(-1) for f, d in zip(fwd_routes, dec_routes)]
    return {"expert_set_agree": float(torch.cat(sets).float().mean()),
            "slot_order_agree": float(torch.cat(order).float().mean()),
            "first_route_flip": next(
                (i for i, ok in enumerate(sets) if not bool(ok.all())), None)}


def _clone(state):
    return {"layers": tree_map(lambda t: t.clone(), state["layers"]),
            "index": state["index"]}


def gap(eng, toks) -> dict:
    """prefill + decode against forward on one plan, taken apart."""
    cfg = eng.exec_cfg
    b, s = toks.shape
    with Recorder() as fwd_rec:
        fwd = eng.forward(toks)[:, -1]
    state = eng.init_decode_state(b, s)
    _, state = eng.prefill(toks[:, :-1], state)
    lanes = None
    if cfg.family != "hybrid":
        lanes = _clone(state)
        lanes["index"] = torch.full((b,), state["index"], dtype=torch.long,
                                    device=eng.device)
    with Recorder() as dec_rec:
        dec, _ = eng.decode_step(toks[:, -1], state)
    per_lane = None
    if lanes is not None:
        per_lane = bool(torch.equal(dec, eng.decode_step(toks[:, -1],
                                                         lanes)[0]))
    layers = [_rel(d, f) for d, f in zip(dec_rec.blocks, fwd_rec.blocks)]
    w = _head_weight(eng)
    hf, hd = fwd_rec.head_in, dec_rec.head_in
    x_exp = cfg.quant.input_exponent if cfg.quant is not None else 5
    codes = int((quant.quantize_act(hf, x_exp)
                 != quant.quantize_act(hd, x_exp)).sum())
    v = cfg.vocab_size        # the pad ids' -1e30 would hide every gap
    last = fwd[:, :v].double().cpu()
    float_head = (hd.double() @ w - hf.double() @ w)[:, :v].abs().max().cpu()
    return {"rel": _rel(dec[:, :v], fwd[:, :v]),
            "argmax_equal": bool(torch.equal(dec.argmax(-1), fwd.argmax(-1))),
            "float_head_rel": float(float_head / last.abs().max()),
            "head_in": _rel(hd, hf), "codes_differ": codes,
            "head_in_numel": hd.numel(),
            "per_lane_equal": per_lane,
            **_routes(fwd_rec.routes, dec_rec.routes),
            "layers": layers,
            "first_layer_over_1e-3": next(
                (i for i, r in enumerate(layers) if r > 1e-3), None)}


def variants(cuda_eng, lut_eng, float_eng):
    """(name, engine): the cuda plan, the same with float32 activations,
    the lut plan with its LUTs switched off one at a time, with bf16 and
    with float32 activations, and the float plan."""
    yield "cuda", cuda_eng
    yield "cuda [float32]", dataclasses.replace(
        cuda_eng, exec_cfg=cuda_eng.exec_cfg.with_(dtype="float32"))
    for dt in ("bfloat16", "float32"):
        tag = f" [{dt}]"
        for name, kw in (("lut", {}),
                         ("lut softmax=exact", {"softmax_mode": "exact"}),
                         ("lut silu=exact", {"act_approx": "exact"}),
                         ("lut softmax=exact silu=exact",
                          {"softmax_mode": "exact", "act_approx": "exact"})):
            yield name + tag, dataclasses.replace(
                lut_eng, exec_cfg=lut_eng.exec_cfg.with_(dtype=dt, **kw))
    yield "float", float_eng


class AttentionTap:
    """While installed, each attention sub-layer's output (every
    position) is kept, in call order; given ``force``, the i-th call
    returns ``force[i]`` instead of its own output."""

    def __init__(self, force=None):
        self.outs, self.force = [], force

    def __enter__(self):
        from repro_torch.models import layers
        self._attn = layers.apply_attention

        def attention(*a, **kw):
            y, nc = self._attn(*a, **kw)
            if self.force is not None:
                y = self.force[len(self.outs)].to(y.dtype)
            self.outs.append(y.detach().clone())
            return y, nc

        layers.apply_attention = attention
        return self

    def __exit__(self, *exc):
        from repro_torch.models import layers
        layers.apply_attention = self._attn


class RouteTap:
    """While installed, every moe block's expert ids ``[T, k]`` and its
    dropped slots are kept (the route taken again on the block's input)."""

    def __init__(self):
        self.idx, self.dropped = [], []

    def __enter__(self):
        self._moe = moe.apply_moe

        def block(p, x, cfg):
            xt = x.reshape(-1, x.shape[-1])
            _, idx = moe._route(xt, p["router"], cfg)
            _, _, keep = moe._slots(idx, e_lo=0,
                                    e_n=moe.padded_experts(cfg),
                                    C=moe._capacity(xt.shape[0], cfg))
            self.idx.append(idx.cpu())
            self.dropped.append(int((~keep).sum()))
            return self._moe(p, x, cfg)

        moe.apply_moe = block
        return self

    def __exit__(self, *exc):
        moe.apply_moe = self._moe


def _set_agree(a, b) -> float:
    return float((a.sort(-1).values == b.sort(-1).values).all(-1)
                 .float().mean())


def cuda_vs_lut(cuda_eng, lut_eng, toks) -> dict:
    """The two plans' forwards of ``toks``, taken apart by layer, and the
    ``lut`` forward with the ``cuda`` plan's attention outputs forced."""
    runs = {}
    for name, eng in (("cuda", cuda_eng), ("lut", lut_eng)):
        with Recorder() as rec, AttentionTap() as tap, RouteTap() as routes:
            logits = eng.forward(toks)
        runs[name] = (logits, rec.blocks, tap.outs, routes)
    (cl, cb, ca, cr), (ll, lb, la, lr) = runs["cuda"], runs["lut"]
    v = cuda_eng.exec_cfg.vocab_size
    out = {"logits_max_abs": float((cl - ll)[..., :v].abs().max()),
           "argmax_agree": float((cl[..., :v].argmax(-1)
                                  == ll[..., :v].argmax(-1)).float().mean()),
           "attn_rel": [_rel(a, b) for a, b in zip(ca, la)],
           "block_rel": [_rel(a, b) for a, b in zip(cb, lb)]}
    if cr.idx:
        out["expert_set_agree"] = [_set_agree(a, b)
                                   for a, b in zip(cr.idx, lr.idx)]
        out["dropped"] = {"cuda": cr.dropped, "lut": lr.dropped}
        out["first_route_flip"] = next(
            (i for i, s in enumerate(out["expert_set_agree"]) if s < 1.0),
            None)
    with AttentionTap(force=ca):
        forced = lut_eng.forward(toks)
    out["forced"] = {
        "logits_max_abs": float((forced - cl)[..., :v].abs().max()),
        "argmax_agree": float((forced[..., :v].argmax(-1)
                               == cl[..., :v].argmax(-1)).float().mean()),
        "equal": bool(torch.equal(forced, cl))}
    return out


def tokens_shape(cfg) -> tuple:
    """``TOKENS``, cut to a hybrid config's window (its smoke window is
    8): a longer prefill leaves the ring cache empty (C10)."""
    if cfg.family == "hybrid":
        return TOKENS[0], min(TOKENS[1], cfg.sliding_window)
    return TOKENS


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="internlm2-1.8b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--device", default=None)
    ap.add_argument("--cpu-twin", action="store_true")
    ap.add_argument("--kv8", action="store_true",
                    help="every plan on the int8 KV cache")
    ap.add_argument("--cuda-vs-lut", action="store_true",
                    help="take the cuda plan's forward apart from the lut "
                         "plan's, layer by layer")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    spec = registry.get(args.arch)
    cfg = spec.smoke if args.smoke else spec.config
    if args.cuda_vs_lut:
        return split_cuda_lut(cfg, dev, emit_to=args.out)
    if cfg.family == "moe":
        cfg = cfg.with_(capacity_factor=DROP_FREE)
    if args.kv8:
        cfg = cfg.with_(quant=QuantConfig(quantize_kv_cache=True))
    out = open(args.out, "w") if args.out else None

    def emit(obj):
        line = json.dumps(obj)
        print(line, flush=True)
        if out is not None:
            out.write(line + "\n")
            out.flush()

    params = lm.init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                            dev)
    shape = tokens_shape(cfg)
    toks = np.random.default_rng(7).integers(
        0, cfg.vocab_size, shape).astype(np.int32)
    plain = dev.type == "cpu"
    cuda_eng = runtime.compile_model(cfg, params, backend="cuda", device=dev,
                                     plain_kernels=plain)
    lut_eng = runtime.compile_model(cfg, params, backend="lut", device=dev)
    float_eng = runtime.compile_model(cfg, params, backend="float", device=dev)
    for name, eng in variants(cuda_eng, lut_eng, float_eng):
        t0 = time.perf_counter()
        emit({"plan": name, "device": str(dev), "model": cfg.name,
              "n_layers": cfg.n_layers, "kv8": args.kv8, **gap(eng, toks),
              "seconds": time.perf_counter() - t0})
    del lut_eng, float_eng
    if args.cpu_twin and dev.type != "cpu":
        t0 = time.perf_counter()
        host = runtime.compile_model(
            cfg, tree_map(lambda t: t.cpu(), params), backend="cuda",
            device="cpu", plain_kernels=True)
        del params
        same = all(torch.equal(a.values.cpu(), b.values) for a, b in (
            (cuda_eng.params["embed"], host.params["embed"]),
            (cuda_eng.params["lm_head"], host.params["lm_head"])))
        row = {"plan": "cuda on the host CPU (plain versions)",
               "device": "cpu", "model": cfg.name, "n_layers": cfg.n_layers,
               "payloads_equal_card": same, **gap(host, toks)}
        card_f = cuda_eng.forward(toks)[:, -1]
        host_f = host.forward(toks)[:, -1]
        decs = []
        for eng in (cuda_eng, host):
            st = eng.init_decode_state(*shape)
            _, st = eng.prefill(toks[:, :-1], st)
            decs.append(eng.decode_step(toks[:, -1], st)[0])
        row.update(card_vs_host_forward_rel=_rel(card_f, host_f),
                   card_vs_host_decode_rel=_rel(decs[0], decs[1]),
                   seconds=time.perf_counter() - t0)
        emit(row)
    if out is not None:
        out.close()
    return 0


def split_cuda_lut(cfg, dev, emit_to=None) -> int:
    """``--cuda-vs-lut``: one JSON object per (capacity factor, dtype)."""
    out = open(emit_to, "w") if emit_to else None
    params = lm.init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                            dev)
    toks = np.random.default_rng(7).integers(
        0, cfg.vocab_size, tokens_shape(cfg)).astype(np.int32)
    cuda_eng = runtime.compile_model(cfg, params, backend="cuda", device=dev,
                                     plain_kernels=dev.type == "cpu")
    lut_eng = runtime.compile_model(cfg, params, backend="lut", device=dev)
    del params
    factors = [cfg.capacity_factor]
    if cfg.family == "moe":
        factors.append(DROP_FREE)
    for cf in factors:
        for dt in dict.fromkeys((cfg.dtype, "float32")):
            t0 = time.perf_counter()
            kw = {"dtype": dt, "capacity_factor": cf}
            row = {"split": "cuda vs lut", "device": str(dev),
                   "model": cfg.name, "n_layers": cfg.n_layers,
                   "capacity_factor": cf, "dtype": dt,
                   **cuda_vs_lut(
                       dataclasses.replace(cuda_eng, exec_cfg=cuda_eng
                                           .exec_cfg.with_(**kw)),
                       dataclasses.replace(lut_eng, exec_cfg=lut_eng
                                           .exec_cfg.with_(**kw)), toks),
                   "seconds": time.perf_counter() - t0}
            line = json.dumps(row)
            print(line, flush=True)
            if out is not None:
                out.write(line + "\n")
    if out is not None:
        out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
