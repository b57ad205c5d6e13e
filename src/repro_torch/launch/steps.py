"""Step builders: per (architecture x shape) train / prefill / decode
steps and their input specs, for every family on one device.

``make_train_step(cfg, shape, hp)`` -> ``(params, opt_state, batch) ->
(params, opt_state, metrics)``, and its quantisation-aware mode (``qat=``,
``repro_torch.qat.train``); ``make_prefill_step`` / ``make_decode_step``
-> ``(params, state, batch) -> (logits, state)``.

The reference jits one program per step; here a step is eager PyTorch:
the loss forward records a graph, ``torch.autograd.grad`` takes the
gradients of every parameter leaf, and ``optim.adamw.update`` writes new
tensors.  Microbatches accumulate float32 gradients in a loop.  The
reference's ``ShapeDtypeStruct`` trees (``input_specs``, ``params_shape``,
``decode_state_shape``) are tensors on the ``meta`` device: shape and
dtype, no storage.  ``make_train_step(..., sync_mesh=)`` adds the
compressed gradient sync (``dist.compress``).

The sharding trees are the reference's: ``param_pspecs``,
``batch_pspec``, ``decode_state_pspecs`` (trees of
``dist.sharding.P``), ``seq_axis_for`` (the Megatron-SP cells),
``dp_for`` and ``microbatches`` over a mesh.  ``build_step_program``
assembles a :class:`Program` — the step function, its meta-tensor
arguments and per-leaf :class:`NamedSharding` s (spec and placements).
A step built here runs sharded when its parameters are placed on a
``DeviceMesh`` (``dist.sharding.place``): ``dist.spmd`` gathers the
weights, takes the rank's data shard of the batch, runs the step's
gradients under ``ctx.mesh_context`` and means them over the data
ranks, and ``optim.adamw.update`` updates each rank's shards.
A prefill or decode step runs on a mesh the same way
(``spmd.serve_on_mesh``).

``lower_program`` walks a program once on its placed arguments (meta
tensors on a fake production mesh, ``launch.mesh.make_production_mesh``)
and reads its memory, cost and collectives from the ATen records;
``cost_programs`` is the reference's while-free decomposition of a cell
into component programs and multipliers.  Both feed the dry run
(``launch.dryrun``).
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch.analysis import op_walk
from repro_torch.configs.base import ModelConfig, ShapeSpec
from repro_torch.core.tree import tree_leaves, tree_map
from repro_torch.dist import sharding, spmd
from repro_torch.dist.sharding import P
from repro_torch.launch import mesh as meshlib
from repro_torch.models import encdec as E
from repro_torch.models import layers as L
from repro_torch.models import rwkv
from repro_torch.models import transformer as T
from repro_torch.optim import adamw
from repro_torch.runtime.engine import _model_module

Pytree = Any

# the reference's grad-accumulation microbatch counts (chosen there so
# that per-device activation checkpoints fit a TPU pod slice's memory)
MICROBATCHES = {
    ("nemotron-4-340b", "train_4k"): 16,
    ("chameleon-34b", "train_4k"): 16,
    ("qwen2.5-14b", "train_4k"): 8,
    ("granite-8b", "train_4k"): 8,
    ("deepseek-moe-16b", "train_4k"): 8,
    ("granite-moe-3b-a800m", "train_4k"): 2,
    ("internlm2-1.8b", "train_4k"): 2,
    ("rwkv6-3b", "train_4k"): 4,
    ("hymba-1.5b", "train_4k"): 4,
    ("whisper-large-v3", "train_4k"): 4,
}

# archs whose optimizer state is int8 (the reference's table; a smoke
# config keeps its arch's name, so it trains with int8 moments too)
INT8_MOMENT_ARCHS = {"nemotron-4-340b", "deepseek-moe-16b", "chameleon-34b",
                     "qwen2.5-14b"}

# archs whose train / prefill activations also shard the SEQUENCE dim
# over the TP axis (Megatron-SP; the reference's table)
SEQ_SHARD = {("nemotron-4-340b", "train_4k"), ("chameleon-34b", "train_4k"),
             ("nemotron-4-340b", "prefill_32k"),
             ("chameleon-34b", "prefill_32k")}

def seq_axis_for(cfg: ModelConfig, shape: ShapeSpec):
    return "model" if (cfg.name, shape.name) in SEQ_SHARD else None


def hparams_for(cfg: ModelConfig) -> adamw.HParams:
    return adamw.HParams(int8_moments=cfg.name in INT8_MOMENT_ARCHS)


def microbatches(cfg: ModelConfig, shape: ShapeSpec, mesh=None) -> int:
    """Gradient-accumulation microbatches of the reference's table (1 for
    any other arch or shape); over a mesh each microbatch must still
    split over every data-parallel device."""
    n = MICROBATCHES.get((cfg.name, shape.name), 1)
    if mesh is not None:
        dp_total = spmd.dp_total(mesh, meshlib.dp_axes(mesh))
        n = max(1, min(n, shape.global_batch // dp_total))
        while shape.global_batch % (n * dp_total):
            n -= 1
    return n


def model_module(cfg: ModelConfig):
    """The model module of ``cfg``'s family: ``models.kwt``,
    ``models.encdec`` for whisper, or ``models.transformer`` for the
    dense, moe, rwkv and hybrid LMs."""
    return _model_module(cfg)


# ---------------------------------------------------------------------------
# Input specs (meta tensors: shape and dtype, no storage)
# ---------------------------------------------------------------------------

def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def input_specs(cfg: ModelConfig, shape: ShapeSpec) -> dict:
    """Model inputs for one step of the given shape (no state, no
    params): int32 token ids, encdec frames in the model dtype."""
    gb, s = shape.global_batch, shape.seq_len
    i32 = torch.int32
    out = {}
    if cfg.family == "encdec" and shape.kind != "decode":
        out["frames"] = _meta((gb, cfg.enc_seq, cfg.d_model),
                              getattr(torch, cfg.dtype))
    if shape.kind == "decode":
        return {"token": _meta((gb,), i32)}
    out["tokens"] = _meta((gb, s), i32)
    if shape.kind == "train":
        out["labels"] = _meta((gb, s), i32)
    return out


# a stacked block tree -> the config field that counts its layers
_LAYER_COUNTS = {"blocks": "n_layers", "dec_blocks": "n_layers",
                 "enc_blocks": "n_enc_layers"}


def params_shape(cfg: ModelConfig):
    """The parameter tree as meta tensors (``jax.eval_shape`` of
    ``init_params``).  A stack of zero layers (the cost decomposition's
    no-blocks config) has leaves of leading dim 0, as the reference's."""
    mod = model_module(cfg)
    fields = {"n_layers"} | ({"n_enc_layers"} if cfg.family == "encdec"
                             else set())
    zero = {f: 1 for f in fields
            if cfg.family != "kwt" and getattr(cfg, f) == 0}
    p = mod.init_params(cfg.with_(**zero), torch.Generator(), "meta")
    for key, field in _LAYER_COUNTS.items():
        if key in p and field in zero:
            p[key] = tree_map(lambda a: _meta((0,) + tuple(a.shape[1:]),
                                              a.dtype), p[key])
    return p


def decode_state_shape(cfg: ModelConfig, shape: ShapeSpec):
    """The decode state for ``shape`` as meta tensors (``index`` an int)."""
    return model_module(cfg).init_decode_state(
        cfg, shape.global_batch, shape.seq_len, device="meta")


def batch_pspec(cfg: ModelConfig, shape: ShapeSpec, dp) -> dict:
    """The batch's specs: its leading dim over the ``dp`` axes."""
    bp, b2, b3 = P(dp), P(dp, None), P(dp, None, None)
    if shape.kind == "decode":
        return {"token": bp}
    out = {"frames": b3} if cfg.family == "encdec" else {}
    out["tokens"] = b2
    if shape.kind == "train":
        out["labels"] = b2
    return out


def dp_for(shape: ShapeSpec, mesh):
    """The DP axes of this cell; ``None`` when the global batch cannot
    split over every DP device (long_500k's batch of 1 is replicated)."""
    dp = meshlib.dp_axes(mesh)
    return dp if shape.global_batch % spmd.dp_total(mesh, dp) == 0 else None


def param_pspecs(cfg: ModelConfig):
    return model_module(cfg).param_specs(cfg)


def decode_state_pspecs(cfg: ModelConfig, dp, tp_size=16):
    return model_module(cfg).decode_state_specs(cfg, dp, tp_size)


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A spec on a mesh (``jax.sharding.NamedSharding``): ``placements``
    are the ``torch.distributed.tensor`` ones of a ``DeviceMesh`` of the
    same axis names."""

    mesh: Any
    spec: P

    @property
    def placements(self) -> tuple:
        return sharding.placements(self.spec, self.mesh)


@dataclasses.dataclass
class Program:
    """A step with its example arguments (meta tensors) and a
    same-structure :class:`NamedSharding` tree for each argument."""

    name: str
    fn: Any
    args: tuple
    shardings: tuple
    multiplier: float = 1.0
    donate: tuple = ()
    seq_axis: str | None = None   # Megatron-SP activation sharding
    dp: Any = "auto"              # DP axes override (None = replicated batch)


def _named(mesh, tree):
    return tree_map(lambda spec: NamedSharding(mesh, spec), tree)


def build_step_program(cfg: ModelConfig, shape: ShapeSpec, mesh,
                       n_micro=None) -> Program:
    """The whole step of a cell: train (donating params and optimizer
    state; ``n_micro`` microbatches, by default :func:`microbatches`),
    prefill or decode (donating the decode state)."""
    dp = dp_for(shape, mesh)
    batch = input_specs(cfg, shape)
    batch_sh = _named(mesh, batch_pspec(cfg, shape, dp))
    p_meta = params_shape(cfg)
    p_sh = _named(mesh, param_pspecs(cfg))
    if shape.kind == "train":
        hp = hparams_for(cfg)
        opt_meta = adamw.init(p_meta, hp)
        opt_sh = _named(mesh, adamw.opt_state_specs(param_pspecs(cfg), hp))
        fn = make_train_step(cfg, shape, hp, n_micro=n_micro
                             or microbatches(cfg, shape, mesh))
        return Program(f"{cfg.name}:{shape.name}:train", fn,
                       (p_meta, opt_meta, batch), (p_sh, opt_sh, batch_sh),
                       donate=(0, 1), seq_axis=seq_axis_for(cfg, shape),
                       dp=dp)
    state = decode_state_shape(cfg, shape)
    state_sh = _named(mesh, decode_state_pspecs(
        cfg, dp, sharding.axis_size(mesh, "model")))
    if shape.kind == "prefill":
        return Program(f"{cfg.name}:{shape.name}:prefill",
                       make_prefill_step(cfg, shape),
                       (p_meta, state, batch), (p_sh, state_sh, batch_sh),
                       donate=(1,), seq_axis=seq_axis_for(cfg, shape), dp=dp)
    return Program(f"{cfg.name}:{shape.name}:decode",
                   make_decode_step(cfg, shape),
                   (p_meta, state, batch), (p_sh, state_sh, batch_sh),
                   donate=(1,), dp=dp)


# ---------------------------------------------------------------------------
# Lowering: a program walked once on its placed arguments
# ---------------------------------------------------------------------------

# the ATen names of the c10d and functional collectives (the mesh step's
# and DTensor's), by the reference's HLO kinds
_COLLECTIVE_KINDS = {
    "allreduce_": "all-reduce", "all_reduce": "all-reduce",
    "allgather_": "all-gather", "_allgather_base_": "all-gather",
    "all_gather_into_tensor": "all-gather",
    "reduce_scatter_": "reduce-scatter",
    "reduce_scatter_tensor": "reduce-scatter",
    "alltoall_base_": "all-to-all", "all_to_all_single": "all-to-all",
}


class _Uncached(Exception):
    pass


_SCALAR_ARGS = (bool, int, float, str, torch.dtype, torch.device,
                torch.memory_format, torch.layout)
_FUNCTIONAL: dict = {}       # OpOverload -> returns fresh tensors only


def _functional(func) -> bool:
    hit = _FUNCTIONAL.get(func)
    if hit is None:
        sch = func._schema
        hit = _FUNCTIONAL[func] = func.namespace == "aten" and \
            bool(sch.returns) and all(
            r.alias_info is None and r.type.kind() == "TensorType"
            for r in sch.returns) and not any(
            a.alias_info is not None and a.alias_info.is_write
            for a in sch.arguments)
    return hit


def _sig(a):
    """A hashable signature of an op argument (meta tensors by shape,
    strides, offset and dtype); anything else raises :class:`_Uncached`."""
    if isinstance(a, torch.Tensor):
        if type(a) is not torch.Tensor or a.device.type != "meta":
            raise _Uncached
        return (tuple(a.shape), a.stride(), a.storage_offset(), a.dtype)
    if isinstance(a, (list, tuple)):
        return tuple(map(_sig, a))
    if a is None or isinstance(a, _SCALAR_ARGS):
        return (type(a), a)
    raise _Uncached


def _flat(x, out: list) -> list:
    """The tensors of an op's arguments or results (lists, tuples and
    dicts walked), in order."""
    if isinstance(x, torch.Tensor):
        out.append(x)
    elif isinstance(x, (list, tuple)):
        for y in x:
            _flat(y, out)
    elif isinstance(x, dict):
        for y in x.values():
            _flat(y, out)
    return out


class _Lowering(op_walk.Recorder):
    """The recorder of a lowering: one record per ATen op (no frames:
    pricing reads names and shapes) and, per storage, the record that
    made it and the last record that used it (a view shares its base's
    storage).  Every storage seen is held for the walk, so its key (the
    storage's address) is never reused.

    A layer repeats its ops on the same shapes, so the result of a
    functional op on meta tensors (fresh tensors, no input written) is
    kept by the call's signature and a repeat makes empty meta tensors
    of the same layout instead of running the meta kernel again."""

    def __init__(self, external=(), records: bool = True):
        super().__init__()
        self.keep = records        # False: liveness only, no OpRecords
        self.n = 0                 # ops walked
        self.held: dict = {}       # key -> storage
        self.size: dict = {}       # key -> bytes
        self.first: dict = {}      # key -> index of the record that made it
        self.last: dict = {}       # key -> index of its last use
        self.layouts: dict = {}    # (op, signature) -> result layouts
        for t in external:         # the arguments: never made by an op
            self.first[self.key(t)] = None

    def key(self, t: torch.Tensor) -> int:
        st = t.untyped_storage()
        k = st._cdata
        if k not in self.held:
            self.held[k] = st
            self.size[k] = st.nbytes()
        return k

    def _call(self, func, args, kwargs):
        sig = None
        if _functional(func):
            try:
                sig = (func, _sig(args), _sig(tuple(sorted(kwargs.items()))))
            except _Uncached:
                pass
        hit = self.layouts.get(sig) if sig is not None else None
        if hit is not None:
            made = [torch.empty_strided(shape, stride, dtype=dt,
                                        device="meta")
                    for shape, stride, dt in hit]
            return made[0] if len(func._schema.returns) == 1 else tuple(made)
        out = func(*args, **kwargs)
        if sig is not None:
            outs = _flat(out, [])
            keys = {t.untyped_storage()._cdata
                    for t in _flat((args, kwargs), [])}
            fresh = {t.untyped_storage()._cdata for t in outs}
            if all(type(t) is torch.Tensor and t.device.type == "meta"
                   for t in outs) and len(fresh) == len(outs) and \
                    not fresh & keys:
                self.layouts[sig] = [(tuple(t.shape), t.stride(), t.dtype)
                                     for t in outs]
        return out

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if self.muted:
            return func(*args, **kwargs)
        out = self._call(func, args, kwargs)
        i = self.n
        self.n += 1
        ins, outs = _flat((args, kwargs), []), _flat(out, [])
        for t in ins:
            k = self.key(t)
            self.first.setdefault(k, None)      # made before the walk
            self.last[k] = i
        for t in outs:
            k = self.key(t)
            self.first.setdefault(k, i)
            self.last[k] = i
        if not self.keep:
            return out
        name = func.overloadpacket.__name__
        if func is op_walk._POW_SCALAR and args[1] == 2:
            name = "square"
        self.records.append(op_walk.OpRecord(
            name, tuple(map(op_walk._meta, ins)),
            tuple(map(op_walk._meta, outs)), (),
            scalars=sum(isinstance(a, (int, float)) for a in args),
            einsum=self.einsum > 0))
        return out


@dataclasses.dataclass(frozen=True)
class MemoryAnalysis:
    """The reference's ``memory_analysis()`` fields, per rank (rank 0's:
    ``torch.chunk`` gives it the largest shard of an uneven dim)."""

    argument_size_in_bytes: int
    output_size_in_bytes: int
    temp_size_in_bytes: int
    alias_size_in_bytes: int

    @property
    def peak_bytes_est(self) -> int:
        """As the reference reckons it: arguments + outputs + temporaries
        less the donated arguments (whose buffers the outputs take)."""
        return (self.argument_size_in_bytes + self.output_size_in_bytes
                + self.temp_size_in_bytes - self.alias_size_in_bytes)


@dataclasses.dataclass
class LoweredProgram:
    """A program walked once on its placed arguments: the ATen records
    of this rank and the liveness of every storage an op made.  PyTorch
    runs a program as it is, so there is no ``compile()`` step: the
    analyses read the walk."""

    name: str
    records: list
    output: Any
    memory: MemoryAnalysis

    def memory_analysis(self) -> MemoryAnalysis:
        return self.memory

    def cost_analysis(self) -> dict:
        """``{"flops", "bytes accessed"}`` of the records
        (``perf.cost.op_flops`` / ``op_bytes``), collectives left out."""
        from repro_torch.perf import cost as perf_cost
        flops = nbytes = 0.0
        for r in self.records:
            if r.name in _COLLECTIVE_KINDS:
                continue
            flops += perf_cost.op_flops(r)
            nbytes += perf_cost.op_bytes(r)
        return {"flops": flops, "bytes accessed": nbytes}

    def collectives(self) -> dict:
        """Result-shape bytes per collective kind on this rank (the
        reference's documented proxy: an all-reduce's operand, an
        all-gather's gathered result, a reduce-scatter's shard), read
        from the recorded c10d and functional collectives."""
        out: dict = {}
        for r in self.records:
            kind = _COLLECTIVE_KINDS.get(r.name)
            if kind is not None:
                out[kind] = out.get(kind, 0) + sum(
                    op_walk.tensor_bytes(m) for m in r.outputs)
        return out


def _local_tensors(tree) -> list:
    """The tensors of a (placed) tree as this rank holds them."""
    return [x._local_tensor if sharding.is_dtensor(x) else x
            for x in tree_leaves(tree) if isinstance(x, torch.Tensor)]


def _placed_args(prog: Program, mesh) -> tuple:
    if not sharding.is_device_mesh(mesh):
        return tuple(prog.args)
    return tuple(sharding.place(a, tree_map(lambda ns: ns.spec, sh), mesh)
                 for a, sh in zip(prog.args, prog.shardings))


def _bytes(rec: _Lowering, tensors) -> int:
    """Bytes of ``tensors`` on this rank: per storage, the largest of its
    tensors (a rank's shard may be a view into the whole meta tensor
    ``sharding.place`` cut it from; on a device it is its own)."""
    per: dict = {}
    for t in tensors:
        k = rec.key(t)
        per[k] = max(per.get(k, 0), t.numel() * t.element_size())
    return sum(min(n, rec.size[k]) for k, n in per.items())


def lower_program(prog: Program, mesh, seq_axis=None, *,
                  records: bool = True) -> LoweredProgram:
    """Place ``prog.args`` by ``prog.shardings`` (on a ``DeviceMesh``;
    a one-device mesh takes them as they are) and walk ``prog.fn`` once
    on them under ``ctx.mesh_context(dp, seq_axis)``.

    The memory analysis, on this rank: arguments (the placed arguments'
    local storages), outputs (the result's storages), alias (the donated
    arguments) and temporaries — the peak over the records of the bytes
    of live storages made by an op that are neither arguments nor
    outputs, each live from the op that made it to the last op that read
    or wrote it (XLA's buffer liveness; a tensor saved for the backward
    counts until the backward op that reads it).  ``records=False``
    keeps no op records (a memory analysis only: no cost, no
    collectives)."""
    from repro_torch.dist import ctx
    seq_axis = seq_axis or prog.seq_axis
    dp = prog.dp if prog.dp != "auto" else meshlib.dp_axes(mesh)
    args = _placed_args(prog, mesh)
    arg_t = _local_tensors(args)
    rec = _Lowering(arg_t, records)
    with mesh, ctx.mesh_context(dp, seq_axis):
        out = op_walk.run_with(rec, prog.fn, args, einsum=records)
    out_keys = {rec.key(t) for t in _local_tensors(out)}
    events = []
    for k, first in rec.first.items():
        if first is None or k in out_keys:
            continue
        events.append((first, rec.size[k]))
        events.append((rec.last[k] + 1, -rec.size[k]))
    events.sort(key=lambda e: (e[0], e[1]))
    live = temp = 0
    for _, b in events:
        live += b
        temp = max(temp, live)
    donated = [t for i in prog.donate for t in _local_tensors(args[i])]
    mem = MemoryAnalysis(
        argument_size_in_bytes=_bytes(rec, arg_t),
        output_size_in_bytes=_bytes(rec, _local_tensors(out)),
        temp_size_in_bytes=temp,
        alias_size_in_bytes=_bytes(rec, donated))
    return LoweredProgram(prog.name, rec.records, out, mem)


# ---------------------------------------------------------------------------
# Cost decomposition (the reference's DESIGN.md §4)
#
# The reference needs it because XLA's cost_analysis counts a while-loop
# body once; the port walks Python loops trip by trip, but a whole
# production step is millions of ATen ops, so the port prices the same
# while-free component programs:  total = sum_i multiplier_i x cost_i.
#
# dense/moe/whisper:  outside(L=0) + L x block          (exact)
# rwkv:               outside + L x [c1 + (S/c - 1)(c2 - c1)]   (exact: every
#                     sub-block is linear in S at fixed chunk c)
# hybrid (hymba):     rwkv-style linear part + windowed-attention correction
#                     via standalone attention programs at full S (exact)
#
# Names, multipliers and the per-family decomposition are the reference's,
# quirks included: whisper's prefill and decode have no ``outside``
# program (its embedding and head go unpriced there), and a recurrent
# prefill's two-point multipliers are negative and positive.
#
# Each component runs as the port's mesh step runs that work (dist.spmd,
# local view).  A serving component gathers its weights (once per step
# per layer, as the step does) and takes the rank's data shard.  The
# train step gathers every weight once per step, not per microbatch, and
# means the gradients once: so the train components' weights are placed
# replicated (whole, as the step's gather leaves them) and the step's
# once-per-step collectives — the weights' gather, the gradients' DP mean
# and the update's reductions — are priced in ``optimizer``.
# ---------------------------------------------------------------------------

def _block_meta(cfg):
    return T.block_params(cfg, torch.Generator(), "meta")


def _x_meta(cfg, tokens_b, s):
    return _meta((tokens_b, s, cfg.d_model), getattr(torch, cfg.dtype))


def _attn_meta(cfg):
    return L.attention_params(cfg, torch.Generator(), "meta")


def _replicated(tree):
    """Specs that place every leaf of ``tree`` whole on every rank."""
    return tree_map(lambda _: P(), tree)


def _local_view(fn, weights=(0,)):
    """``fn`` with its placed arguments in the port's local view: the
    ``weights`` arguments gathered (``spmd.materialize``), the others the
    rank's data shards (``spmd.local_view``)."""
    from repro_torch.dist import ctx

    def run(*args):
        dp = ctx.dp_axes()
        return fn(*(spmd.materialize(a) if i in weights
                    else spmd.local_view(a, dp) for i, a in enumerate(args)))
    return run


def _grad_of(loss, cfg, argnames):
    """``fn(*args) -> grads`` of ``sum(loss(*args))`` over every argument
    (the reference's ``jax.grad(..., argnums=...)``), the loss under
    ``layers.remat`` where ``cfg.remat`` (its ``jax.checkpoint``)."""
    def total(tree):
        args = [tree[n] for n in argnames]
        y = L.remat(cfg, lambda h: loss(h, *args[1:]), args[0], args[1:])
        return torch.sum(y.to(torch.float32))

    def fn(*args):
        _, g = value_and_grad(total, dict(zip(argnames, args)))
        return tuple(g[n] for n in argnames)
    return fn


def _block_fwd_fn(cfg, s, *, train):
    """Single-block apply (or fwd+bwd when train) on [B,s,D], as the
    step's layer runs it (``transformer._scan_blocks``: under
    Megatron-SP the residual stream is the rank's sequence chunk)."""
    from repro_torch.dist import ctx

    def fwd(x, bp):
        with ctx.sequence(s):
            state = T._fresh_state(cfg, x.shape[0], x.device)
            y, _ = T.apply_block(bp, ctx.shard_activations(x), cfg, state,
                                 positions=torch.arange(s, device=x.device))
            return ctx.shard_activations(y)

    if not train:
        return _local_view(lambda bp, x: fwd(x, bp))
    grad = _grad_of(fwd, cfg, ("x", "bp"))
    return _local_view(lambda bp, x: grad(x, bp)[::-1])


def _attn_only_fn(cfg, s, *, train):
    """Standalone windowed attention on [B,s,D] (hymba correction term)."""

    def fwd(x, ap):
        y, _ = L.apply_attention(ap, x, cfg,
                                 positions=torch.arange(s, device=x.device))
        return y

    if not train:
        return _local_view(lambda ap, x: fwd(x, ap))
    grad = _grad_of(fwd, cfg, ("x", "ap"))
    return _local_view(lambda ap, x: grad(x, ap)[::-1])


def _decode_block_fn(cfg, shape):
    w = cfg.sliding_window

    def fn(bp, x, state, idx):
        pos = idx + torch.arange(x.shape[1], device=x.device)
        if cfg.family == "hybrid":
            return T.apply_block(bp, x, cfg, state, positions=pos[:1],
                                 cache_index=idx % w,
                                 kv_len_valid=min(idx + 1, w), ring=True)
        if cfg.family == "rwkv":
            return T.apply_block(bp, x, cfg, state, positions=None)
        return T.apply_block(bp, x, cfg, state, positions=pos,
                             cache_index=idx, kv_len_valid=idx + x.shape[1])
    return _local_view(fn)


def _per_layer_decode_state_meta(cfg, shape):
    full = decode_state_shape(cfg, shape)
    return tree_map(lambda a: _meta(tuple(a.shape[1:]), a.dtype),
                    full["layers"])


def _per_layer_decode_state_spec(cfg, dp, tp_size=16):
    full = model_module(cfg).decode_state_specs(cfg, dp, tp_size)
    return tree_map(lambda spec: P(*tuple(spec)[1:]), full["layers"])


# the decode index of a component program: the reference's is traced; the
# port's attention masks the whole cache, so the cost does not depend on it
_IDX = 0


def _optimizer_program(cfg, mesh, dp, hp) -> Program:
    """The train step's once-per-step work on the mesh: every weight
    gathered (``spmd.materialize``), the gradients' DP mean and the
    sharded AdamW update (its global norm and int8 scales reduced)."""
    def opt_fn(params, opt_state, grads):
        spmd.materialize(params)
        if sharding.is_device_mesh(mesh):
            grads = spmd.dp_mean(sharding.local(grads), mesh, dp)
        return adamw.update(grads, opt_state, params, hp,
                            scan_stacked=cfg.scan_layers)

    p_meta = params_shape(cfg)
    g_meta = tree_map(lambda a: _meta(tuple(a.shape), torch.float32), p_meta)
    opt_meta = adamw.init(p_meta, hp)
    p_sh = _named(mesh, param_pspecs(cfg))
    opt_sh = _named(mesh, adamw.opt_state_specs(param_pspecs(cfg), hp))
    return Program("optimizer", opt_fn, (p_meta, opt_meta, g_meta),
                   (p_sh, opt_sh, _named(mesh, _grad_specs(cfg))),
                   multiplier=1.0, dp=dp)


def _grad_specs(cfg):
    """The specs of the step's gradients on a rank: whole, except an
    expert stack's, which is the rank's ``"model"`` slice."""
    def one(path, spec):
        if not spmd._is_expert(path):
            return P()
        return P(*(p if p == "model" else None for p in spec))
    return spmd._map_path(one, param_pspecs(cfg))


def cost_programs(cfg: ModelConfig, shape: ShapeSpec, mesh) -> list:
    """While-free component programs + multipliers for this cell."""
    dp = dp_for(shape, mesh)
    progs = []
    x_spec = _named(mesh, P(dp, None, None))
    gb, s = shape.global_batch, shape.seq_len
    c = rwkv.CHUNK  # recurrence chunk (rwkv.CHUNK == ssm.CHUNK == 16)

    if cfg.family == "encdec":
        progs.extend(_whisper_cost_programs(cfg, shape, mesh))
        for pr in progs:
            pr.dp = dp
        return progs

    if shape.kind == "train":
        n_micro = microbatches(cfg, shape, mesh)
        mb = gb // n_micro
        hp = hparams_for(cfg)
        block_sh = _named(mesh, _replicated(_block_meta(cfg)))
        if cfg.family in ("dense", "moe"):
            progs.append(Program(
                "block_fwdbwd", _block_fwd_fn(cfg, s, train=True),
                (_block_meta(cfg), _x_meta(cfg, mb, s)), (block_sh, x_spec),
                multiplier=cfg.n_layers * n_micro,
                seq_axis=seq_axis_for(cfg, shape)))
        else:
            f1 = _block_fwd_fn(cfg, c, train=True)
            f2 = _block_fwd_fn(cfg, 2 * c, train=True)
            # linear-in-S two-point: c1 + (S/c - 1)(c2 - c1), applied by the
            # dry-run combiner via paired multipliers.
            m_hi = (s // c - 1) * cfg.n_layers * n_micro
            m_lo = cfg.n_layers * n_micro - m_hi
            progs.append(Program("block_fwdbwd@c",
                                 f1, (_block_meta(cfg), _x_meta(cfg, mb, c)),
                                 (block_sh, x_spec), multiplier=m_lo))
            progs.append(Program("block_fwdbwd@2c",
                                 f2, (_block_meta(cfg),
                                      _x_meta(cfg, mb, 2 * c)),
                                 (block_sh, x_spec), multiplier=m_hi))
            if cfg.family == "hybrid":
                progs.extend(_hymba_attn_correction(
                    cfg, mesh, mb, s, c, cfg.n_layers * n_micro, train=True))
        cfg0 = cfg.with_(n_layers=0)
        mb_shape = dataclasses.replace(shape, global_batch=mb)
        p0 = params_shape(cfg0)
        progs.append(Program(
            "outside_fwdbwd", make_train_like_loss(cfg0),
            (p0, input_specs(cfg0, mb_shape)),
            (_named(mesh, _replicated(p0)),
             _named(mesh, batch_pspec(cfg0, mb_shape, dp))),
            multiplier=n_micro))
        progs.append(_optimizer_program(cfg, mesh, dp, hp))
        for pr in progs:
            pr.dp = dp
        return progs

    # ---- inference cells ----
    sq = 1 if shape.is_decode else s
    state = _per_layer_decode_state_meta(cfg, shape)
    state_sh = _named(mesh, _per_layer_decode_state_spec(
        cfg, dp, sharding.axis_size(mesh, "model")))
    block_sh = _named(mesh, T.block_specs(cfg))
    if cfg.family in ("dense", "moe") or shape.is_decode:
        progs.append(Program(
            "block_step", _decode_block_fn(cfg, shape),
            (_block_meta(cfg), _x_meta(cfg, gb, sq), state, _IDX),
            (block_sh, x_spec, state_sh, _named(mesh, P())),
            multiplier=cfg.n_layers))
    else:
        # rwkv/hybrid prefill: two-point in S (state threads through)
        for nm, sc, mult in _two_point(cfg, s, c):
            progs.append(Program(nm, _block_fwd_fn(cfg, sc, train=False),
                                 (_block_meta(cfg), _x_meta(cfg, gb, sc)),
                                 (block_sh, x_spec), multiplier=mult))
        if cfg.family == "hybrid":
            progs.extend(_hymba_attn_correction(cfg, mesh, gb, s, c,
                                                cfg.n_layers, train=False))
    cfg0 = cfg.with_(n_layers=0)
    mod = model_module(cfg)

    def outside_fn(params, tokens):
        return mod.forward_no_blocks(params, tokens, cfg0)

    progs.append(Program(
        "outside", _local_view(outside_fn),
        (params_shape(cfg0), _meta((gb, sq), torch.int32)),
        (_named(mesh, param_pspecs(cfg0)), _named(mesh, P(dp, None))),
        multiplier=1.0))
    for pr in progs:
        pr.dp = dp
    return progs


def _two_point(cfg, s, c):
    """total = L*[c1 + m*(c2 - c1)], m = S/c - 1  ->  coeffs L(1-m), L*m."""
    m = s // c - 1
    return [("block@c", c, cfg.n_layers * (1 - m)),
            ("block@2c", 2 * c, cfg.n_layers * m)]


def make_train_like_loss(cfg0):
    """``(params, batch) -> grads`` of the no-blocks loss (the
    ``outside_fwdbwd`` component), in local view."""
    loss_fn = _loss(cfg0)

    def fn(params, batch):
        return value_and_grad(lambda p: loss_fn(p, batch, cfg0), params)[1]
    return _local_view(fn)


def _hymba_attn_correction(cfg, mesh, b, s, c, layer_mult, *, train):
    """Exact windowed-attention term: + attn(full S), - linearised estimate
    (attn@c, attn@2c with the two-point multipliers, negated)."""
    dp = meshlib.dp_axes(mesh)
    x_spec = _named(mesh, P(dp, None, None))
    specs = _replicated(_attn_meta(cfg)) if train else L.attention_specs(cfg)
    attn_sh = _named(mesh, specs)
    m = s // c - 1
    out = [Program("attn_full", _attn_only_fn(cfg, s, train=train),
                   (_attn_meta(cfg), _x_meta(cfg, b, s)), (attn_sh, x_spec),
                   multiplier=layer_mult)]
    out.append(Program("attn@c(-)", _attn_only_fn(cfg, c, train=train),
                       (_attn_meta(cfg), _x_meta(cfg, b, c)),
                       (attn_sh, x_spec),
                       multiplier=-float(layer_mult * (1 - m))))
    out.append(Program("attn@2c(-)", _attn_only_fn(cfg, 2 * c, train=train),
                       (_attn_meta(cfg), _x_meta(cfg, b, 2 * c)),
                       (attn_sh, x_spec), multiplier=-float(layer_mult * m)))
    return out


def _whisper_cost_programs(cfg, shape, mesh):
    dp = meshlib.dp_axes(mesh)
    x_spec = _named(mesh, P(dp, None, None))
    progs = []
    train = shape.kind == "train"
    n_micro = microbatches(cfg, shape, mesh) if train else 1
    gb = shape.global_batch
    mb = gb // n_micro
    sq = 1 if shape.is_decode else shape.seq_len

    gen = torch.Generator()
    enc_meta = E.enc_block_params(cfg, gen, "meta")
    dec_meta = E.dec_block_params(cfg, gen, "meta")
    if train:
        enc_sh = _named(mesh, _replicated(enc_meta))
        dec_sh = _named(mesh, _replicated(dec_meta))
    else:
        enc_sh = _named(mesh, E.enc_block_specs(cfg))
        dec_sh = _named(mesh, E.dec_block_specs(cfg))

    def enc_fwd(x, bp):
        return E.apply_enc_block(bp, x, cfg)

    def dec_fwd(x, bp, memory):
        y, _ = E.apply_dec_block(
            bp, x, cfg, positions=torch.arange(x.shape[1], device=x.device),
            memory=memory)
        return y

    if train:
        enc_g = _grad_of(enc_fwd, cfg, ("x", "bp"))
        dec_g = _grad_of(dec_fwd, cfg, ("x", "bp", "memory"))
        enc_fn = _local_view(lambda bp, x: enc_g(x, bp)[::-1])
        dec_fn = _local_view(
            lambda bp, x, m: (lambda g: (g[1], g[0], g[2]))(dec_g(x, bp, m)))
    else:
        enc_fn = _local_view(lambda bp, x: enc_fwd(x, bp))
        dec_fn = _local_view(lambda bp, x, m: dec_fwd(x, bp, m))

    if not shape.is_decode:
        progs.append(Program(
            "enc_block", enc_fn,
            (enc_meta, _x_meta(cfg, mb, cfg.enc_seq)), (enc_sh, x_spec),
            multiplier=cfg.n_enc_layers * n_micro))
        progs.append(Program(
            "dec_block", dec_fn,
            (dec_meta, _x_meta(cfg, mb, sq), _x_meta(cfg, mb, cfg.enc_seq)),
            (dec_sh, x_spec, x_spec), multiplier=cfg.n_layers * n_micro))
    else:
        state = _per_layer_decode_state_meta(cfg, shape)
        state_sh = _named(mesh, _per_layer_decode_state_spec(
            cfg, dp, sharding.axis_size(mesh, "model")))

        def dec_step(bp, x, st, idx):
            return E.apply_dec_block(
                bp, x, cfg, positions=idx + torch.arange(1, device=x.device),
                state=st, cache_index=idx)
        progs.append(Program(
            "dec_block_step", _local_view(dec_step),
            (dec_meta, _x_meta(cfg, gb, 1), state, _IDX),
            (dec_sh, x_spec, state_sh, _named(mesh, P())),
            multiplier=cfg.n_layers))

    # outside: embed/head/loss with zero layers
    cfg0 = cfg.with_(n_layers=0, n_enc_layers=0)
    if train:
        mb_shape = dataclasses.replace(shape, global_batch=mb)
        p0 = params_shape(cfg0)
        progs.append(Program(
            "outside_fwdbwd", make_train_like_loss(cfg0),
            (p0, input_specs(cfg0, mb_shape)),
            (_named(mesh, _replicated(p0)),
             _named(mesh, batch_pspec(cfg0, mb_shape, dp))),
            multiplier=n_micro))
        progs.append(_optimizer_program(cfg, mesh, dp, hparams_for(cfg)))
    return progs


# ---------------------------------------------------------------------------
# Steps
# ---------------------------------------------------------------------------

def _loss(cfg: ModelConfig):
    return model_module(cfg).loss_fn


def check_trainable(cfg: ModelConfig) -> None:
    """The flash-LUT attention kernel has no gradient (neither has the
    reference's: it is called with no STE), so a training forward must
    run the einsum attention."""
    if cfg.attn_impl == "flash_lut":
        raise NotImplementedError(
            "attn_impl='flash_lut' cannot be trained: the flash-LUT "
            "attention has no gradient; train with attention='xla'")


def no_tf32() -> None:
    """Full float32 products, as ``runtime.compile_model`` sets them: the
    STE's kernel-vs-plain identity and the export identity need them."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def to_device(batch: dict, device) -> dict:
    return {k: v.to(device) for k, v in batch.items()}


def value_and_grad(loss_fn, params: Pytree, *args):
    """``(loss, grads)`` of ``loss_fn(params, *args)`` over every leaf of
    ``params`` (float tensors; a detached copy of the tree records the
    graph, so the caller's tensors are untouched).  A leaf the loss does
    not reach gets a zero gradient, as ``jax.grad`` gives it (rwkv's
    decay under the LUT softplus, a table gather, is one)."""
    leaves = tree_leaves(params)
    live = [leaf.detach().requires_grad_(True) for leaf in leaves]
    it = iter(live)
    run = tree_map(lambda _: next(it), params)
    with torch.enable_grad():
        loss = loss_fn(run, *args)
        grads = torch.autograd.grad(loss, live, allow_unused=True,
                                    materialize_grads=True)
    it = iter(grads)
    return loss.detach(), tree_map(lambda _: next(it), params)


def split_micro(batch: dict, n_micro: int) -> list:
    """The batch cut into ``n_micro`` consecutive microbatches."""
    return [{k: v.reshape((n_micro, v.shape[0] // n_micro)
                          + tuple(v.shape[1:]))[i]
             for k, v in batch.items()} for i in range(n_micro)]


def accumulate(loss_fn, params: Pytree, batch: dict, n_micro: int, *args):
    """Mean loss and float32 gradients over ``n_micro`` microbatches, in
    the reference's order (each microbatch's grads divided by ``n_micro``
    and added to the running sum)."""
    if n_micro == 1:
        return value_and_grad(loss_fn, params, batch, *args)
    acc = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                         device=p.device), params)
    losses = []
    for mb in split_micro(batch, n_micro):
        loss, g = value_and_grad(loss_fn, params, mb, *args)
        acc = tree_map(lambda a, gg: a + gg.to(torch.float32) / n_micro, acc, g)
        losses.append(loss)
    return torch.stack(losses).mean(), acc


def make_train_step(cfg: ModelConfig, shape: ShapeSpec, hp=None, n_micro=None,
                    sync_mesh=None, sync_per_channel: bool = False,
                    sync_bits: int = 8, qat=None):
    """(params, opt_state, batch) -> (params, opt_state, metrics).

    Gradient accumulation over ``n_micro`` microbatches; grads are
    averaged in float32, then one AdamW update.  The batch may lie on any
    device: it is moved to the parameters'.

    ``qat`` (a ``repro_torch.qat.train.QATSpec``) switches the step to
    quantisation-aware training (``qat.train.make_qat_train_step``): the
    loss forward runs eq-9 fake-quant params under a runtime Backend's LUT
    modes — for ``backend="cuda"`` the hand-written softmax and GELU
    kernels, behind their STEs — while AdamW updates the float shadow
    weights; the step then threads the QAT state, ``(params, opt_state,
    qstate, batch) -> (params, opt_state, qstate, metrics)``.

    ``sync_mesh`` inserts the compressed gradient sync
    (``dist.compress.compressed_grad_sync``, ``sync_per_channel`` scales,
    ``sync_bits`` wide) between the gradients and the update, and the step
    threads its error-feedback state: ``(params, opt_state, err, batch) ->
    (params, opt_state, err, metrics)`` — with ``qat``, ``(params,
    opt_state, qstate, err, batch)``.  The step donates ``err``: the new
    residuals are written into its tensors, which it returns, so the
    update runs beside one error state where the caller's reference
    would otherwise keep the old one alive too.
    """
    sync = None
    if sync_mesh is not None:
        from repro_torch.dist import compress

        def sync(grads, err):
            synced, new_err = compress.compressed_grad_sync(
                grads, err, sync_mesh, per_channel=sync_per_channel,
                bits=sync_bits)
            for old, new in zip(tree_leaves(err), tree_leaves(new_err)):
                old.copy_(new)
            return synced, err
    if qat is not None:
        from repro_torch.qat import train as qat_train
        return qat_train.make_qat_train_step(cfg, shape, hp=hp,
                                             n_micro=n_micro, qat=qat,
                                             sync=sync)
    check_trainable(cfg)
    no_tf32()
    hp = hp or hparams_for(cfg)
    n_micro = n_micro or microbatches(cfg, shape)
    loss_fn = _loss(cfg)

    @spmd.grads_on_mesh
    def grads_of(params, batch):
        device = tree_leaves(params)[0].device
        return accumulate(lambda p, b: loss_fn(p, b, cfg), params,
                          to_device(batch, device), n_micro)

    def finish(loss, grads, opt_state, params):
        new_params, new_opt, metrics = adamw.update(
            grads, opt_state, params, hp, scan_stacked=cfg.scan_layers)
        metrics["loss"] = loss
        return new_params, new_opt, metrics

    if sync is None:
        def train_step(params, opt_state, batch):
            loss, grads = grads_of(params, batch)
            return finish(loss, grads, opt_state, params)
        return train_step

    def train_step_synced(params, opt_state, err, batch):
        loss, grads = grads_of(params, batch)
        grads, err = sync(grads, err)
        new_params, new_opt, metrics = finish(loss, grads, opt_state, params)
        return new_params, new_opt, err, metrics

    return train_step_synced


def make_prefill_step(cfg: ModelConfig, shape: ShapeSpec):
    """``(params, state, batch) -> (last logits, state)``: the model
    module's ``prefill`` (encdec's takes the batch's frames too)."""
    mod = model_module(cfg)
    if cfg.family == "encdec":
        def step(params, state, batch):
            return mod.prefill(params, batch["frames"], batch["tokens"],
                               cfg, state)
        return spmd.serve_on_mesh(step)

    def step(params, state, batch):
        return mod.prefill(params, batch["tokens"], cfg, state)
    return spmd.serve_on_mesh(step)


def make_decode_step(cfg: ModelConfig, shape: ShapeSpec):
    """``(params, state, batch) -> (logits, state)`` of one token."""
    mod = model_module(cfg)

    def step(params, state, batch):
        return mod.decode_step(params, batch["token"], cfg, state)
    return spmd.serve_on_mesh(step)
