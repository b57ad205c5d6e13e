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
Lowering a program and the cost decomposition (``lower_program``,
``cost_programs``) price programs rather than run them: ROADMAP queue A
item 4.4.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch.configs.base import ModelConfig, ShapeSpec
from repro_torch.core.tree import tree_leaves, tree_map
from repro_torch.dist import sharding, spmd
from repro_torch.dist.sharding import P
from repro_torch.launch import mesh as meshlib
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

_PRICING = "item 4.4 (launch/dryrun.py and the program pricing)"


def seq_axis_for(cfg: ModelConfig, shape: ShapeSpec):
    return "model" if (cfg.name, shape.name) in SEQ_SHARD else None


def not_ported(what: str, item: str):
    raise NotImplementedError(f"{what} is not ported yet: it waits for "
                              f"ROADMAP queue A {item}")


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


def params_shape(cfg: ModelConfig):
    """The parameter tree as meta tensors (``jax.eval_shape`` of
    ``init_params``)."""
    return model_module(cfg).init_params(cfg, torch.Generator(), "meta")


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


def build_step_program(cfg: ModelConfig, shape: ShapeSpec, mesh) -> Program:
    """The whole step of a cell: train (donating params and optimizer
    state), prefill or decode (donating the decode state)."""
    dp = dp_for(shape, mesh)
    batch = input_specs(cfg, shape)
    batch_sh = _named(mesh, batch_pspec(cfg, shape, dp))
    p_meta = params_shape(cfg)
    p_sh = _named(mesh, param_pspecs(cfg))
    if shape.kind == "train":
        hp = hparams_for(cfg)
        opt_meta = adamw.init(p_meta, hp)
        opt_sh = _named(mesh, adamw.opt_state_specs(param_pspecs(cfg), hp))
        fn = make_train_step(cfg, shape, hp,
                             n_micro=microbatches(cfg, shape, mesh))
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


def lower_program(prog: Program, mesh, seq_axis=None):
    """The reference lowers and compiles a program for its memory and
    cost analyses: ROADMAP queue A item 4.4."""
    not_ported("lower_program (a program's lowering and pricing)", _PRICING)


def cost_programs(cfg: ModelConfig, shape: ShapeSpec, mesh) -> list:
    """The reference's while-free component programs for the dry-run's
    cost decomposition: ROADMAP queue A item 4.4."""
    not_ported("cost_programs (the dry-run's cost decomposition)", _PRICING)


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
        return step

    def step(params, state, batch):
        return mod.prefill(params, batch["tokens"], cfg, state)
    return step


def make_decode_step(cfg: ModelConfig, shape: ShapeSpec):
    """``(params, state, batch) -> (logits, state)`` of one token."""
    mod = model_module(cfg)

    def step(params, state, batch):
        return mod.decode_step(params, batch["token"], cfg, state)
    return step
