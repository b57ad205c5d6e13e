"""Train-step builders for the KWT family: ``make_train_step(cfg, shape,
hp)`` -> ``(params, opt_state, batch) -> (params, opt_state, metrics)``,
and its quantisation-aware mode (``qat=``, ``repro_torch.qat.train``).

The reference jits one program per step; here a step is eager PyTorch:
the loss forward records a graph, ``torch.autograd.grad`` takes the
gradients of every parameter leaf, and ``optim.adamw.update`` writes new
tensors.  Microbatches accumulate float32 gradients in a loop.  The
mesh-sharded LM steps, their input / sharding specs and the compressed
gradient sync wait for ROADMAP queue A items 3 and 4.
"""

from __future__ import annotations

from typing import Any

import torch

from repro_torch.configs.base import ModelConfig, ShapeSpec
from repro_torch.core.tree import tree_leaves, tree_map
from repro_torch.optim import adamw
from repro_torch.runtime.engine import _model_module

Pytree = Any


def not_ported(what: str, item: str):
    raise NotImplementedError(f"{what} is not ported yet: it waits for "
                              f"ROADMAP queue A {item}")


def hparams_for(cfg: ModelConfig) -> adamw.HParams:
    """float32 moments: the reference gives int8 moments only to LM
    configs, which come with ROADMAP queue A item 3."""
    return adamw.HParams()


def microbatches(cfg: ModelConfig, shape: ShapeSpec) -> int:
    """Gradient-accumulation microbatches: 1 for the KWT family (the
    reference's table covers only LM configs at ``train_4k``)."""
    return 1


def model_module(cfg: ModelConfig):
    """The model module of ``cfg``'s family (``models.kwt``)."""
    return _model_module(cfg)


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
    graph, so the caller's tensors are untouched)."""
    leaves = tree_leaves(params)
    live = [leaf.detach().requires_grad_(True) for leaf in leaves]
    it = iter(live)
    run = tree_map(lambda _: next(it), params)
    with torch.enable_grad():
        loss = loss_fn(run, *args)
        grads = torch.autograd.grad(loss, live)
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
                    sync_mesh=None, qat=None):
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

    ``sync_mesh`` (the compressed gradient sync) raises
    ``NotImplementedError``: ROADMAP queue A item 4.
    """
    if sync_mesh is not None:
        not_ported("sync_mesh (compressed gradient sync)", "item 4 (dist)")
    if qat is not None:
        from repro_torch.qat import train as qat_train
        return qat_train.make_qat_train_step(cfg, shape, hp=hp,
                                             n_micro=n_micro, qat=qat)
    check_trainable(cfg)
    no_tf32()
    hp = hp or hparams_for(cfg)
    n_micro = n_micro or microbatches(cfg, shape)
    loss_fn = _loss(cfg)

    def train_step(params, opt_state, batch):
        device = tree_leaves(params)[0].device
        loss, grads = accumulate(lambda p, b: loss_fn(p, b, cfg), params,
                                 to_device(batch, device), n_micro)
        new_params, new_opt, metrics = adamw.update(
            grads, opt_state, params, hp, scan_stacked=cfg.scan_layers)
        metrics["loss"] = loss
        return new_params, new_opt, metrics

    return train_step
