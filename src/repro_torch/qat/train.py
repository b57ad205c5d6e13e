"""Quantisation-aware training: the deployed numerics inside the loss.

The QAT train step is ``launch.steps.make_train_step``'s quantised mode
(``steps.make_train_step(..., qat=QATSpec(...))`` delegates here): the
loss forward runs fake-quant params (``qat.fakequant``, STE) under the
execution config of a ``repro_torch.runtime`` backend (default ``"lut"`` —
Q8.24 LUT softmax + LUT GELU, the '+Hardware' numerics; ``"cuda"`` — the
same numerics through the hand-written softmax and GELU kernels, behind
the straight-through estimators of ``core.approx``), while the float
*shadow* weights are what ``optim.adamw`` updates.  State threads a small
``qstate`` tree::

    step(params, opt_state, qstate, batch) -> (params, opt_state, qstate, metrics)

``qstate = {"step": int32, "weight_exponent": float32}``, 0-dim tensors
on the parameters' device, checkpoints and restores through
``checkpoint.manager`` like any other tree.  Nothing of it is read back
to the host inside a step: the delayed-start gate and the exponent
freeze are ``torch.where``s on the device, as in the reference.

Knobs (QATConfig): delayed start, exponent learning with a freeze step,
optional eq-9 input fake-quant, and optional distillation
(``qat.distill``) from a float teacher.  Composition with the compressed
gradient sync waits for ROADMAP queue A item 4.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch

from repro_torch.core.tree import tree_leaves, tree_map
from repro_torch.device import resolve_device
from repro_torch.optim import adamw
from repro_torch.qat import fakequant
from repro_torch.runtime import backends
from repro_torch.runtime.recipe import QuantRecipe

Pytree = Any


@dataclasses.dataclass(frozen=True)
class QATConfig:
    """How the quantised forward enters training.

    ``backend`` names the runtime Backend whose softmax/act modes the loss
    runs under (``"lut"`` = the plain Q8.24 pipeline; ``"cuda"`` = the
    hand-written kernels, which need a CUDA device).  ``start_step``
    delays weight fake-quant (float warm-up; the LUT activation modes are
    active throughout).  ``learn_exponent`` recalibrates the weight
    exponent from the shadow weights every step until
    ``freeze_exponent_step`` (``0`` = never freeze), then freezes it — the
    learned value exports into the ``QuantRecipe`` (``qat.export``).
    ``quantize_inputs`` applies the eq-9 input cast (Table V inputs 2^5)
    to float batch features during training only.
    """

    backend: str = "lut"
    start_step: int = 0
    learn_exponent: bool = False
    freeze_exponent_step: int = 0      # 0: recalibrate every step
    quantize_inputs: bool = False


@dataclasses.dataclass(frozen=True)
class QATSpec:
    """Everything ``steps.make_train_step(qat=...)`` needs: the recipe
    (quantiser semantics — one source of truth with PTQ and the engine)
    and the training-side knobs."""

    recipe: QuantRecipe
    config: QATConfig = QATConfig()
    distill: Optional[Any] = None      # qat.distill.DistillSpec

    def exec_cfg(self, cfg):
        """The model config the QAT loss forward actually runs: the
        backend's approx modes pinned exactly as the Engine would."""
        return backends.get_backend(self.config.backend).configure(cfg)

    def check_device(self, device: torch.device) -> None:
        """A backend of hand-written kernels needs a CUDA device, as in
        ``runtime.compile_model``."""
        be = backends.get_backend(self.config.backend)
        if be.uses_kernels and device.type != "cuda":
            raise ValueError(
                f"QAT backend {be.name!r} runs hand-written CUDA kernels and "
                f"needs a CUDA device, got {str(device)!r}; on the CPU train "
                "under 'lut', whose forward and gradients the cuda backend "
                "reproduces")


def init_qat_state(spec: QATSpec, device=None) -> dict:
    """The QAT state on ``device`` (``None``: the card, raising where
    there is none)."""
    device = resolve_device(device)
    spec.check_device(device)
    return {"step": torch.zeros((), dtype=torch.int32, device=device),
            "weight_exponent": torch.tensor(
                float(spec.recipe.weight_exponent), dtype=torch.float32,
                device=device)}


def _fake_quant_batch(batch: dict, recipe: QuantRecipe) -> dict:
    """eq-9 cast on the float feature entries (mfcc); integer labels pass
    through."""
    return {k: fakequant.fake_quant_input(v, recipe)
            if v.is_floating_point() else v for k, v in batch.items()}


def _select_active(active, fq: Pytree, params: Pytree) -> Pytree:
    """Fake-quant values once QAT is active, raw shadow weights during
    the delayed-start warm-up (the one implementation of the gate — the
    train-step loss and the qat_params helper both use it)."""
    return tree_map(lambda a, b: torch.where(active, a, b.to(a.dtype)),
                    fq, params)


def qat_params(params: Pytree, spec: QATSpec, qstate: dict,
               exponent=None) -> Pytree:
    """The params the loss forward runs this step: fake-quant once active,
    raw float shadow weights during the delayed-start warm-up."""
    e = qstate["weight_exponent"] if exponent is None else exponent
    fq = fakequant.fake_quant_tree(params, spec.recipe, exponent=e)
    return _select_active(qstate["step"] >= spec.config.start_step,
                          fq, params)


def next_exponent(params: Pytree, spec: QATSpec, qstate: dict) -> torch.Tensor:
    """This step's weight exponent: recalibrated from the live shadow
    weights while learning (until the freeze step; 0 = never freeze),
    or the recipe's static Table V value when learning is off."""
    e = qstate["weight_exponent"]
    if not spec.config.learn_exponent:
        return e
    e_new = fakequant.calibrate_exponent(params, spec.recipe)
    if spec.config.freeze_exponent_step <= 0:
        return e_new
    return torch.where(qstate["step"] < spec.config.freeze_exponent_step,
                       e_new, e)


def make_qat_loss(cfg, qat: QATSpec):
    """``loss(params, batch, exponent, active)``: the QAT step's loss —
    fake-quant params (gated by ``active``) through the backend's
    execution config, plain CE or KD when ``qat.distill`` is set."""
    from repro_torch.launch import steps

    exec_cfg = qat.exec_cfg(cfg)
    steps.check_trainable(exec_cfg)
    base_loss = steps._loss(cfg)
    if qat.distill is not None:
        from repro_torch.qat import distill as distill_mod
        base_loss = distill_mod.make_distill_loss(qat.distill)

    def loss_at(params, batch, e, active):
        fq = fakequant.fake_quant_tree(params, qat.recipe, exponent=e)
        run = _select_active(active, fq, params)
        if qat.config.quantize_inputs:
            batch = _fake_quant_batch(batch, qat.recipe)
        return base_loss(run, batch, exec_cfg)

    return loss_at


def make_qat_train_step(cfg, shape, hp=None, n_micro=None, *, qat: QATSpec):
    """The QAT reading of ``steps.make_train_step`` (which delegates here).

    Per step: (1) resolve this step's weight exponent (learning /
    frozen), (2) fake-quant the shadow params (STE) and run the loss
    under the backend's approx modes — plain CE, or KD when
    ``qat.distill`` is set — and take its gradients, (3) AdamW on the
    float shadow weights, (4) advance ``qstate``.
    """
    from repro_torch.launch import steps

    hp = hp or steps.hparams_for(cfg)
    n_micro = n_micro or steps.microbatches(cfg, shape)
    loss_at = make_qat_loss(cfg, qat)
    steps.no_tf32()

    def train_step(params, opt_state, qstate, batch):
        device = tree_leaves(params)[0].device
        qat.check_device(device)
        batch = steps.to_device(batch, device)
        e = next_exponent(params, qat, qstate)
        active = qstate["step"] >= qat.config.start_step
        loss, grads = steps.accumulate(loss_at, params, batch, n_micro,
                                       e, active)
        new_params, new_opt, metrics = adamw.update(
            grads, opt_state, params, hp, scan_stacked=cfg.scan_layers)
        metrics.update(loss=loss, weight_exponent=e,
                       qat_active=active.to(torch.float32))
        new_q = {"step": qstate["step"] + 1, "weight_exponent": e}
        return new_params, new_opt, new_q, metrics

    return train_step


def finetune_qat(cfg, params, spec: QATSpec, n_steps: int, *, lr: float = 1e-3,
                 batch: int = 64, seed: int = 0, data_offset: int = 100_000,
                 fine_classes: int | None = None, select_fn=None,
                 select_every: int = 25, device=None):
    """Host-side KWT QAT fine-tune loop (what the examples run).

    Starts from float ``params`` (a trained baseline or a fresh init),
    moved to ``device`` (``None``: the card), runs ``n_steps`` of the QAT
    step on a fresh data fold, and returns ``(params, qstate)``.
    ``fine_classes`` draws the GSC-35-style fine-grained surrogate batches
    coarsened to binary labels (the KD regime).

    ``select_fn(deployed_params) -> score`` enables best-checkpoint
    selection on a *validation* fold: every ``select_every`` steps (plus
    step 0 and the final step) the candidate export is scored, and the
    best state wins.  The loss is read back to the host only on that
    cadence (a divergence guard), never every step.
    """
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.data import pipeline
    from repro_torch.launch import steps

    if cfg.family != "kwt":
        raise ValueError("finetune_qat drives the KWT surrogate task")
    device = resolve_device(device)
    params = tree_map(lambda t: t.to(device), params)
    shape = ShapeSpec("qat_ft", cfg.input_dim[1], batch, "train")
    hp = adamw.HParams(lr=lr, warmup_steps=max(2, n_steps // 10),
                       total_steps=max(n_steps, 10), weight_decay=0.0)
    step = steps.make_train_step(cfg, shape, hp, n_micro=1, qat=spec)
    opt = adamw.init(params, hp)
    qstate = init_qat_state(spec, device)
    best = None

    def consider(p, qs):
        nonlocal best
        if select_fn is None:
            return
        recipe = spec.recipe
        if spec.config.learn_exponent:
            recipe = recipe.with_(weight_exponent=int(qs["weight_exponent"]))
        score = float(select_fn(recipe.apply(p)))
        if best is None or score > best[0]:
            best = (score, p, qs)

    def check(m):
        if not bool(torch.isfinite(m["loss"])):
            raise FloatingPointError("QAT loss diverged")

    consider(params, qstate)
    m = None
    for i in range(n_steps):
        b = pipeline.keyword_batch(
            seed, data_offset + i, batch=batch, input_dim=cfg.input_dim,
            n_classes=fine_classes or cfg.n_classes)
        if fine_classes:
            b = {"mfcc": b["mfcc"], "labels": b["labels"] % cfg.n_classes}
        params, opt, qstate, m = step(params, opt, qstate, b)
        if (i + 1) % select_every == 0 and i != n_steps - 1:
            check(m)
            consider(params, qstate)
    if m is not None:
        check(m)
    consider(params, qstate)
    if best is not None:
        return best[1], best[2]
    return params, qstate
