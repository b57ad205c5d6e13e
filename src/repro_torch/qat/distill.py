"""Knowledge distillation into the quantised student (paper §III route).

The paper's headline shrink — KWT-1 retrained 369x smaller (35 -> 2
classes) — is a *retraining* result, and KD is the strongest retraining
signal the quantised student can get: a float KWT-1 teacher's soft
posteriors carry the inter-class structure the 2-class hard labels throw
away.

* :func:`teacher_config` — a KWT-1 teacher on the *student's* input grid.
* :func:`train_teacher` — float teacher training on the n-class surrogate.
* :func:`reduce_head` — the 35 -> 2 head reduction.
* :func:`shrink_teacher` — ablation-driven depth shrink (``tools.surgeon``).
* :class:`DistillSpec` / :func:`make_distill_loss` — the KD loss
  ``(1-alpha)*CE + alpha*T^2*KL(teacher_T || student_T)`` in the shape
  ``launch.steps``' loss contract expects.  The teacher's forward runs
  under ``torch.no_grad()`` in its exact modes, so it records no graph
  and launches no kernel.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch.device import resolve_device
from repro_torch.models import kwt
from repro_torch.optim import adamw

Pytree = Any


def teacher_config(teacher_cfg, student_cfg):
    """The teacher re-gridded onto the student's MFCC input (and float
    execution modes): KD evaluates both models on the same batch."""
    return teacher_cfg.with_(input_dim=student_cfg.input_dim,
                             patch_dim=(student_cfg.input_dim[0], 1),
                             softmax_mode="exact", act_approx="exact")


def train_teacher(tcfg, steps: int, seed: int = 0, batch: int = 64,
                  lr: float = 3e-3, init_params: Pytree | None = None,
                  device=None):
    """Float teacher training on the synthetic n-class keyword task, on
    ``device`` (``None``: the card).  ``init_params`` resumes from an
    existing tree — the retrain half of the paper's remove-then-retrain
    shrink (§III)."""
    from repro_torch.data import pipeline
    from repro_torch.launch import steps as steps_mod

    device = resolve_device(device)
    steps_mod.no_tf32()
    hp = adamw.HParams(lr=lr, warmup_steps=max(2, steps // 10),
                       total_steps=max(steps, 10), weight_decay=0.0)
    params = init_params if init_params is not None else \
        kwt.init_params(tcfg, torch.Generator().manual_seed(seed), device)
    state = adamw.init(params, hp)
    for i in range(steps):
        b = steps_mod.to_device(pipeline.keyword_batch(
            seed, i, batch=batch, input_dim=tcfg.input_dim,
            n_classes=tcfg.n_classes), device)
        _, grads = steps_mod.value_and_grad(
            lambda p: kwt.loss_fn(p, b, tcfg), params)
        params, state, _ = adamw.update(grads, state, params, hp,
                                        scan_stacked=False)
    return params


def reduce_head(tparams: Pytree, keyword_classes=None) -> Pytree:
    """Collapse an n-class head to the student's 2 classes (paper §III,
    35 -> 2).

    ``keyword_classes`` are the teacher columns that mean-pool into
    student class 1 (the keyword); every other column pools into the
    background class 0.  Default: the odd classes — the fine-grained
    surrogate's coarsening rule (``data.pipeline.keyword_batch``: class c
    is a variant of binary class ``c % 2``).  Only the head changes; the
    encoder transfers as-is.
    """
    hw, hb = tparams["head_w"], tparams["head_b"]
    n = hw.shape[-1]
    if keyword_classes is None:
        keyword_classes = range(1, n, 2)
    kw = sorted(set(int(c) for c in keyword_classes))
    if not 0 < len(kw) < n:
        raise ValueError("keyword classes must be a proper subset")
    bg = [c for c in range(n) if c not in set(kw)]
    kw_idx = torch.tensor(kw, device=hw.device)
    bg_idx = torch.tensor(bg, device=hw.device)
    bg_w = hw[:, bg_idx].mean(dim=-1, keepdim=True)
    kw_w = hw[:, kw_idx].mean(dim=-1, keepdim=True)
    bg_b = hb[bg_idx].mean()[None]
    kw_b = hb[kw_idx].mean()[None]
    return {**tparams,
            "head_w": torch.cat([bg_w, kw_w], dim=-1),
            "head_b": torch.cat([bg_b, kw_b])}


def shrink_teacher(tparams: Pytree, tcfg, keep_layers: int, batches,
                   loss_fn=kwt.loss_fn):
    """Ablation-driven depth shrink (``tools.surgeon``): keep only the
    ``keep_layers`` highest-impact blocks — the cheap KD teacher."""
    from repro_torch.tools import surgeon

    _, scores = surgeon.ablation_scores(tparams, tcfg, batches, loss_fn)
    shrunk = surgeon.shrink_params(tparams, scores, keep=keep_layers)
    return shrunk, tcfg.with_(n_layers=keep_layers)


@dataclasses.dataclass(frozen=True)
class DistillSpec:
    """KD configuration: a (reduced-head) float teacher + loss weights."""

    teacher_params: Any
    teacher_cfg: Any
    alpha: float = 0.5             # KD weight: (1-a)*CE + a*KD
    temperature: float = 2.0


def make_distill_loss(spec: DistillSpec):
    """A ``loss(params, batch, cfg)`` in the ``launch.steps`` contract: CE
    on the hard labels + temperature-softened KL to the float teacher.
    ``cfg`` is the *student's* exec config (the QAT step passes the
    backend-pinned one), so the student runs the deployed numerics while
    the teacher stays exact float, under ``torch.no_grad()``."""
    t = float(spec.temperature)
    a = float(spec.alpha)

    def loss(params, batch, cfg):
        s_logits = kwt.forward(params, batch["mfcc"], cfg)
        labels = batch["labels"]
        logz = torch.logsumexp(s_logits, dim=-1)
        gold = s_logits.gather(-1, labels[:, None])[:, 0]
        ce = (logz - gold).mean()
        with torch.no_grad():
            t_logits = kwt.forward(spec.teacher_params, batch["mfcc"],
                                   spec.teacher_cfg)
        t_soft = torch.log_softmax(t_logits / t, dim=-1)
        s_soft = torch.log_softmax(s_logits / t, dim=-1)
        kd = (torch.exp(t_soft) * (t_soft - s_soft)).sum(dim=-1).mean()
        return (1.0 - a) * ce + a * (t * t) * kd

    return loss
