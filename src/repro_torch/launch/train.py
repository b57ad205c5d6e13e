"""Fault-tolerant training launcher for the KWT family, on one device.

The twin of the reference's ``repro.launch.train`` with the same
production code paths (``steps.make_train_step`` + the checkpoint
manager):
  * deterministic stateless-seeded data (restart-exact resume),
  * periodic checkpointing (atomic rename; the optimizer state in a
    writer thread),
  * crash/preemption recovery: ``--fail-at-step N`` injects a failure;
    rerunning the same command resumes from the newest step complete in
    every tree (params, optimizer, QAT state),
  * straggler watchdog: an EWMA step-time monitor flags slow steps,
  * quantisation-aware training (``--qat``) under a runtime backend's
    numerics — ``--qat-backend cuda`` runs the hand-written LUT softmax
    and GELU kernels in every training forward, behind straight-through
    estimators — with optional KD from a float teacher
    (``--distill-teacher-arch``), and the export of the trained artifact.

Usage (the card by default; the CPU only with ``--device cpu``)::

  python -m repro_torch.launch.train --arch kwt-tiny --qat --qat-backend cuda \\
      --distill-teacher-arch kwt-1 --steps 200 --ckpt-dir /tmp/ckpt

The mesh flags (``--data``/``--model`` above 1), ``--compressed-grads``
and the LM families wait for ROADMAP queue A items 3 and 4.
"""

from __future__ import annotations

import argparse
import dataclasses
import math
import time
from typing import Any

import torch

from repro_torch.checkpoint import manager
from repro_torch.configs import registry
from repro_torch.configs.base import ShapeSpec
from repro_torch.data import pipeline
from repro_torch.device import resolve_device
from repro_torch.launch import steps
from repro_torch.optim import adamw


class StragglerMonitor:
    """EWMA step-time watchdog."""

    def __init__(self, alpha=0.2, threshold=2.5):
        self.alpha, self.threshold = alpha, threshold
        self.ewma = None
        self.flagged = []

    def observe(self, step, dt):
        if self.ewma is None:
            self.ewma = dt
            return False
        slow = dt > self.threshold * self.ewma
        if slow:
            self.flagged.append((step, dt, self.ewma))
            print(f"[straggler] step {step}: {dt*1e3:.1f}ms vs "
                  f"EWMA {self.ewma*1e3:.1f}ms -> would trigger reslicing")
        self.ewma = (1 - self.alpha) * self.ewma + self.alpha * dt
        return slow


@dataclasses.dataclass
class TrainResult:
    """What a run leaves behind: the trained trees, the loss and the host
    time of every step it ran (``step_ms``: the step and the read of its
    loss, which waits for the device), the step it resumed from (or
    ``None``), the QAT spec and the exported artifact (``None`` without
    ``--qat``)."""

    params: Any
    opt_state: Any
    qstate: Any
    cfg: Any
    losses: list
    step_ms: list
    resumed_from: int | None
    qat_spec: Any = None
    export: Any = None


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="kwt-tiny")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--data", type=int, default=1, help="mesh data axis")
    ap.add_argument("--model", type=int, default=1, help="mesh model axis")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=5)
    ap.add_argument("--fail-at-step", type=int, default=-1,
                    help="inject a crash at this step (recovery demo)")
    ap.add_argument("--compressed-grads", action="store_true",
                    help="int8 error-feedback gradient sync (not ported)")
    ap.add_argument("--qat", action="store_true",
                    help="quantisation-aware training: the loss forward "
                         "runs eq-9 fake-quant params under --qat-backend's "
                         "LUT modes (repro_torch.qat)")
    ap.add_argument("--qat-backend", default="lut",
                    help="runtime backend whose numerics the QAT loss runs "
                         "(cuda: the hand-written kernels, on the card)")
    ap.add_argument("--qat-start-step", type=int, default=0,
                    help="float warm-up steps before fake-quant activates")
    ap.add_argument("--qat-learn-exponent", action="store_true",
                    help="recalibrate the weight exponent from the shadow "
                         "weights until --qat-freeze-exponent-step")
    ap.add_argument("--qat-freeze-exponent-step", type=int, default=0,
                    help="freeze the learned exponent after this step "
                         "(0: keep recalibrating every step)")
    ap.add_argument("--distill-teacher-arch", default=None,
                    help="float teacher arch for KD during QAT (e.g. kwt-1; "
                         "its head is reduced to the student's classes)")
    ap.add_argument("--distill-teacher-steps", type=int, default=200,
                    help="float training steps for the inline KD teacher")
    ap.add_argument("--distill-alpha", type=float, default=0.5)
    ap.add_argument("--distill-temp", type=float, default=2.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card; 'cpu' only when "
                         "asked for)")
    return ap


def _qat_spec(args, cfg, device):
    """The QAT spec of the flags, with its inline KD teacher trained on
    ``device``; and the teacher's class count (the fine-grained batches it
    needs) or ``None``."""
    from repro_torch import qat as qat_mod
    from repro_torch.runtime import QuantRecipe

    distill, fine_classes = None, None
    if args.distill_teacher_arch:
        from repro_torch.qat import distill as distill_mod
        tcfg = distill_mod.teacher_config(
            registry.get(args.distill_teacher_arch).config, cfg)
        print(f"[distill] training float teacher {tcfg.name} "
              f"({args.distill_teacher_steps} steps, {tcfg.n_classes} "
              "classes)", flush=True)
        tparams = distill_mod.train_teacher(
            tcfg, args.distill_teacher_steps, seed=args.seed + 1,
            device=device)
        tparams = distill_mod.reduce_head(tparams)
        distill = distill_mod.DistillSpec(
            tparams, tcfg.with_(n_classes=cfg.n_classes),
            alpha=args.distill_alpha, temperature=args.distill_temp)
        # KD draws the fine-grained surrogate (coarsened to the student's
        # classes) so the teacher stays on-distribution
        fine_classes = tcfg.n_classes
    spec = qat_mod.QATSpec(
        QuantRecipe.from_config(cfg),
        qat_mod.QATConfig(backend=args.qat_backend,
                          start_step=args.qat_start_step,
                          learn_exponent=args.qat_learn_exponent,
                          freeze_exponent_step=args.qat_freeze_exponent_step),
        distill=distill)
    spec.check_device(device)
    print(f"[qat] recipe {spec.recipe} under backend={args.qat_backend}",
          flush=True)
    return spec, fine_classes


def _restore(args, params, opt_state, qstate):
    """Resume from the newest step complete in EVERY tree: the optimizer
    save runs in a thread, so a crash can leave params one step ahead;
    the QAT state (the learned exponent and the step counter) must
    restore with the params or the exported recipe would drift."""
    cand = [manager.latest_step(args.ckpt_dir),
            manager.latest_step(args.ckpt_dir + "/opt")]
    if qstate is not None:
        cand.append(manager.latest_step(args.ckpt_dir + "/qat"))
    if cand[0] is not None and any(c is None for c in cand[1:]):
        print(f"[restore] params checkpoint at step {cand[0]} has no "
              "complete optimizer/QAT state — starting from step 0")
    latest = None if any(c is None for c in cand) else min(cand)
    if latest is None:
        return params, opt_state, qstate, None
    print(f"[restore] resuming from step {latest}", flush=True)
    params = manager.restore(args.ckpt_dir, latest, params)
    opt_state = manager.restore(args.ckpt_dir + "/opt", latest, opt_state)
    if qstate is not None:
        qstate = manager.restore(args.ckpt_dir + "/qat", latest, qstate)
    return params, opt_state, qstate, latest


def main(argv=None) -> TrainResult:
    args = _parser().parse_args(argv)
    if args.data * args.model != 1:
        steps.not_ported("a device mesh (--data/--model)", "item 4 (dist)")
    if args.compressed_grads:
        steps.not_ported("--compressed-grads", "item 4 (dist)")
    cfg = registry.get(args.arch).config
    if cfg.family != "kwt":
        steps.not_ported(f"training family {cfg.family!r}",
                         "item 3 (LM families)")
    if args.distill_teacher_arch and not args.qat:
        raise ValueError("--distill-teacher-arch is the KD path of --qat")
    device = resolve_device(args.device)
    shape = ShapeSpec("custom", cfg.input_dim[1], args.global_batch, "train")
    hp = dataclasses.replace(steps.hparams_for(cfg), lr=1e-3,
                             warmup_steps=max(2, args.steps // 10),
                             total_steps=max(args.steps, 10))
    mod = steps.model_module(cfg)

    qat_spec, fine_classes = None, None
    if args.qat:
        qat_spec, fine_classes = _qat_spec(args, cfg, device)

    params = mod.init_params(cfg, torch.Generator().manual_seed(args.seed),
                             device)
    opt_state = adamw.init(params, hp)
    qstate = None
    if qat_spec is not None:
        from repro_torch import qat as qat_mod
        qstate = qat_mod.init_qat_state(qat_spec, device)

    resumed_from, start_step = None, 0
    if args.ckpt_dir:
        params, opt_state, qstate, resumed_from = _restore(
            args, params, opt_state, qstate)
        start_step = resumed_from or 0

    train_step = steps.make_train_step(cfg, shape, hp, n_micro=1,
                                       qat=qat_spec)
    mon = StragglerMonitor()
    losses, step_ms = [], []
    pending = None
    try:
        for step in range(start_step, args.steps):
            if step == args.fail_at_step:
                raise RuntimeError(
                    f"[injected failure] node lost at step {step} — rerun "
                    "the same command to recover from the last checkpoint")
            batch = pipeline.keyword_batch(
                args.seed, step, batch=args.global_batch,
                input_dim=cfg.input_dim,
                n_classes=fine_classes or cfg.n_classes)
            if fine_classes:
                batch = {"mfcc": batch["mfcc"],
                         "labels": batch["labels"] % cfg.n_classes}
            batch = steps.to_device(batch, device)
            t0 = time.perf_counter()
            if qstate is not None:
                params, opt_state, qstate, metrics = train_step(
                    params, opt_state, qstate, batch)
            else:
                params, opt_state, metrics = train_step(params, opt_state,
                                                        batch)
            loss = float(metrics["loss"])
            dt = time.perf_counter() - t0
            losses.append(loss)
            step_ms.append(dt * 1e3)
            mon.observe(step, dt)
            print(f"step {step:5d} loss {loss:.4f} "
                  f"lr {float(metrics['lr']):.2e} "
                  f"gnorm {float(metrics['grad_norm']):.3f} {dt*1e3:.1f}ms",
                  flush=True)
            if not math.isfinite(loss):
                raise FloatingPointError("loss diverged")
            if args.ckpt_dir and (step + 1) % args.ckpt_every == 0:
                if pending is not None:
                    pending.join()
                manager.save(args.ckpt_dir, step + 1, params, blocking=True)
                if qstate is not None:
                    manager.save(args.ckpt_dir + "/qat", step + 1, qstate,
                                 blocking=True)
                pending = manager.save(args.ckpt_dir + "/opt", step + 1,
                                       opt_state, blocking=False)
    finally:
        # a failing step leaves the optimizer writer running: let it end,
        # so that what the next run restores does not depend on timing
        if pending is not None:
            pending.join()
    ex = None
    if qat_spec is not None:
        from repro_torch import qat as qat_mod
        ex = qat_mod.export(params, qat_spec, qstate)
        print(f"[qat] exported recipe: {ex.recipe}; packed int bytes "
              f"{ex.quantized_bytes[0]} + float {ex.quantized_bytes[1]}")
    print("training complete.", flush=True)
    return TrainResult(params=params, opt_state=opt_state, qstate=qstate,
                       cfg=cfg, losses=losses, step_ms=step_ms,
                       resumed_from=resumed_from, qat_spec=qat_spec, export=ex)


if __name__ == "__main__":
    main()
