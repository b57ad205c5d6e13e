"""Fault-tolerant training launcher: the KWT family and the LM families
(dense, moe, rwkv, hybrid, encdec), on one device or a mesh of ranks.

The twin of the reference's ``repro.launch.train`` with the same
production code paths (``steps.make_train_step`` + the checkpoint
manager):
  * deterministic stateless-seeded data (restart-exact resume): KWT's
    keyword batches, the LMs' token stream (``pipeline.lm_batch``), the
    encoder-decoder's frames and tokens (``_whisper_batch``),
  * periodic checkpointing (atomic rename; the optimizer state in a
    writer thread),
  * crash/preemption recovery: ``--fail-at-step N`` injects a failure;
    rerunning the same command resumes from the newest step complete in
    every tree (params, optimizer, QAT state),
  * straggler watchdog: an EWMA step-time monitor flags slow steps,
  * the error-feedback compressed gradient sync (``--compressed-grads``,
    ``--per-channel-scales``, ``--grad-bits``; ``dist.compress``): on one
    device a ring of one, which quantises and dequantises every gradient
    and carries the residual; the residuals are a third checkpoint tree
    (``<ckpt-dir>/err``),
  * quantisation-aware training (``--qat``) under a runtime backend's
    numerics — ``--qat-backend cuda`` runs the hand-written LUT softmax
    (and, for a GELU model, the LUT GELU) in every training forward,
    behind straight-through estimators — with optional KD from a float
    teacher for KWT (``--distill-teacher-arch``), and the export of the
    trained artifact.

On a mesh (``--data`` x ``--model`` ranks under ``torch.distributed.run``,
which the launcher joins: NCCL on the card, gloo with ``--device cpu``)
the weights are drawn whole on every rank from ``--seed`` and placed by
``steps.param_pspecs``, the optimizer state by ``adamw.opt_state_specs``;
every rank draws the global batch and the step takes its data shard
(``steps.batch_pspec``, ``dist.spmd``); ``--compressed-grads`` rings over
the mesh's data axis.  Checkpoints hold full tensors, written once (rank
0) and placed on restore onto whatever mesh the restart builds, so a run
resumes on another ``--data`` / ``--model`` shape; the error state's
expert leaves, each model rank's own slice, are gathered over
``"model"`` before the save and cut again on restore.

An LM trains at ``--seq-len`` tokens (``--smoke``: its arch's reduced
config), with its weights drawn from ``--seed`` on the device (full width
on the card); a config with ``remat`` set checkpoints every layer.  With
``--device cpu`` an LM's ``--qat-backend cuda`` runs the kernels' plain
versions, as ``launch.serve`` plans ``cuda`` there; KWT's refuses it.

Usage (the card by default; the CPU only with ``--device cpu``)::

  python -m repro_torch.launch.train --arch kwt-tiny --qat --qat-backend cuda \\
      --distill-teacher-arch kwt-1 --steps 200 --ckpt-dir /tmp/ckpt
  python -m repro_torch.launch.train --arch internlm2-1.8b --steps 8 \\
      --global-batch 8 --seq-len 256 --qat --qat-backend cuda
  python -m torch.distributed.run --nproc-per-node 4 \\
      -m repro_torch.launch.train --device cpu --data 2 --model 2 \\
      --arch granite-8b --smoke --steps 8 --ckpt-dir /tmp/ckpt
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import math
import os
import time
from typing import Any

import torch

from repro_torch.checkpoint import manager
from repro_torch.configs import registry
from repro_torch.configs.base import ShapeSpec
from repro_torch.data import pipeline, prng
from repro_torch.device import resolve_device
from repro_torch.dist import ctx, sharding, spmd
from repro_torch.launch import mesh as mesh_mod
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
    ``--qat``), and the error-feedback state (``None`` without
    ``--compressed-grads``)."""

    params: Any
    opt_state: Any
    qstate: Any
    cfg: Any
    losses: list
    step_ms: list
    resumed_from: int | None
    qat_spec: Any = None
    export: Any = None
    err: Any = None


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="kwt-tiny")
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced same-family config (CPU-sized)")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=64,
                    help="tokens per sequence (the LM families; KWT's is "
                         "its input's time axis)")
    ap.add_argument("--data", type=int, default=1, help="mesh data axis")
    ap.add_argument("--model", type=int, default=1, help="mesh model axis")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=5)
    ap.add_argument("--fail-at-step", type=int, default=-1,
                    help="inject a crash at this step (recovery demo)")
    ap.add_argument("--compressed-grads", action="store_true",
                    help="int8 error-feedback gradient sync on the mesh's "
                         "slow axis (dist.compress)")
    ap.add_argument("--per-channel-scales", action="store_true",
                    help="per-channel payload scales for --compressed-grads")
    ap.add_argument("--grad-bits", type=int, default=8, choices=(4, 8),
                    help="wire width for --compressed-grads payloads "
                         "(4: nibble-packed via the shared core.quant "
                         "codec, half the int8 wire bytes)")
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
                    help="KWT only: float teacher arch for KD during QAT "
                         "(e.g. kwt-1; its head is reduced to the "
                         "student's classes)")
    ap.add_argument("--distill-teacher-steps", type=int, default=200,
                    help="float training steps for the inline KD teacher")
    ap.add_argument("--distill-alpha", type=float, default=0.5)
    ap.add_argument("--distill-temp", type=float, default=2.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card; 'cpu' only when "
                         "asked for)")
    return ap


def _qat_spec(args, cfg, device, ap):
    """The QAT spec of the flags, with its inline KD teacher trained on
    ``device``; and the teacher's class count (the fine-grained batches it
    needs) or ``None``."""
    from repro_torch import qat as qat_mod
    from repro_torch.runtime import QuantRecipe

    distill, fine_classes = None, None
    if args.distill_teacher_arch:
        if cfg.family != "kwt":
            ap.error("--distill-teacher-arch is the KWT KD path "
                     "(paper §III); LM QAT runs without a teacher")
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
        distill=distill,
        plain_kernels=cfg.family != "kwt" and device.type == "cpu")
    spec.check_device(device)
    print(f"[qat] recipe {spec.recipe} under backend={args.qat_backend}",
          flush=True)
    return spec, fine_classes


def _join(args, device) -> None:
    """Join the process group ``torch.distributed.run`` describes (its
    ``WORLD_SIZE`` / ``RANK`` / ``MASTER_ADDR`` environment) unless the
    caller has joined one: NCCL on the card, gloo on the CPU."""
    import torch.distributed as dist
    if dist.is_initialized():
        return
    n = args.data * args.model
    if "WORLD_SIZE" not in os.environ:
        if n > 1:
            raise ValueError(
                f"a ({args.data}, {args.model}) mesh needs {n} ranks: run "
                f"under python -m torch.distributed.run --nproc-per-node {n}")
        return
    dist.init_process_group("nccl" if device.type == "cuda" else "gloo")


def _rank0() -> bool:
    import torch.distributed as dist
    return not dist.is_initialized() or dist.get_rank() == 0


def _save(ckpt_dir, step, tree, *, blocking):
    """Full tensors (gathered on every rank), written by rank 0."""
    tree = sharding.full(tree)
    if not _rank0():
        return None
    return manager.save(ckpt_dir, step, tree, blocking=blocking)


def _restore(args, params, opt_state, qstate, err):
    """Resume from the newest step complete in EVERY tree: the optimizer
    save runs in a thread, so a crash can leave params one step ahead;
    with ``--compressed-grads`` the error-feedback residuals are a third
    tree (dropping them would break the telescoping drift bound at every
    restart); the QAT state (the learned exponent and the step counter)
    must restore with the params or the exported recipe would drift."""
    cand = [manager.latest_step(args.ckpt_dir),
            manager.latest_step(args.ckpt_dir + "/opt")]
    if err is not None:
        cand.append(manager.latest_step(args.ckpt_dir + "/err"))
    if qstate is not None:
        cand.append(manager.latest_step(args.ckpt_dir + "/qat"))
    if cand[0] is not None and any(c is None for c in cand[1:]):
        print(f"[restore] params checkpoint at step {cand[0]} has no "
              "complete optimizer/error/QAT state — starting from step 0")
    latest = None if any(c is None for c in cand) else min(cand)
    if latest is None:
        return params, opt_state, qstate, err, None
    if _rank0():
        print(f"[restore] resuming from step {latest}", flush=True)
    if err is not None:
        # saved whole (gather_slices); each rank takes its expert slices
        err = spmd.cut_slices(manager.restore(
            args.ckpt_dir + "/err", latest,
            spmd.gather_slices(err, params)), params)
    params = manager.restore(args.ckpt_dir, latest, params)
    opt_state = manager.restore(args.ckpt_dir + "/opt", latest, opt_state)
    if qstate is not None:
        qstate = manager.restore(args.ckpt_dir + "/qat", latest, qstate)
    return params, opt_state, qstate, err, latest


def _whisper_batch(args, cfg, step) -> dict:
    """The encoder-decoder's synthetic batch for ``step``: standard-normal
    frames ``[B, enc_seq, d_model]`` (the stub frontend's output) and
    uniform tokens, labels the tokens shifted by one — the reference's
    keys and draws (``data.prng``: tokens exact, frames within the
    normals' tolerance)."""
    key = prng.fold_in(prng.PRNGKey(args.seed + 77), step)
    k1, k2 = prng.split(key)
    frames = prng.normal(k1, (args.global_batch, cfg.enc_seq, cfg.d_model))
    toks = prng.randint(k2, (args.global_batch, args.seq_len + 1), 0,
                        cfg.vocab_size)
    return {"frames": torch.from_numpy(frames),
            "tokens": torch.from_numpy(toks[:, :-1].copy()),
            "labels": torch.from_numpy(toks[:, 1:].copy())}


def _batch(args, cfg, step, fine_classes) -> dict:
    if cfg.family == "kwt":
        batch = pipeline.keyword_batch(
            args.seed, step, batch=args.global_batch, input_dim=cfg.input_dim,
            n_classes=fine_classes or cfg.n_classes)
        if fine_classes:
            batch = {"mfcc": batch["mfcc"],
                     "labels": batch["labels"] % cfg.n_classes}
        return batch
    if cfg.family == "encdec":
        return _whisper_batch(args, cfg, step)
    return pipeline.lm_batch(args.seed, step, global_batch=args.global_batch,
                             seq_len=args.seq_len, vocab_size=cfg.vocab_size)


def main(argv=None) -> TrainResult:
    ap = _parser()
    args = ap.parse_args(argv)
    entry = registry.get(args.arch)
    cfg = entry.smoke if args.smoke else entry.config
    if args.distill_teacher_arch and not args.qat:
        raise ValueError("--distill-teacher-arch is the KD path of --qat")
    device = resolve_device(args.device)
    if device.type == "cuda" and "LOCAL_RANK" in os.environ:
        device = torch.device("cuda", int(os.environ["LOCAL_RANK"]))
        torch.cuda.set_device(device)
    _join(args, device)
    mesh = mesh_mod.make_host_mesh(args.data, args.model, device)
    on_mesh = sharding.is_device_mesh(mesh)
    kwt = cfg.family == "kwt"
    seq_len = cfg.input_dim[1] if kwt else args.seq_len
    shape = ShapeSpec("custom", seq_len, args.global_batch, "train")
    hp = dataclasses.replace(steps.hparams_for(cfg), lr=1e-3,
                             warmup_steps=max(2, args.steps // 10),
                             total_steps=max(args.steps, 10))
    mod = steps.model_module(cfg)

    qat_spec, fine_classes = None, None
    if args.qat:
        qat_spec, fine_classes = _qat_spec(args, cfg, device, ap)

    # KWT draws its weights on the host; an LM on the device (as
    # launch.serve: full width on the card)
    gen = torch.Generator() if kwt else torch.Generator(device=device)
    params = mod.init_params(cfg, gen.manual_seed(args.seed), device)
    opt_state = adamw.init(params, hp)
    qstate = None
    if qat_spec is not None:
        from repro_torch import qat as qat_mod
        qstate = qat_mod.init_qat_state(qat_spec, device)

    p_specs = steps.param_pspecs(cfg)
    o_specs = adamw.opt_state_specs(p_specs, hp)
    if on_mesh:
        params = sharding.place(params, p_specs, mesh)
        opt_state = sharding.place(opt_state, o_specs, mesh)
    err = None
    if args.compressed_grads:
        from repro_torch.dist import compress
        err = spmd.compute_zeros(params) if on_mesh else \
            compress.init_error_state(params)

    resumed_from, start_step = None, 0
    if args.ckpt_dir:
        params, opt_state, qstate, err, resumed_from = _restore(
            args, params, opt_state, qstate, err)
        start_step = resumed_from or 0
        if on_mesh and resumed_from is not None:
            params = sharding.place(params, p_specs, mesh)
            opt_state = sharding.place(opt_state, o_specs, mesh)

    sync_mesh = mesh if args.compressed_grads else None
    dp = steps.dp_for(shape, mesh)
    train_step = steps.make_train_step(
        cfg, shape, hp, n_micro=1, sync_mesh=sync_mesh,
        sync_per_channel=args.per_channel_scales, sync_bits=args.grad_bits,
        qat=qat_spec)
    mon = StragglerMonitor()
    losses, step_ms = [], []
    pending = None
    scope = contextlib.ExitStack()
    if on_mesh:
        scope.enter_context(mesh)
        scope.enter_context(ctx.mesh_context(dp))
    try:
        for step in range(start_step, args.steps):
            if step == args.fail_at_step:
                raise RuntimeError(
                    f"[injected failure] node lost at step {step} — rerun "
                    "the same command to recover from the last checkpoint")
            batch = steps.to_device(_batch(args, cfg, step, fine_classes),
                                    device)
            t0 = time.perf_counter()
            if qstate is not None and err is not None:
                params, opt_state, qstate, err, metrics = train_step(
                    params, opt_state, qstate, err, batch)
            elif qstate is not None:
                params, opt_state, qstate, metrics = train_step(
                    params, opt_state, qstate, batch)
            elif err is not None:
                params, opt_state, err, metrics = train_step(
                    params, opt_state, err, batch)
            else:
                params, opt_state, metrics = train_step(params, opt_state,
                                                        batch)
            loss = float(metrics["loss"])
            dt = time.perf_counter() - t0
            losses.append(loss)
            step_ms.append(dt * 1e3)
            mon.observe(step, dt)
            if _rank0():
                print(f"step {step:5d} loss {loss:.4f} "
                      f"lr {float(metrics['lr']):.2e} "
                      f"gnorm {float(metrics['grad_norm']):.3f} "
                      f"{dt*1e3:.1f}ms", flush=True)
            if not math.isfinite(loss):
                raise FloatingPointError("loss diverged")
            if args.ckpt_dir and (step + 1) % args.ckpt_every == 0:
                if pending is not None:
                    pending.join()
                _save(args.ckpt_dir, step + 1, params, blocking=True)
                if err is not None:
                    _save(args.ckpt_dir + "/err", step + 1,
                          spmd.gather_slices(err, params), blocking=True)
                if qstate is not None:
                    _save(args.ckpt_dir + "/qat", step + 1, qstate,
                          blocking=True)
                pending = _save(args.ckpt_dir + "/opt", step + 1,
                                opt_state, blocking=False)
    finally:
        # a failing step leaves the optimizer writer running: let it end,
        # so that what the next run restores does not depend on timing
        if pending is not None:
            pending.join()
        scope.close()
    ex = None
    if qat_spec is not None:
        from repro_torch import qat as qat_mod
        ex = qat_mod.export(sharding.full(params), qat_spec, qstate)
        print(f"[qat] exported recipe: {ex.recipe}; packed int bytes "
              f"{ex.quantized_bytes[0]} + float {ex.quantized_bytes[1]}")
    if _rank0():
        print("training complete.", flush=True)
    return TrainResult(params=params, opt_state=opt_state, qstate=qstate,
                       cfg=cfg, losses=losses, step_ms=step_ms,
                       resumed_from=resumed_from, qat_spec=qat_spec, export=ex,
                       err=err)


if __name__ == "__main__":
    main()
