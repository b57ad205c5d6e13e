"""QAT end to end: train exactly the model the Engine deploys.

The paper's accuracy-recovery half (§III retraining + §IV quantisation)
as one pipeline on KWT-Tiny:

1. Train the float baseline (paper Table IV, 1646 params).
2. PTQ it (Table V best recipe) — the accuracy the old pipeline shipped.
3. QAT fine-tune (repro_torch.qat): eq-9 fake-quant weights + Q8.24 LUT
   softmax/GELU in the loss forward (on ``--qat-backend cuda`` the
   hand-written kernels), float shadow weights under AdamW.
4. Optionally distill from a float KWT-1 teacher while quantising
   (--distill; 35->2 head reduction + ablation-driven depth shrink).
5. Export (repro_torch.qat.export) and verify the acceptance contract:
   QAT eval logits are BIT-IDENTICAL to the exported recipe on the
   non-executing ``lut`` Engine, and (--check-backends) the exported
   params run the whole backend matrix.

Run:  PYTHONPATH=src python -m repro_torch.examples.train_kws_qat
          [--steps 300] [--qat-steps 200] [--distill] [--check-backends]
          [--device cpu]
Exits non-zero if export parity fails or QAT ends below PTQ accuracy.
"""

from __future__ import annotations

import argparse
import importlib
import sys

import torch

from repro_torch import qat, runtime
from repro_torch.configs import registry
from repro_torch.data import pipeline
from repro_torch.device import resolve_device
from repro_torch.examples._common import add_device_arg, plan
from repro_torch.launch import steps
from repro_torch.models import kwt
from repro_torch.qat import distill as D

# the package's ``qat.export`` names the function; the module by path
qat_export = importlib.import_module("repro_torch.qat.export")


def make_eval(cfg, exec_cfg, seed, n, device):
    """Param-tree accuracy on one eval fold (seed 0: test fold; other
    seeds: validation folds for checkpoint selection)."""
    batches = [steps.to_device(b, device) for b in
               pipeline.gsc_eval_set(seed, n=n, input_dim=cfg.input_dim)]

    @torch.no_grad()
    def acc(deployed_params):
        correct = total = 0
        for b in batches:
            pred = kwt.forward(deployed_params, b["mfcc"], exec_cfg).argmax(-1)
            correct += int((pred == b["labels"]).sum())
            total += int(b["labels"].numel())
        return correct / total

    return acc


def accuracy(eng, n=512):
    return make_eval(eng.cfg, eng.exec_cfg, 0, n, eng.device)(
        eng.live_params())


def make_distill_spec(cfg, args, device):
    tcfg = D.teacher_config(registry.get("kwt-1").config, cfg)
    print("[distill] training float KWT-1 teacher on the student grid "
          f"({tcfg.n_layers} layers, {tcfg.n_classes} classes, "
          f"{args.teacher_steps} steps)")
    tparams = D.train_teacher(tcfg, args.teacher_steps, seed=args.seed + 1,
                              device=device)
    if args.teacher_keep_layers and \
            args.teacher_keep_layers < tcfg.n_layers:
        cal = [steps.to_device(pipeline.keyword_batch(
            args.seed + 2, i, batch=64, input_dim=tcfg.input_dim,
            n_classes=tcfg.n_classes), device) for i in range(2)]
        tparams, tcfg = D.shrink_teacher(tparams, tcfg,
                                         args.teacher_keep_layers, cal)
        # the paper's §III loop is remove-THEN-RETRAIN: a chopped
        # post-norm stack needs the retrain half before it can teach
        tparams = D.train_teacher(tcfg, args.teacher_steps,
                                  seed=args.seed + 1, init_params=tparams,
                                  device=device)
        print(f"[distill] surgeon shrink -> {tcfg.n_layers} highest-impact "
              "teacher blocks (+retrain)")
    tparams = D.reduce_head(tparams)
    print(f"[distill] head reduced {registry.get('kwt-1').config.n_classes}"
          f" -> {cfg.n_classes} classes")
    return D.DistillSpec(tparams, tcfg.with_(n_classes=cfg.n_classes),
                         alpha=args.distill_alpha,
                         temperature=args.distill_temp)


def train_float(cfg, args, device, init=None):
    """[1] the float baseline (``distill.train_teacher`` is the generic
    float kwt training loop; on the student config it trains the 2-class
    task), from ``init`` where given."""
    return D.train_teacher(cfg, args.steps, seed=args.seed, lr=3e-3,
                           init_params=init, device=device)


def recipe_for(cfg, fparams, bits: int):
    """The PTQ recipe at ``bits``.  Sub-8-bit recipes calibrate the weight
    exponent to the analytic no-saturation bound — Table V's 2^6
    saturates nearly everything at a 4-bit grid."""
    recipe = runtime.QuantRecipe.from_config(cfg, bits=bits)
    if bits < 8:
        recipe = recipe.calibrated(fparams)
    return recipe


def train_qat(cfg, fparams, recipe, args, device, distill=None):
    """[3] the QAT fine-tune (optionally distilled) with best-checkpoint
    selection on a validation fold; returns ``(qparams, spec, qstate)``."""
    spec = qat.QATSpec(recipe, qat.QATConfig(backend=args.qat_backend),
                       distill=distill,
                       plain_kernels=device.type == "cpu")
    qat_steps = args.qat_steps if args.qat_steps is not None else args.steps
    qparams, qstate = qat.finetune_qat(
        cfg, fparams, spec, qat_steps, seed=args.seed,
        fine_classes=35 if distill is not None else None,
        select_fn=make_eval(cfg, spec.exec_cfg(cfg), 5, 256, device),
        device=device)
    return qparams, spec, qstate


def report(cfg, fparams, args, device, qat_fn=train_qat) -> dict:
    """[1]–[5] after the float baseline: its accuracy, PTQ, QAT (through
    ``qat_fn``), the export contract, the backend matrix, the artifact
    round trip.  Returns the numbers it prints and ``rc``."""
    out = {}
    acc_f = accuracy(plan(cfg, fparams, "float", device), args.eval_n)
    out["float"] = acc_f
    print(f"\n[1] float32 accuracy:          {acc_f:.3f}")

    # [2] PTQ (the old pipeline's deployment) under the same backend the
    # QAT loss will train through (explicit recipe: PTQ even on backends
    # that don't quantise by default)
    recipe = recipe_for(cfg, fparams, args.bits)
    eng_ptq = plan(cfg, fparams, args.qat_backend, device, recipe=recipe)
    acc_ptq = accuracy(eng_ptq, args.eval_n)
    out["ptq"] = acc_ptq
    print(f"[2] PTQ  {eng_ptq.describe()}")
    print(f"    accuracy:                  {acc_ptq:.3f}")

    # [3] QAT fine-tune: step 0 IS the PTQ model, so the selected export
    # never regresses below PTQ on the selection fold
    distill = make_distill_spec(cfg, args, device) if args.distill else None
    qparams, spec, qstate = qat_fn(cfg, fparams, recipe, args, device,
                                   distill)
    ex = qat.export(qparams, spec, qstate)
    eng_qat = plan(cfg, ex.params, args.qat_backend, device, recipe=ex.recipe)
    acc_qat = accuracy(eng_qat, args.eval_n)
    out["qat"] = acc_qat
    tag = "QAT+KD" if args.distill else "QAT"
    print(f"[3] {tag}  {eng_qat.describe()}")
    print(f"    accuracy:                  {acc_qat:.3f}  "
          f"(PTQ {acc_ptq:.3f}, float {acc_f:.3f})")

    # [4] acceptance: QAT eval path == the exported engine, bit for bit.
    # QAT eval fake-quantises weights but keeps float activations, so the
    # bitwise reference is the NON-executing plan (under lut where the
    # QAT backend is cuda: the kernel plan executes on integers only, and
    # its kernels equal lut's plain versions bit for bit); the default
    # int-exec deployment additionally quantises activations (eq 9) and
    # is checked to its envelope.
    x = torch.cat([b["mfcc"] for b in pipeline.gsc_eval_set(
        0, n=128, input_dim=cfg.input_dim)]).to(device)
    ev = qat.eval_forward(cfg, spec, ex.recipe)(qparams, x)
    ref_backend = "lut" if args.qat_backend == "cuda" else args.qat_backend
    eng_ref = plan(cfg, ex.params, ref_backend, device, recipe=ex.recipe,
                   integer_exec=False)
    out["eval_logits"] = ev
    if not torch.equal(ev, eng_ref.forward(x)):
        print(f"FAIL: QAT eval logits != exported {ref_backend} "
              "engine", file=sys.stderr)
        return {"rc": 1, **out}
    print("[4] export parity: QAT eval logits BIT-IDENTICAL to the "
          f"exported {ref_backend} engine (non-executing plan)")
    if eng_qat.int_exec:
        envelope = float((ev - eng_qat.forward(x)).abs().max())
        out["envelope"] = envelope
        print(f"    int-exec deployment within {envelope:.4f} max-abs of "
              "the QAT eval logits (activation-quant envelope)")

    if args.check_backends:
        out["backends"] = {}
        for b in runtime.available_backends():
            eng = plan(cfg, ex.params, b, device, recipe=ex.recipe)
            acc_b = accuracy(eng, args.eval_n)
            out["backends"][b] = acc_b
            print(f"    backend {b:10s}: accuracy "
                  f"{acc_b:.3f}  ({eng.describe()})")

    if args.export_path:
        qat_export.save(args.export_path, ex)
        print(f"    wrote {args.export_path}.npz / .json "
              f"({ex.quantized_bytes[0]} packed int{args.bits} bytes)")
        # the packed artifact round-trips and deploys with no float
        # detour: loaded QTensor tree -> Engine, logits bit-identical
        lrecipe, lqparams = qat_export.load(args.export_path, ex.qparams,
                                            device=device)
        eng_loaded = plan(cfg, lqparams, args.qat_backend, device,
                          recipe=lrecipe)
        if not torch.equal(eng_loaded.forward(x), eng_qat.forward(x)):
            print("FAIL: reloaded packed artifact != exported engine",
                  file=sys.stderr)
            return {"rc": 1, **out}
        print("    reloaded packed artifact BIT-IDENTICAL to the "
              "exported engine")

    # smoke contract: the selected QAT export must not regress below PTQ
    # (selection fold guarantees >=; allow test-fold sampling noise)
    if acc_qat < acc_ptq - 0.02:
        print(f"FAIL: QAT accuracy {acc_qat:.3f} below PTQ {acc_ptq:.3f}",
              file=sys.stderr)
        return {"rc": 1, **out}
    print("qat demo complete.")
    return {"rc": 0, **out}


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300,
                    help="float baseline training steps")
    ap.add_argument("--qat-steps", type=int, default=None,
                    help="QAT fine-tune steps (default: --steps)")
    ap.add_argument("--distill", action="store_true",
                    help="KD from a float KWT-1 teacher during QAT")
    ap.add_argument("--teacher-steps", type=int, default=200)
    ap.add_argument("--teacher-keep-layers", type=int, default=4,
                    help="surgeon depth-shrink of the teacher (0: keep all)")
    ap.add_argument("--distill-alpha", type=float, default=0.5)
    ap.add_argument("--distill-temp", type=float, default=2.0)
    ap.add_argument("--qat-backend", default="lut")
    ap.add_argument("--bits", type=int, default=8, choices=(4, 8),
                    help="stored weight width: 8 -> int8, 4 -> nibble-"
                         "packed int4 (half the ROM; exponent calibrated "
                         "to the 4-bit no-saturation bound)")
    ap.add_argument("--check-backends", action="store_true",
                    help="run the exported params across the full backend "
                         "matrix (float/lut_float/lut/cuda)")
    ap.add_argument("--eval-n", type=int, default=512)
    ap.add_argument("--export-path", default=None,
                    help="write the int8 artifact + recipe JSON here")
    ap.add_argument("--seed", type=int, default=0)
    add_device_arg(ap)
    return ap


def main(argv=None) -> int:
    args = parser().parse_args(argv)
    device = resolve_device(args.device)
    steps.no_tf32()

    cfg = registry.get("kwt-tiny").config
    n = kwt.count_params(kwt.init_params(cfg, torch.Generator().manual_seed(0),
                                         device))
    print(f"KWT-Tiny QAT: {cfg.n_layers} layer, DIM={cfg.d_model}, "
          f"{n} params")
    fparams = train_float(cfg, args, device)
    return report(cfg, fparams, args, device)["rc"]


if __name__ == "__main__":
    sys.exit(main())
