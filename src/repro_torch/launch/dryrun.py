"""Multi-pod dry run of the port: lower and price every (arch x shape x
mesh) cell on a fake production mesh, against the H100 model.

For each cell this harness:
  1. builds the *deployable* step program (``steps.build_step_program``),
     places it on the production mesh (``launch.mesh.
     make_production_mesh``: (16, 16) or (2, 16, 16) ranks of a fake
     process group, this process rank 0) and walks it on meta tensors
     (``steps.lower_program``) for rank 0's memory analysis -> does the
     port's mesh step fit one H100's 80 GB;
  2. (single pod only) walks the while-free cost-component programs
     (``steps.cost_programs``) and combines  sum_i  mult_i x cost_i  into
     FLOPs / bytes / collective bytes — the reference's scan-aware
     accounting (its DESIGN.md §4);
  3. derives the three roofline terms (compute / memory / collective)
     from the H100 constants and writes everything to
     ``results/dryrun_torch/<cell>.json``.

It is a model of the port's programs, not a translation of the
reference's numbers.  The FLOPs and bytes are ATen charges
(``perf.cost.op_flops`` / ``op_bytes``, before any fusion), where the
reference reads XLA:CPU's HLO counts after fusion; the collectives are
the recorded c10d / functional ops, where the reference parses HLO text.
The memory is rank 0's (``torch.chunk`` gives rank 0 the largest shard of
an uneven dim) under the port's mesh step (``dist.spmd``: every weight
gathered whole once per step, the ``"model"`` axis sharding storage and
the experts) with XLA's accounting: temporaries live from the op that
makes them to their last use, donated arguments alias the outputs
(``peak_bytes_est``, judged by ``fits_hbm``).  The eager port donates
nothing: a step's new parameters, optimizer state or decode state are
made while the old ones are alive, so each record also carries
``peak_no_donation`` (the alias bytes added back), judged by
``fits_hbm_no_donation``.  That is the figure the card's own peak
agrees with (``chip_smoke.py``'s phase ``dryrun`` holds it there).
There is no ``cpu_convert_overhead`` and no ``*_tpu_adjusted`` key: they
correct an XLA:CPU artefact (bf16 products widened to float32 copies)
that a meta-tensor walk does not have.

A whole production step is up to millions of ATen ops (nemotron-4-340b's
train_4k: 16 microbatches x 96 layers; hymba-1.5b's: 4 x 32 layers of
256 scan chunks), so the memory walk of the long cells is cut, and each
record names its ``memory_method``:

* ``"whole"``: the whole step;
* ``"three_microbatches"`` (a train step of more than four
  microbatches): the step at three, every later microbatch adding its
  float32 loss (kept for the mean) — from the second on each repeats the
  last one's liveness, so this bounds the whole walk from above by at
  most 4 bytes a microbatch;
* ``"two_point_layers"`` (a recurrent train or prefill step: rwkv and
  hymba scan 16 tokens a chunk, a walk of ATen ops per chunk): the step
  at 2 and 3 layers, extrapolated linearly.  Memory is affine in the
  layer count where activations set the peak, as in these cells.  Where
  a stacked weight's gradient does it is not (a layer's backward makes a
  ``[L, ...]`` zero-filled gradient, and how many are live at the peak
  varies with L) and it comes low (3 % at smoke size), so no other
  family takes this method; a cut in the
  sequence length fails for the same reason (at short lengths the
  weights set the peak: a third to a half low at full width).

CPU tests hold each cut method against the whole walk at smoke size;
PERF.md gives the full-width checks.

The fake world is set up in :func:`run_cell` / :func:`main`, never at
import (the reference's ``XLA_FLAGS`` line); it takes the process's one
process group, so a caller with a group of its own runs the dry run in a
subprocess.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun [--arch A] [--shape S]
      [--mesh single|multi|both] [--force] [--no-cost] [--list]
      [--results-dir DIR] [--jobs N]

``--jobs N`` walks N cells at once, each in a spawned process with a fake
world of its own (a walk is single-threaded Python).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
import traceback

from repro_torch.configs import registry
from repro_torch.dist import sharding
from repro_torch.launch import mesh as meshlib
from repro_torch.launch import steps

RESULTS_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                           "results", "dryrun_torch")
DEVICE_MODEL = "h100-sxm"


def collective_bytes(lowered) -> dict:
    """Result-shape bytes per collective kind (per rank, per invocation):
    an all-reduce's operand, an all-gather's gathered result, a
    reduce-scatter's shard (``LoweredProgram.collectives``)."""
    return lowered.collectives()


def cost_of(lowered) -> dict:
    ca = lowered.cost_analysis()
    coll = collective_bytes(lowered)
    return {
        "flops": float(ca.get("flops", 0.0)),
        "bytes": float(ca.get("bytes accessed", 0.0)),
        "collective_bytes": float(sum(coll.values())),
        "collectives": coll,
    }


def combine(components: list) -> dict:
    tot = {"flops": 0.0, "bytes": 0.0, "collective_bytes": 0.0}
    detail = []
    for name, mult, c in components:
        for k in tot:
            tot[k] += mult * c[k]
        detail.append({"name": name, "multiplier": mult, **c})
    tot["components"] = detail
    return tot


def _flat_with_path(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flat_with_path(v, path + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _flat_with_path(v, path + (i,))
    else:
        yield path, tree


def model_flops(cfg, shape) -> float:
    """Analytic MODEL_FLOPS: 6*N*D train (N_active for MoE), 2*N*tokens decode."""
    p_sds = steps.params_shape(cfg)
    total = active = 0
    for path, leaf in _flat_with_path(p_sds):
        n = 1
        for d in leaf.shape:
            n *= d
        total += n
        keys = "/".join(str(k) for k in path)
        if cfg.family == "moe" and any(w in keys for w in
                                       ("w_gate", "w_up", "w_down")) \
                and "shared" not in keys and "blocks" in keys:
            active += n * cfg.top_k / cfg.n_experts
        else:
            active += n
    n_eff = active
    tokens = shape.global_batch * (1 if shape.is_decode else shape.seq_len)
    if shape.kind == "train":
        return 6.0 * n_eff * tokens
    return 2.0 * n_eff * tokens


def roofline(cost: dict, n_chips: int) -> dict:
    """The costs are per rank, so the terms divide by one card's rates:
    compute at the bf16 peak, memory at the HBM rate, collectives at the
    NVLink rate (optimistic across nodes: ``perf.roofline``)."""
    compute_s = cost["flops"] / meshlib.PEAK_FLOPS_BF16
    memory_s = cost["bytes"] / meshlib.HBM_BW
    coll_s = cost["collective_bytes"] / meshlib.NVLINK_BW
    dominant = max(("compute", compute_s), ("memory", memory_s),
                   ("collective", coll_s), key=lambda kv: kv[1])[0]
    return {"compute_s": compute_s, "memory_s": memory_s,
            "collective_s": coll_s, "dominant": dominant}


def _walk_memory(cfg, shape, mesh, n_micro=None) -> dict:
    ma = steps.lower_program(
        steps.build_step_program(cfg, shape, mesh, n_micro=n_micro),
        mesh, records=False).memory_analysis()
    return {"argument_bytes": int(ma.argument_size_in_bytes),
            "output_bytes": int(ma.output_size_in_bytes),
            "temp_bytes": int(ma.temp_size_in_bytes),
            "alias_bytes": int(ma.alias_size_in_bytes)}


def _batch_bytes(cfg, shape, mesh) -> int:
    """Bytes of this rank's batch argument of a train step."""
    batch = steps.input_specs(cfg, shape)
    if sharding.is_device_mesh(mesh):
        batch = sharding.local(sharding.place(
            batch, steps.batch_pspec(cfg, shape, steps.dp_for(shape, mesh)),
            mesh))
    return sum(t.numel() * t.element_size() for t in batch.values())


# microbatches walked for a cell of more: each one after the third adds
# its float32 loss, kept for the mean
_MICRO_WALKED = 3
_LOSS_BYTES = 4


# the layer counts a recurrent step is walked at
_LAYER_POINTS = (2, 3)


def memory(cfg, shape, mesh, method: str = "auto") -> tuple:
    """``(memory fields, method)`` of the cell's step on rank 0 (module
    docstring).  ``method="auto"``: a recurrent train or prefill step
    ``two_point_layers``; another train step of more than four
    microbatches ``three_microbatches``; else ``whole``."""
    n_micro = steps.microbatches(cfg, shape, mesh) \
        if shape.kind == "train" else 1
    if method == "auto":
        method = "two_point_layers" if cfg.family in ("rwkv", "hybrid") \
            and shape.kind != "decode" else "whole" \
            if n_micro <= _MICRO_WALKED + 1 else "three_microbatches"
    if method == "whole":
        mem = _walk_memory(cfg, shape, mesh)
    elif method == "two_point_layers":
        lo, hi = _LAYER_POINTS
        m1, m2 = (_walk_memory(cfg.with_(n_layers=n), shape, mesh)
                  for n in (lo, hi))
        mem = {k: m1[k] + (m2[k] - m1[k]) * (cfg.n_layers - lo)
               for k in m1}
    else:
        m = _MICRO_WALKED
        sub = dataclasses.replace(
            shape, global_batch=m * shape.global_batch // n_micro)
        mem = _walk_memory(cfg, sub, mesh, n_micro=m)
        # the walked microbatches' share of the batch argument, scaled up
        mem["argument_bytes"] += (n_micro - m) * _batch_bytes(
            cfg, sub, mesh) // m
        mem["temp_bytes"] += (n_micro - m) * _LOSS_BYTES
    mem["peak_bytes_est"] = (mem["argument_bytes"] + mem["output_bytes"]
                             + mem["temp_bytes"] - mem["alias_bytes"])
    mem["peak_no_donation"] = mem["peak_bytes_est"] + mem["alias_bytes"]
    return mem, method


def run_cell(arch: str, shape, *, mesh_kind: str, force: bool = False,
             with_cost: bool = True,
             results_dir: str = RESULTS_DIR) -> dict:
    entry = registry.get(arch)
    cfg = entry.config
    os.makedirs(results_dir, exist_ok=True)
    fname = os.path.join(
        results_dir, f"{arch}__{shape.name}__{mesh_kind}.json")
    if os.path.exists(fname) and not force:
        with open(fname) as f:
            return json.load(f)

    if shape.name in entry.skips:
        rec = {"arch": arch, "shape": shape.name, "mesh": mesh_kind,
               "skipped": entry.skips[shape.name]}
        with open(fname, "w") as f:
            json.dump(rec, f, indent=1)
        return rec

    meshlib.init_fake_world()
    mesh = meshlib.make_production_mesh(multi_pod=(mesh_kind == "multi"))
    n_chips = mesh.size()
    t0 = time.time()
    mem, method = memory(cfg, shape, mesh)
    rec = {
        "arch": arch, "shape": shape.name, "mesh": mesh_kind,
        "n_chips": int(n_chips), "device_model": DEVICE_MODEL, "rank": 0,
        "memory": mem, "memory_method": method,
        "fits_hbm": mem["peak_bytes_est"] <= meshlib.HBM_BYTES,
        "fits_hbm_no_donation": mem["peak_no_donation"] <= meshlib.HBM_BYTES,
    }

    if with_cost and mesh_kind == "single":
        comps = []
        for cp in steps.cost_programs(cfg, shape, mesh):
            c = cost_of(steps.lower_program(cp, mesh))
            comps.append((cp.name, cp.multiplier, c))
        cost = combine(comps)
        rec["cost"] = cost
        rec["model_flops"] = model_flops(cfg, shape)
        rec["model_to_hlo"] = (rec["model_flops"] / n_chips
                               / max(cost["flops"], 1.0))
        rec["roofline"] = roofline(cost, n_chips)
    rec["lower_s"] = round(time.time() - t0, 2)
    with open(fname, "w") as f:
        json.dump(rec, f, indent=1)
    return rec


def _cell_job(arch, shape_name, mesh_kind, force, with_cost, results_dir):
    """One cell in a worker process of its own (its own fake world)."""
    import torch
    torch.set_num_threads(1)
    entry = registry.get(arch)
    shape = next(s for s in entry.shapes if s.name == shape_name)
    try:
        return run_cell(arch, shape, mesh_kind=mesh_kind, force=force,
                        with_cost=with_cost, results_dir=results_dir), None
    except Exception:
        return None, traceback.format_exc()


def _kind(job) -> str:
    arch, shape_name = job[:2]
    return next(s.kind for s in registry.get(arch).shapes
                if s.name == shape_name)


def _report(label, rec) -> None:
    if "skipped" in rec:
        print("  skipped:", rec["skipped"])
        return
    mem = rec["memory"]
    print("  ok: peak/device = "
          f"{mem['peak_bytes_est']/1e9:.2f} GB donated, "
          f"{mem['peak_no_donation']/1e9:.2f} GB not"
          f" ({rec['memory_method']};"
          f" {'fits' if rec['fits_hbm'] else 'over'} /"
          f" {'fits' if rec['fits_hbm_no_donation'] else 'over'}"
          f" {meshlib.HBM_BYTES/1e9:.0f} GB)"
          + (f", dominant={rec['roofline']['dominant']}"
             if "roofline" in rec else ""), flush=True)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="both",
                    choices=["single", "multi", "both"])
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--no-cost", action="store_true")
    ap.add_argument("--list", action="store_true")
    ap.add_argument("--results-dir", default=RESULTS_DIR)
    ap.add_argument("--jobs", type=int, default=1,
                    help="cells walked at once, each in a process of its "
                         "own (a walk runs on one core)")
    args = ap.parse_args(argv)

    archs = [args.arch] if args.arch else registry.ASSIGNED
    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]
    cells = []
    for arch in archs:
        entry = registry.get(arch)
        for shape in entry.shapes:
            if args.shape and shape.name != args.shape:
                continue
            for mk in meshes:
                label = f"{arch} x {shape.name} x {mk}"
                if args.list:
                    print(label, "(skip)" if shape.name in entry.skips else "")
                    continue
                cells.append((label, (arch, shape.name, mk, args.force,
                                      not args.no_cost,
                                      args.results_dir)))
    if args.list:
        return
    pool = None
    if args.jobs > 1:
        import concurrent.futures
        import multiprocessing
        pool = concurrent.futures.ProcessPoolExecutor(
            args.jobs, mp_context=multiprocessing.get_context("spawn"))
        # the longest walks (train, then prefill) start first
        rank = {"train": 0, "prefill": 1}
        order = sorted(range(len(cells)), key=lambda i: rank.get(
            _kind(cells[i][1]), 2))
        done = {i: pool.submit(_cell_job, *cells[i][1]) for i in order}
        results = (done[i].result() for i in range(len(cells)))
    else:
        results = (_cell_job(*job) for _, job in cells)
    failures = []
    try:
        for (label, _), (rec, err) in zip(cells, results):
            print(f"=== {label} ===", flush=True)
            if err is not None:
                failures.append(label)
                print(err, flush=True)
            else:
                _report(label, rec)
    finally:
        if pool is not None:
            pool.shutdown(cancel_futures=True)
    if failures:
        print("FAILURES:", failures)
        raise SystemExit(1)
    print("dry-run complete.")


if __name__ == "__main__":
    main()
