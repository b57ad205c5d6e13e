"""Dtype-residency lint: prove (or refute) ``Backend.int_resident``.

The Engine claims its lut/cuda plans keep quantised weights in stored
integer form.  This pass checks the claim on the recorded program instead
of by example: it runs the plan's programs under the dataflow recorder
(:func:`repro_torch.analysis.op_walk.walk`), propagates a taint set from
the integer weight-storage tensors (the packed QTensor payloads and their
per-channel exponents) through every recorded op and kernel charge, and
reports every int->float conversion of a tainted integer: an explicit one
(``_to_copy`` / ``copy_`` to a float dtype) or one by type promotion (an
element-wise op with a tainted integer operand and a float result; an
index operand of a gather converts nothing).

A run records the branch its example input takes; the model code
branches on configuration and shapes, not on data, so the recorded
program is the plan's program.

Two programs are analysed per integer-resident plan:

  * the **unpack stage** (``Engine.live_params``'s
    ``quant.dequantize_tree``) — the separate stage a non-executing
    resident Engine runs per call.  Every int->float cast here is the
    "hidden unpack" leak: the weights are integer-*resident* but the
    model still consumes a float view.  These are whitelisted with a
    report line and counted as ``float_leak_count``.  Integer-EXECUTING
    plans (``engine.int_exec``) have no unpack stage at all, so the count
    is zero by construction.

  * the **in-module resident program** (the model forward run directly on
    the packed tree — the path integer-executing plans take; for KWT also
    ``embed_frames`` and ``encode_window``, the streaming programs).
    Sanctioned casts are classified by their call stack (function names
    qualified, as ``op_walk`` records them):

      - frames through ``quant.resident_values`` — the po2 weight
        de-scale epilogue (exact); whitelisted.
      - frames through ``quant.int_container`` — value-preserving
        int->f32 container move for exact integer GEMM; whitelisted.
      - frames through ``quant.requant`` / ``kernels.ops.int8_matmul`` —
        the per-channel po2 requant epilogue on an integer accumulator;
        whitelisted.
      - frames through ``quant.gather_descale`` — row-wise embedding
        descale (only looked-up rows leave integer form); whitelisted.
      - frames through ``fixedpoint.to_float`` — the Q8.24 pipeline's exit
        boundary (ALU_TO_FLOAT); whitelisted.

    Anything else tainted that converts an integer to a float is a
    **violation**: an unsanctioned dequantisation snuck into the plan.

On the card a kernel is launched by ``ctypes`` and its ops are not seen;
its charge carries its operands' and results' identities, so taint flows
through it (the int8 matmul's float result is tainted, and so is all that
follows), and a ``cuda`` plan records the same on either device.

**Strict mode** (``check_residency(..., strict=True)``, CLI
``--strict``) asserts the FULL-integer claim: the plan must be
integer-executing, ``float_leak_count`` must be zero, and whole-tensor
weight descales feeding float einsums (``quant.qt_einsum``'s float view)
are violations even though plain resident mode sanctions them.
"""

from __future__ import annotations

import torch

from repro_torch.analysis import op_walk as ow
from repro_torch.analysis.report import Finding, PassResult

# Frame names that sanction an int->float cast (first match reports which
# rule fired).
_WHITELIST = (
    ("resident_values", "weight-descale",
     "po2 de-scale epilogue (exact)"),
    ("int_container", "int-container",
     "value-preserving int->f32 container move (exact integer GEMM)"),
    ("int8_matmul", "requant-epilogue",
     "per-channel po2 requant of the kernel's integer accumulator"),
    ("requant", "requant-epilogue",
     "per-channel po2 requant of the integer accumulator"),
    ("gather_descale", "gather-descale",
     "row-wise embedding descale (looked-up rows only)"),
    ("to_float", "q824-boundary",
     "Q8.24 pipeline exit (ALU_TO_FLOAT reference)"),
)

# ops whose integer operands are indices, shapes or nothing: no value
# of theirs reaches a float result
_NO_VALUE = frozenset((
    "index", "index_select", "gather", "take", "take_along_dim",
    "embedding", "index_put", "index_put_", "_index_put_impl_", "scatter",
    "scatter_", "scatter_add", "scatter_add_", "empty_like", "zeros_like",
    "ones_like", "full_like", "new_empty", "new_zeros", "new_ones",
    "new_full"))


def _is_int(dtype) -> bool:
    return dtype != torch.bool and not (dtype.is_floating_point
                                        or dtype.is_complex)


def int_leaves(tree) -> list:
    """The integer storage tensors of a parameter tree: every QTensor's
    payload and per-channel exponents, and any integer tensor leaf."""
    return [t for t in param_tensors(tree) if _is_int(t.dtype)]


def param_tensors(tree) -> list:
    """Every tensor a parameter tree holds (QTensor fields included)."""
    from repro_torch.core import quant
    from repro_torch.core.tree import tree_leaves
    out = []
    for leaf in tree_leaves(tree):
        if isinstance(leaf, quant.QTensor):
            out.append(leaf.values)
            if leaf.axis_exponents is not None:
                out.append(leaf.axis_exponents)
        elif isinstance(leaf, torch.Tensor):
            out.append(leaf)
    return out


def tainted_float_casts(w: ow.Walk, seeds) -> list:
    """Walk ``w``'s records propagating taint from the identities
    ``seeds``; return ``(record, integer operand meta)`` for every int->float
    conversion of a tainted integer."""
    tainted = set(seeds)
    hits = []
    for rec in w.records:
        flags = [i in tainted for i in rec.in_ids]
        if not any(flags):
            continue
        tainted.update(rec.out_ids)
        if rec.charge is not None or not rec.outputs:
            continue
        if not rec.outputs[0].dtype.is_floating_point:
            continue
        if rec.name in _NO_VALUE:
            continue
        for flag, meta in zip(flags, rec.inputs):
            if flag and _is_int(meta.dtype):
                hits.append((rec, meta))
                break
    return hits


def _classify(rec):
    fns = ow.frame_functions(rec)
    for fn, kind, why in _WHITELIST:
        if fn in fns:
            return kind, why
    return None, None


def collect(fn, params, *args) -> list:
    """The tainted int->float casts of ``fn(params, *args)``, taint seeded
    at ``params``' integer storage."""
    w = ow.walk(fn, params, *args)
    seeds = [w.ident(t) for t in int_leaves(params)]
    return tainted_float_casts(w, [s for s in seeds if s is not None])


def _dtype(d) -> str:
    return str(d).replace("torch.", "")


def check_residency(engine, x, strict: bool = False) -> PassResult:
    """Residency lint over the plan's forward program(s) at input ``x``.

    ``strict=True`` asserts the full-integer claim (see module
    docstring): non-executing plans and whole-tensor float weight views
    become violations, and ``float_leak_count`` must be zero."""
    from repro_torch.core import quant

    findings = []
    metrics = {"float_leak_count": 0, "descale_sites": 0}
    claims = engine.backend.int_resident
    holds = engine.int_resident
    if claims and not holds:
        findings.append(Finding(
            "warning", "residency-claim",
            f"backend {engine.backend_name!r} registers int_resident but the "
            "deployed tree holds no stored-integer leaves (family "
            f"{engine.exec_cfg.family!r} falls back to dequantise-first)"))
    if strict and not engine.int_exec:
        findings.append(Finding(
            "violation", "strict-mode",
            f"strict residency demands an integer-executing plan; "
            f"backend {engine.backend_name!r} planned "
            f"{'resident (dequantise-per-call)' if holds else 'float'} "
            "execution"))
    if not holds:
        findings.append(Finding(
            "info", "residency-claim",
            "plan deploys a float tree; no integer storage to leak"))
        return PassResult("residency", findings, metrics)

    if engine.int_exec:
        findings.append(Finding(
            "info", "unpack-stage",
            "no unpack stage: the plan is integer-executing (the model "
            "consumes the packed tree directly)"))
    else:
        # (a) the separate unpack stage the Engine executes per call
        unpack_hits = collect(lambda p: quant.dequantize_tree(p),
                              engine.params)
        metrics["float_leak_count"] = len(unpack_hits)
        findings.append(Finding(
            "whitelisted", "unpack-stage",
            f"{len(unpack_hits)} int->float cast(s) in the separate unpack "
            "stage (Engine.live_params): the plan is integer-RESIDENT but "
            "not integer-EXECUTING — the per-call float materialisation "
            "the int-exec plan flavour eliminates"))

    # (b) the in-module resident program: forward on the packed tree
    cfg = engine.exec_cfg
    mod = engine._mod
    dev = engine.device
    programs = [("forward", lambda p, xx: mod.forward(p, xx, cfg), x)]
    if cfg.family == "kwt":
        t = cfg.input_dim[1]
        frames = torch.zeros((x.shape[0], t, cfg.input_dim[0]), device=dev)
        window = torch.zeros((x.shape[0], t, cfg.d_model), device=dev)
        programs += [
            ("embed_frames", lambda p, fr: mod.embed_frames(p, fr, cfg),
             frames),
            ("encode_window", lambda p, wd: mod.encode_window(p, wd, cfg),
             window),
        ]
    for prog_name, fn, arg in programs:
        for rec, src in collect(fn, engine.params, arg):
            kind, why = _classify(rec)
            if (strict and kind == "weight-descale"
                    and "qt_einsum" in ow.frame_functions(rec)):
                # a whole-tensor descale feeding a float einsum: the
                # qt_einsum path.  Plain resident mode sanctions it; under
                # the full-integer claim it is a leak.
                kind = None
            desc = (f"{prog_name}: {_dtype(src.dtype)}{list(src.shape)} -> "
                    f"{_dtype(rec.outputs[0].dtype)} ({rec.name})")
            site = ow.user_site(rec)
            if kind == "weight-descale":
                metrics["descale_sites"] += 1
                findings.append(Finding("whitelisted", kind,
                                        f"{desc} — {why}", site))
            elif kind is not None:
                findings.append(Finding("whitelisted", kind,
                                        f"{desc} — {why}", site))
            else:
                findings.append(Finding(
                    "violation", "float-leak",
                    f"{desc}: unsanctioned dequantisation reachable from "
                    "packed weight storage", site))
    return PassResult("residency", findings, metrics)
