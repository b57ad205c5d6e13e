#!/usr/bin/env python3
"""GPU smoke run of the PyTorch/CUDA port: ``python3 chip_smoke.py``.

Needs one NVIDIA GPU (built for Hopper, ``sm_90a``) and ``nvcc``; takes no
arguments.  It drives the port's main path — the Keyword Transformer
served offline through ``repro_torch.runtime`` — on the card, and is the
quickest proof that the port still builds and starts there:

1. ``device``          the card, its power limit, TF32 off.
2. ``build``           compiles ``src/repro_torch/csrc/*.cu`` with ``nvcc``
                       into ``build/repro_torch/libkernels.so`` and loads it.
3. ``kernels``         every kernel against its plain PyTorch version on
                       CUDA tensors, ``torch.equal`` (all three are exact
                       by construction), at the main-path shapes of both
                       KWT models for batch 1 / 8 / 64 / 4096 (KWT-1's
                       matmuls also with int4 per-channel weights) and at
                       ragged shapes; times each beside its plain version, one
                       PyTorch library call and its memory/compute bound.
4. ``serve_kwt_tiny``  KWT-Tiny (full width and depth) under the ``cuda``
5. ``serve_kwt_1``     backend, then KWT-1 (12 layers, d 64): request
                       batches through ``Engine.forward``; logits finite,
                       ``torch.equal`` to the ``lut`` backend on the card,
                       close to the same plan on the CPU; the launch
                       counters of the three wrappers rise by exactly the
                       expected numbers.

Any failing phase lets its exception out (non-zero exit); nothing falls
back to the CPU.  Each phase prints one JSON line; the line before the
last is ``{"kernels": [...]}`` with, per kernel, its launches on the main
path, its error against the plain version and its times; the last line is
``{"ok": true, "device": {...}}``.

Timing: CUDA events around a run of back-to-back calls of the wrapper,
median over several runs, after a warm-up; inputs stay resident (the L2
cache is not flushed: on the main path a kernel's input was just written
by the op before it).  At the smallest shapes the figure is the cost of
one launch from Python, not of the arithmetic.

Bounds: the larger of bytes moved (each input read once, each output
written once) over 3.35 TB/s and operations over the peak for their type
(1979 TOP/s int8 for the matmul's multiply-adds, 67 TFLOP/s for the
elementwise float32/int32 work), the published rates of an H100 SXM at
its full 700 W limit.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

from repro_torch import convert, runtime  # noqa: E402
from repro_torch.configs import registry  # noqa: E402
from repro_torch.core import quant  # noqa: E402
from repro_torch.core.tree import tree_map  # noqa: E402
from repro_torch.kernels import build, ops, ref  # noqa: E402
from repro_torch.models import kwt  # noqa: E402

HBM_BYTES_PER_S = 3.35e12
INT8_OPS_PER_S = 1979e12
F32_OPS_PER_S = 67e12
# arithmetic per element, counted from the kernel sources (two passes of
# the exp lookup, the limb multiply, the max and the sum for the softmax)
SOFTMAX_OPS_PER_ELEM = {True: 40, False: 20}      # fixed, float
GELU_OPS_PER_ELEM = {False: 8, True: 14}          # nearest, interp

BATCHES = (1, 8, 64, 4096)
TINY_LUT_ATOL = 2.0 ** -5     # card vs CPU, same plan: one activation LSB
KWT1_LUT_ATOL = 0.5           # 12 layers amplify an LSB flip; see PERF.md
KWT1_MIN_ARGMAX_AGREE = 0.75
CPU_BATCHES = (1, 8)          # batches also answered by the same plan on the CPU


def emit(obj) -> None:
    """One JSON line on standard output; also appended to the file named
    by ``$CHIP_SMOKE_OUT`` when that is set (the lines are long)."""
    line = json.dumps(obj)
    print(line, flush=True)
    path = os.environ.get("CHIP_SMOKE_OUT")
    if path:
        Path(path).parent.mkdir(parents=True, exist_ok=True)
        with open(path, "a") as fh:
            fh.write(line + "\n")


def time_ms(fn, numel_hint: int) -> float:
    """Median milliseconds of one call: events around runs of calls."""
    per_run = 20 if numel_hint < (1 << 22) else 4
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    runs = []
    for _ in range(5):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(per_run):
            fn()
        stop.record()
        stop.synchronize()
        runs.append(start.elapsed_time(stop) / per_run)
    return statistics.median(runs)


def bound(nbytes: int, nops: float, ops_per_s: float):
    by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    by_ops = nops / ops_per_s * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops, "operations")


def max_abs_err(a: torch.Tensor, b: torch.Tensor) -> float:
    if a.numel() == 0:
        return 0.0
    return float((a.to(torch.float64) - b.to(torch.float64)).abs().max())


def require_equal(what: str, got: torch.Tensor, want: torch.Tensor) -> float:
    torch.cuda.synchronize()
    if got.dtype != want.dtype or got.shape != want.shape or \
            not torch.equal(got, want):
        raise AssertionError(
            f"{what}: kernel differs from its plain version "
            f"(max abs err {max_abs_err(got, want)}, dtypes {got.dtype}/"
            f"{want.dtype}, shapes {tuple(got.shape)}/{tuple(want.shape)})")
    return max_abs_err(got, want)


# ---------------------------------------------------------------------------
# phase 1 + 2
# ---------------------------------------------------------------------------

def phase_device() -> dict:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py needs a CUDA device: "
                         "torch.cuda.is_available() is False")
    # Full float32: TF32 in the score product would move logits far beyond
    # every tolerance below, and the exact-integer float32 products of the
    # plain versions need every mantissa bit.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    info = {"phase": "device", "name": torch.cuda.get_device_name(0),
            "capability": list(torch.cuda.get_device_capability(0)),
            "count": torch.cuda.device_count(), "torch": torch.__version__,
            "cuda": torch.version.cuda, "nvidia_smi": smi,
            "allow_tf32": {"matmul": torch.backends.cuda.matmul.allow_tf32,
                           "cudnn": torch.backends.cudnn.allow_tf32}}
    emit(info)
    return info


def phase_build() -> None:
    t0 = time.perf_counter()
    build.load()
    log = build.build_dir() / "build.log"
    used = [ln.strip() for ln in log.read_text().splitlines()
            if "Used" in ln and "registers" in ln] if log.exists() else []
    emit({"phase": "build", "seconds": round(time.perf_counter() - t0, 2),
          "nvcc_seconds": None if build.build_seconds is None
          else round(build.build_seconds, 2),
          "library": str(build.build_dir() / "libkernels.so"),
          "sources": [str(s.relative_to(Path(__file__).resolve().parent))
                      for s in build.sources()],
          "ptxas": used})


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------

def model_shapes(cfg, b: int) -> dict:
    """The shapes the main path hands each kernel for a batch of ``b``."""
    f, t = cfg.input_dim
    s, d, dh, ff = t + 1, cfg.d_model, cfg.resolved_head_dim, cfg.d_ff
    return {"softmax": (b * s, s), "gelu": (b * s, ff),
            "matmul": [("proj", b * t, f, d), ("qkv", b * s, d, dh),
                       ("wo", b * s, dh, d), ("w1", b * s, d, ff),
                       ("w2", b * s, ff, d), ("head", b, d, cfg.n_classes)]}


def check_softmax(dev, gen, m, n, fixed, timed):
    x = torch.randn((m, n), generator=gen, device=dev) * 4.0
    if m > 2 and n > 1:
        x[0] = 0.0                                      # flat row, largest sum
        x[1, 0] = 60.0                                  # one dominant lane
    got, want = ops.lut_softmax(x, fixed=fixed), ref.lut_softmax(x, fixed=fixed)
    row = {"variant": "fixed" if fixed else "float", "shape": [m, n],
           "equal": True, "max_abs_err": require_equal(
               f"lut_softmax fixed={fixed} {m}x{n}", got, want)}
    del got, want
    if timed:
        nbytes = 2 * 4 * m * n + 2 * 4 * 320
        b_ms, by = bound(nbytes, SOFTMAX_OPS_PER_ELEM[fixed] * m * n, F32_OPS_PER_S)
        row.update(bytes=nbytes, bound_ms=b_ms, bound_by=by,
                   ms=time_ms(lambda: ops.lut_softmax(x, fixed=fixed), m * n),
                   plain_ms=time_ms(lambda: ref.lut_softmax(x, fixed=fixed), m * n),
                   library_ms=time_ms(lambda: torch.softmax(x, dim=-1), m * n))
    return row


def check_gelu(dev, gen, shape, interp, dtype, timed):
    x = (torch.randn(shape, generator=gen, device=dev) * 3.0).to(dtype)
    flat = x.reshape(-1)
    edges = torch.tensor([-1.857, 1.595, -1.8570001, 1.5950001, 0.0, -10.0, 10.0],
                         device=dev).to(dtype)
    flat[:min(7, flat.numel())] = edges[:flat.numel()]
    got, want = ops.lut_gelu(x, interp=interp), ref.lut_gelu(x, interp=interp)
    name = str(dtype).split(".")[1]
    row = {"variant": "interp" if interp else "nearest", "dtype": name,
           "shape": list(shape), "equal": True, "max_abs_err": require_equal(
               f"lut_gelu interp={interp} {name} {shape}", got, want)}
    del got, want
    if timed:
        numel = x.numel()
        nbytes = 2 * x.element_size() * numel + 4 * 32
        b_ms, by = bound(nbytes, GELU_OPS_PER_ELEM[interp] * numel, F32_OPS_PER_S)
        row.update(bytes=nbytes, bound_ms=b_ms, bound_by=by,
                   ms=time_ms(lambda: ops.lut_gelu(x, interp=interp), numel),
                   plain_ms=time_ms(lambda: ref.lut_gelu(x, interp=interp), numel),
                   library_ms=time_ms(
                       lambda: torch.nn.functional.gelu(x), numel))
    return row


def _rand_i8(gen, shape, dev, lo=-128, hi=128):
    return torch.randint(lo, hi, shape, generator=gen, device=dev,
                         dtype=torch.int32).to(torch.int8)


def check_matmul(dev, gen, tag, m, k, n, *, bits=8, per_channel=False,
                 residual_bits=16, timed=False):
    """The f32-epilogue mode through the public wrapper, QTensor weight."""
    lo, hi = quant.int_range(bits)
    x = _rand_i8(gen, (m, k), dev)
    grid = _rand_i8(gen, (k, n), dev, lo, hi + 1)
    axis = _rand_i8(gen, (n,), dev, -2, 3) if per_channel else None
    w = quant.QTensor.store(grid, 6, bits=bits, axis_exponents=axis)
    got = ops.int8_matmul(x, w, x_exp=5, residual_bits=residual_bits)
    want = ref.int8_matmul_scaled(x, grid, shift=0, clip16=residual_bits == 16,
                                  out_exp=11, axis_exponents=axis)
    row = {"variant": f"f32 int{bits}" + (" per-channel" if per_channel else "")
           + f" residual{residual_bits}", "tag": tag, "shape_mkn": [m, k, n],
           "equal": True, "max_abs_err": require_equal(
               f"int8_matmul {tag} {(m, k, n)} int{bits} pc={per_channel} "
               f"rb={residual_bits}", got, want)}
    if residual_bits == 16 and k >= 8 and not per_channel:
        row["clip_hit"] = bool((want.abs() >= 32767 * 2.0 ** -11).any())
    del got, want
    if timed:
        nbytes = m * k + k * n + 4 * m * n + (4 * n if per_channel else 0)
        b_ms, by = bound(nbytes, 2.0 * m * k * n, INT8_OPS_PER_S)
        xf, wf = x.to(torch.float32), grid.to(torch.float32)
        row.update(bytes=nbytes, bound_ms=b_ms, bound_by=by,
                   ms=time_ms(lambda: ops.int8_matmul(
                       x, w, x_exp=5, residual_bits=residual_bits), m * max(k, n)),
                   plain_ms=time_ms(lambda: ref.int8_matmul_scaled(
                       x, grid, shift=0, clip16=residual_bits == 16, out_exp=11,
                       axis_exponents=axis), m * max(k, n)),
                   library_ms=time_ms(lambda: torch.matmul(xf, wf), m * max(k, n)))
    return row


def check_matmul_raw(dev, gen, m, k, n, shift, out_int16):
    x, w = _rand_i8(gen, (m, k), dev), _rand_i8(gen, (k, n), dev)
    got = ops.int8_matmul_raw(x, w, shift=shift, out_int16=out_int16)
    want = ref.int8_matmul_raw(x, w, shift=shift, out_int16=out_int16)
    return {"variant": "raw int16" if out_int16 else "raw int32",
            "shape_mkn": [m, k, n], "shift": shift, "equal": True,
            "max_abs_err": require_equal(
                f"int8_matmul_raw {(m, k, n)} shift={shift} i16={out_int16}",
                got, want)}


def phase_kernels(dev, configs) -> dict:
    """Returns, per kernel, its checked-and-timed rows."""
    gen = torch.Generator(device=dev).manual_seed(0)
    rows = {"lut_softmax": [], "lut_gelu": [], "int8_matmul": []}
    for cfg in configs:
        for b in BATCHES:
            sh = model_shapes(cfg, b)
            for fixed in (True, False):
                r = check_softmax(dev, gen, *sh["softmax"], fixed, timed=True)
                rows["lut_softmax"].append({"model": cfg.name, "batch": b, **r})
            for interp in (False, True):
                r = check_gelu(dev, gen, sh["gelu"], interp, torch.float32, True)
                rows["lut_gelu"].append({"model": cfg.name, "batch": b, **r})
            for tag, m, k, n in sh["matmul"]:
                r = check_matmul(dev, gen, tag, m, k, n, timed=True)
                rows["int8_matmul"].append({"model": cfg.name, "batch": b, **r})
                if cfg.n_layers > 1:    # the int4 per-channel plan served below
                    r = check_matmul(dev, gen, tag, m, k, n, bits=4,
                                     per_channel=True, timed=True)
                    rows["int8_matmul"].append(
                        {"model": cfg.name, "batch": b, **r})
    # ragged shapes and the options the main path does not take
    ragged_sm = [(1000, 1000), (7, 1), (1, 1), (5, 4099), (33, 65), (3, 16384)]
    for m, n in ragged_sm:
        for fixed in (True, False):
            rows["lut_softmax"].append(check_softmax(dev, gen, m, n, fixed, False))
    for shape in [(3, 5), (1,), (257, 33), (1000003,)]:
        for interp in (False, True):
            for dtype in (torch.float32, torch.bfloat16):
                rows["lut_gelu"].append(
                    check_gelu(dev, gen, shape, interp, dtype, False))
    for m, k, n in [(33, 17, 5), (257, 256, 35), (1, 1, 1), (64, 300, 129)]:
        for bits, pc in ((8, False), (8, True), (4, False), (4, True)):
            for rb in (16, 32):
                rows["int8_matmul"].append(check_matmul(
                    dev, gen, "ragged", m, k, n, bits=bits, per_channel=pc,
                    residual_bits=rb))
        for shift, i16 in ((0, False), (5, False), (5, True), (0, True),
                           (-3, False), (-9, True)):
            rows["int8_matmul"].append(
                check_matmul_raw(dev, gen, m, k, n, shift, i16))
    emit({"phase": "kernels", "all_equal": True,
          "checks": {k: len(v) for k, v in rows.items()}, "rows": rows})
    return rows


# ---------------------------------------------------------------------------
# phases 4 + 5: the main path
# ---------------------------------------------------------------------------

def seeded_params(cfg, seed: int, dev):
    """Weights from a numpy seed in the port's own tree layout: every
    leaf random (fan-in scaled matrices, small biases, LayerNorm scales
    around 1), so that no bias or scale is hidden by a zero or a one."""
    layout = kwt.init_params(cfg, torch.Generator().manual_seed(seed), dev)
    rng = np.random.default_rng(seed)

    def leaf(t):
        scale = 1.0 / np.sqrt(t.shape[0]) if t.ndim > 1 else 0.1
        return rng.normal(0, scale, tuple(t.shape)).astype(np.float32)

    tree = tree_map(leaf, layout)
    for bp in tree["blocks"]:
        for ln in ("ln1", "ln2"):
            bp[ln]["scale"] = (1.0 + bp[ln]["scale"]).astype(np.float32)
    return tree


class CountOps(TorchDispatchMode):
    """Counts the ATen ops one forward dispatches (kernel launches made
    through ``ctypes`` are not ATen ops and are counted by the wrappers)."""

    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.n += 1
        return func(*args, **(kwargs or {}))


def expected_launches(cfg, forwards: int) -> dict:
    """Per forward: one softmax and one GELU per layer; every linear is a
    matmul launch — patch embed, head, and Q, K, V, wo, w1, w2 per layer
    (Q/K/V go as three launches)."""
    return {"lut_softmax": cfg.n_layers * forwards,
            "lut_gelu": cfg.n_layers * forwards,
            "int8_matmul": (2 + 6 * cfg.n_layers) * forwards}


def phase_serve(name: str, dev, batches, recipes, requests=3) -> dict:
    cfg = registry.get(name).config
    np_tree = seeded_params(cfg, 0, dev)
    rng = np.random.default_rng(1)
    out = {"phase": f"serve_{cfg.name.replace('-', '_')}", "model": cfg.name,
           "n_layers": cfg.n_layers, "d_model": cfg.d_model, "plans": []}
    for label, recipe_kw in recipes:
        params = convert.from_numpy_tree(np_tree, dev)
        recipe = None if recipe_kw is None else \
            runtime.QuantRecipe.from_config(cfg, **recipe_kw)
        eng = runtime.compile_model(cfg, params, backend="cuda",
                                    recipe=recipe, device=dev)
        plain = runtime.compile_model(cfg, params, backend="lut",
                                      recipe=recipe, device=dev)
        on_cpu = runtime.compile_model(
            cfg, convert.from_numpy_tree(np_tree, "cpu"), backend="lut",
            recipe=recipe, device="cpu")
        plan = {"recipe": label, "describe": eng.describe(),
                "rom_bytes": eng.rom_bytes, "lut_bytes": eng.lut_bytes,
                "param_bytes": eng.param_bytes, "batches": []}
        with CountOps() as counter:
            eng.forward(np.zeros((1, *cfg.input_dim), np.float32))
        plan["aten_ops_per_forward"] = counter.n
        for b in batches:
            before = ops.launch_counts()
            lat, logits = [], None
            for _ in range(requests):
                mfcc = rng.normal(0, 0.5, (b, *cfg.input_dim)).astype(np.float32)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                logits = eng.forward(mfcc)
                torch.cuda.synchronize()
                lat.append((time.perf_counter() - t0) * 1e3)
                if tuple(logits.shape) != (b, cfg.n_classes) or \
                        not bool(torch.isfinite(logits).all()):
                    raise AssertionError(f"{cfg.name} B={b}: bad logits")
                want = plain.forward(mfcc)
                if not torch.equal(logits, want):
                    raise AssertionError(
                        f"{cfg.name} {label} B={b}: cuda plan differs from the "
                        f"lut plan on the card by {max_abs_err(logits, want)}; "
                        "with the kernel phase passing, a wrapper hands its "
                        "kernel other operands than the plain path gets")
            after = ops.launch_counts()
            rose = {k: after[k] - before[k] for k in after}
            want_rise = expected_launches(cfg, requests)
            if rose != want_rise:
                raise AssertionError(f"{cfg.name} B={b}: launch counters rose "
                                     f"by {rose}, expected {want_rise}")
            entry = {"batch": b, "requests": requests,
                     "p50_ms": statistics.median(lat), "launches": rose}
            if b in CPU_BATCHES:
                ref_logits = on_cpu.forward(mfcc)
                diff = (logits.cpu() - ref_logits).abs()
                agree = float((logits.cpu().argmax(-1)
                               == ref_logits.argmax(-1)).float().mean())
                entry.update(vs_cpu_max_abs=float(diff.max()),
                             vs_cpu_argmax_agree=agree)
                tol = TINY_LUT_ATOL if cfg.n_layers == 1 else KWT1_LUT_ATOL
                if float(diff.max()) > tol or (
                        cfg.n_layers > 1 and agree < KWT1_MIN_ARGMAX_AGREE):
                    raise AssertionError(
                        f"{cfg.name} {label} B={b}: card vs CPU lut plan "
                        f"max abs {float(diff.max())} (tolerance {tol}), "
                        f"argmax agreement {agree}")
            plan["batches"].append(entry)
        out["plans"].append(plan)
    emit(out)
    return out


# ---------------------------------------------------------------------------
# the contract line
# ---------------------------------------------------------------------------

SOURCES = {
    "lut_softmax": ("src/repro_torch/csrc/lut_softmax.cu",
                    "src/repro/kernels/lut_softmax.py:76"),
    "lut_gelu": ("src/repro_torch/csrc/lut_gelu.cu",
                 "src/repro/kernels/lut_gelu.py:49"),
    "int8_matmul": ("src/repro_torch/csrc/int8_matmul.cu",
                    "src/repro/kernels/int8_matmul.py:53"),
}
TIMED_KEYS = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "bytes")


def _variants(rows: list, model: str, batch: int, tag) -> list:
    out = {}
    for r in rows:
        v = out.setdefault(r["variant"], {"variant": r["variant"], "equal": True,
                                          "shapes_checked": 0, "max_abs_err": 0.0})
        v["shapes_checked"] += 1
        v["max_abs_err"] = max(v["max_abs_err"], r["max_abs_err"])
        if "ms" in r and r.get("model") == model and r.get("batch") == batch \
                and r.get("tag") == tag:
            v.update({k: r[k] for k in TIMED_KEYS})
    return list(out.values())


def kernels_line(rows: dict, launches: dict, headline_model: str,
                 headline_batch: int) -> dict:
    """One entry per kernel.  The headline numbers are those of the
    variant the main path runs (Q8.24 softmax, nearest GELU, the float32
    epilogue at the MLP's first linear) at ``headline_model`` /
    ``headline_batch``; ``variants`` sums up every checked variant (all
    shapes, ragged ones included) with its own headline times where it
    was timed.  The ``kernels`` phase line above holds every row."""
    main_variant = {"lut_softmax": lambda r: r["variant"] == "fixed",
                    "lut_gelu": lambda r: r["variant"] == "nearest",
                    "int8_matmul": lambda r: r.get("tag") == "w1"}
    entries = []
    for name, (source, replaces) in SOURCES.items():
        head = next(r for r in rows[name]
                    if r.get("model") == headline_model
                    and r.get("batch") == headline_batch
                    and main_variant[name](r))
        if launches[name] <= 0:
            raise AssertionError(f"the main path launched {name} no time")
        entries.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": max(r["max_abs_err"] for r in rows[name]),
            "ms": head["ms"], "plain_ms": head["plain_ms"],
            "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
            "library_ms": head["library_ms"],
            "shape": head.get("shape", head.get("shape_mkn")),
            "model": headline_model, "batch": headline_batch, "equal": True,
            "variants": _variants(rows[name], headline_model, headline_batch,
                                  head.get("tag"))})
    return {"kernels": entries}


def main() -> None:
    info = phase_device()
    dev = torch.device("cuda")
    phase_build()
    tiny, kwt1 = registry.get("kwt-tiny").config, registry.get("kwt-1").config
    rows = phase_kernels(dev, (tiny, kwt1))

    # The main path.  Every count goes to 0 just before it and is read just
    # after it: launches made above to compare kernels do not count.
    ops.reset_launch_counts()
    phase_serve("kwt-tiny", dev, (1, 8, 64, 4096),
                [("int8 (Table V)", None)], requests=5)
    phase_serve("kwt-1", dev, (1, 64),
                [("int8 (Table V defaults)", None),
                 ("int4 per-channel", dict(bits=4, weight_exponent=4,
                                           per_channel=True))])
    launches = ops.launch_counts()

    emit(kernels_line(rows, launches, "kwt-1", 64))
    print(info["nvidia_smi"], flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
