#!/usr/bin/env python3
"""GPU smoke run of the PyTorch/CUDA port: ``python3 chip_smoke.py``.

Needs one NVIDIA GPU (built for Hopper, ``sm_90a``) and ``nvcc``; takes no
arguments.  It drives the port's main paths — the Keyword Transformer
served offline through ``repro_torch.runtime``, streamed hop by hop, and
trained with quantisation-aware training — on the card, and is the
quickest proof that the port still builds and starts there:

1. ``device``          the card, its power limit, TF32 off.
2. ``build``           compiles ``src/repro_torch/csrc/*.cu`` with ``nvcc``
                       into ``build/repro_torch/libkernels.so`` and loads it.
3. ``kernels``         every kernel against its plain PyTorch version on
                       CUDA tensors, ``torch.equal`` (the softmax, GELU
                       and matmul are exact by construction), at the
                       main-path shapes of both
                       KWT models for batch 1 / 8 / 64 / 4096 (KWT-1's
                       matmuls also with int4 per-channel weights), at
                       ragged shapes and at the edges of the softmax's slab
                       path and the GELU's 16-byte vectors (short and
                       ragged slabs, rows packed several to a warp, the
                       slab limit, misaligned views, lengths off the vector
                       width); times each beside its plain version, one
                       PyTorch library call and its memory/compute bound.
   The matmul takes the float activation (quantised by eq 9 in the
   kernel; the input of the cuda plans) and the int8 one, int8 and
   nibble-packed int4 weights (unpacked in the kernel), per-column
   exponents over -8..8, activations on exact .5 ties and beyond the clip
   edges, int4 payloads of odd K * N; beside its time ``torch._int_mm``
   (the same int8 product; where it refuses a shape, its error) and f32
   ``torch.matmul``, the faster of them as ``library_ms``.
   ``lut_attention`` cannot be ``torch.equal``: the kernel's own order of
   the dot over D moves an occasional score across a 1/32 LUT bin.  In
   its LUT mode it is held to its plain version (``ref.lut_attention``,
   one softmax over all keys) at the reference's 0.05, and to the same
   online softmax over the same key tiles (``ref.lut_attention_tiled``)
   at a tight bound measured on the card (``ATTN_TIGHT_*`` below), which
   only rescaling at the reference's tile edges meets; in its exact mode
   to both at 2e-5 (at the KWT shapes, where some rows spread wider than
   the kernel's clip of ``m - s`` at 10, to the tiled version, which has
   the clip).  At the KWT shapes, the reference's
   sweep shapes (causal and not, several key tiles included), ragged
   shapes and key tiles of 8, 27 and 99 keys against depths of 8, 64 and
   72, each also on strided views in the layer's ``[B, L, H, D]`` layout
   (the output laid out so that the layer's reshape is a view); bf16 must
   come out finite.  Its row carries the bytes bound beside the float32
   operations bound.
4. ``serve_kwt_tiny``  KWT-Tiny (full width and depth) under the ``cuda``
5. ``serve_kwt_1``     backend, then KWT-1 (12 layers, d 64): request
                       batches through ``Engine.forward``, under
                       ``attention="xla"`` (logits ``torch.equal`` to the
                       ``lut`` backend on the card) and ``"flash_lut"``
                       (logits within ``FLASH_*`` of ``lut`` +
                       ``flash_lut`` on the card); close to the same plan
                       on the CPU; the launch counters of the four
                       wrappers rise by exactly the expected numbers;
                       each plan's line holds its launches and its ATen
                       ops per forward.
6. ``stream_kwt_tiny`` the always-on stream through ``Engine.stream_step``
7. ``stream_kwt_1``    under ``cuda`` + ``xla`` and ``cuda`` + ``flash_lut``:
                       numpy-seeded audio for 64 lanes in chunks of 1, 2
                       and 5 hops; on every hop once a lane is warm the
                       logits are ``torch.equal`` to ``Engine.forward`` of
                       the feature ring's window; counters rise per hop as
                       per forward; one lane is reset mid-stream and
                       re-warms; p50 ms per hop and the real-time factor.

   The stream phases also hold the streaming MFCC frames ``torch.equal`` to
   the offline frames of the same audio: the frontend runs its FFT and both
   products on blocks of a fixed shape on the card (``stream.features``), so a
   frame's features do not depend on how many frames share the call.
8. ``cell_kwt_tiny``   the always-on server through its launcher,
                       ``repro_torch.launch.stream_serve.main``, under
                       ``--backend cuda``: 24 seeded event streams on 8
                       slots, the degrade stage on, tracing on (the lanes go
                       through ``Engine.stream_step`` and its spans); the
                       Chrome trace and the ``.prom`` / ``.metrics.json``
                       exports pass ``repro_torch.telemetry.check``; the hop
                       ledger is exact (``cell_hops_total`` = the offered
                       hops); the ``serve_done`` line's fields are printed.
9. ``cell_kwt_1``      KWT-1 at full width and depth in a ``ServeCell`` of
                       64 slots of seeded event streams, under ``cuda`` +
                       ``xla`` and ``cuda`` + ``flash_lut``: joint,
                       pipelined (featurise on a side CUDA stream, encode on
                       the current one) and feature-ingest lanes on the same
                       chunks give events and scores ``np.array_equal``; a
                       packed artifact published mid-stream to the watch
                       directory is installed by ``maybe_swap`` (generation
                       + 1, exact hop ledger); one lane evicted and
                       re-joined comes back zeroed; a corrupted artifact
                       raises ``SwapRejected``, raises ``swap_failures`` by
                       one, leaves the old engine serving and makes the
                       flight recorder write one ``swap_failure`` dump;
                       ``compile_model(taps=True)`` serves logits
                       ``torch.equal`` to the untapped plan, every tap
                       finite; p50 ms per hop and the real-time factor of the
                       joint and the pipelined lanes; 20 more joint and
                       pipelined hops under ``torch.profiler`` (the card's
                       busy share; their launches count as lane hops).
10. ``train_kwt_tiny`` quantisation-aware training through the launcher,
                       ``repro_torch.launch.train.main``, under
                       ``--qat-backend cuda`` (the LUT softmax and GELU
                       kernels in every training forward, behind their
                       straight-through estimators) with the KWT-1 teacher:
                       a run that fails at step 35, its rerun, which must
                       resume from step 30 (the newest step complete in
                       every tree), and an uninterrupted run of the same
                       seed, whose params must be ``torch.equal``; the loss
                       falls; the export's QAT eval is ``torch.equal`` to
                       the non-executing ``lut`` engine, the ``cuda`` plan
                       within 0.35 of it, and the artifact read back from
                       disk deploys bit-identically on that plan.
11. ``train_kwt_1``    KWT-1 (12 layers, 40x98, 35 classes) trained the same
                       way for 10 steps.
   In both: the STE Functions at the step's own shapes (forward
   ``torch.equal`` to the plain version, input gradient ``torch.equal`` to
   ``torch.autograd.grad`` of the exact op, one launch in the forward and
   none in the backward); one QAT step under ``cuda`` and one under ``lut``
   from the same params and batch (loss, gradients, new params and moments
   ``torch.equal``); p50 ms per QAT step and ATen ops per step, the
   student alone and (KWT-Tiny) with the teacher.

The serve phases (4, 5), the stream phases (6, 7), the cell phases (8, 9)
and the train phases (10, 11) are the main paths: the counters go to 0
just before each group and are read just after it; the launches of the
stream phases' check forwards, of the cell phase's checks (hot-swap's warm
and probe forwards, the refused artifact's, the taps plan's) and of the
train phases' checks are taken out of their paths' counts, which must then
equal what the steps, hops and runs launched.  Every path's
count must equal what that path is expected to launch (the train path
launches the softmax and the GELU ``n_layers`` times a step and neither
the matmul nor the attention), and every kernel must be launched by some
path.  Any failing phase lets its exception out (non-zero exit); nothing
falls back to the CPU.  Each phase prints one JSON line; the line before
the last is ``{"kernels": [...]}`` with, per kernel, its launches on the
main paths, its error against the plain version and its times; the last
line is ``{"ok": true, "device": {...}}``.

Timing, two figures per call: ``ms``, CUDA events around a run of
back-to-back calls of the wrapper (at the smallest shapes the cost of one
call from Python, not of the arithmetic), and ``device_ms``, the same run
of calls captured once in a CUDA graph and its replays timed with events
(the device's time alone; the capture calls the wrappers, so the launch
counters rise then, before they are reset for the main paths, and not at
replay).  The library call gets both (``library_ms``,
``library_device_ms``).  Median over several runs, after a warm-up;
inputs stay resident (the L2 cache is not flushed: on the main path a
kernel's input was just written by the op before it).

Bounds: the larger of bytes moved (each input read once, each output
written once) over 3.35 TB/s and operations over the peak for their type
(1979 TOP/s int8 for the matmul's multiply-adds, 67 TFLOP/s for the
elementwise float32/int32 work and the attention's float32 products,
4 * B * H * Lq * Lk * D), the published rates of an H100 SXM at its full
700 W limit.
"""

from __future__ import annotations

import contextlib
import dataclasses
import importlib
import io
import json
import os
import statistics
import tempfile
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

from repro_torch import cell as cellmod  # noqa: E402
from repro_torch import convert, qat, runtime, telemetry  # noqa: E402
from repro_torch.checkpoint import manager as ckpt_manager  # noqa: E402
from repro_torch.configs import registry  # noqa: E402
from repro_torch.configs.base import ShapeSpec  # noqa: E402
from repro_torch.core import approx, quant  # noqa: E402
from repro_torch.core.tree import tree_leaves, tree_map  # noqa: E402
from repro_torch.data import pipeline  # noqa: E402
from repro_torch.kernels import build, ops, ref  # noqa: E402
from repro_torch.launch import steps  # noqa: E402
from repro_torch.launch import stream_serve  # noqa: E402
from repro_torch.launch import train  # noqa: E402
from repro_torch.models import kwt  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.qat import train as qat_train  # noqa: E402
from repro_torch.stream import detector  # noqa: E402
from repro_torch.stream import engine as stream  # noqa: E402
from repro_torch.stream import features  # noqa: E402
from repro_torch.telemetry import check as telemetry_check  # noqa: E402

qat_export = importlib.import_module("repro_torch.qat.export")

HBM_BYTES_PER_S = 3.35e12
INT8_OPS_PER_S = 1979e12
F32_OPS_PER_S = 67e12
# arithmetic per element, counted from the first kernel sources (two
# passes of the exp lookup, the limb multiply, the max and the sum for the
# softmax); the slab softmax looks each exp up once, but the count is kept
# so that every bound stays comparable with the earlier ones
SOFTMAX_OPS_PER_ELEM = {True: 40, False: 20}      # fixed, float
GELU_OPS_PER_ELEM = {False: 8, True: 14}          # nearest, interp

BATCHES = (1, 8, 64, 4096)
TINY_LUT_ATOL = 2.0 ** -5     # card vs CPU, same plan: one activation LSB
KWT1_LUT_ATOL = 0.5           # 12 layers amplify an LSB flip; see PERF.md
KWT1_MIN_ARGMAX_AGREE = 0.75
CPU_BATCHES = (1, 8)          # batches also answered by the same plan on the CPU

# lut_attention against the online softmax over the same key tiles
# (ref.lut_attention_tiled) and, LUT mode, its plain version
ATTN_EXACT_TOL = 2e-5         # rtol and atol, exact mode (the reference's)
ATTN_LUT_ATOL = 0.05          # LUT mode against the plain version: the
                              # reference's own bound
# LUT mode against the tiled version, tight: within
# 1.2e-6 but where a score lands on a 1/32 bin edge, which moves its row
# by up to a few 1e-4 (measured on the card at the KWT shapes, PERF.md:
# 4.9e-4, one row of 99 at KWT-1 B = 1, 99.0 % of elements within 1e-5).  Rescaling
# at other key-tile edges than the reference's leaves about half of the
# elements outside 1e-5 (tests/test_torch_attention.py), so these terms
# hold the kernel to the reference's edges where the keys are several tiles.
ATTN_TIGHT_ATOL = 0.01
ATTN_TIGHT_MIN_SHARE = 0.98   # share of elements within 1e-5
# cuda + flash_lut logits against lut + flash_lut (kernel vs plain
# attention, then the same integer pipeline), card and CPU alike; measured
# (PERF.md): KWT-Tiny 0.0 at every batch, KWT-1 0.0 at B = 1 and 0.1455
# at B = 64 (argmax agreement 0.969, 2 of 64 rows) — an attention output
# moved one activation LSB and 11 layers amplified it.  KWT-1's limits are
# about twice the measured distance, and 4 of 64 rows.
FLASH_TINY_ATOL = 2.0 ** -5   # one activation LSB
FLASH_KWT1_ATOL = 0.3
FLASH_KWT1_MIN_ARGMAX_AGREE = 0.9


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


def device_ms(fn, numel_hint: int) -> float:
    """Median milliseconds of one call on the device alone: a run of calls
    captured in a CUDA graph, the replays timed with events.  The wrappers
    launch on the current stream, which under capture is the capturing
    one."""
    per_run = 20 if numel_hint < (1 << 22) else 4
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(per_run):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    runs = []
    for _ in range(5):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        stop.record()
        stop.synchronize()
        runs.append(start.elapsed_time(stop) / per_run)
    graph.reset()
    return statistics.median(runs)


def timings(fn, plain, library, numel_hint: int) -> dict:
    """The wrapper's, the plain version's and the library call's times."""
    return {"ms": time_ms(fn, numel_hint),
            "device_ms": device_ms(fn, numel_hint),
            "plain_ms": time_ms(plain, numel_hint),
            "library_ms": time_ms(library, numel_hint),
            "library_device_ms": device_ms(library, numel_hint)}


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
    h, kv = cfg.n_heads, cfg.n_kv_heads
    return {"softmax": (b * s, s), "gelu": (b * s, ff),
            "attention": (b, h, kv, s, s, dh),
            "matmul": [("proj", b * t, f, d), ("qkv", b * s, d, dh),
                       ("wo", b * s, dh, d), ("w1", b * s, d, ff),
                       ("w2", b * s, ff, d), ("head", b, d, cfg.n_classes)]}


def check_softmax(dev, gen, m, n, fixed, timed, offset=0):
    """``offset`` > 0: ``x`` is a contiguous view that starts ``offset``
    floats into a buffer, so not on a 16-byte boundary."""
    buf = torch.randn((m * n + offset,), generator=gen, device=dev) * 4.0
    x = buf[offset:].view(m, n)
    if offset and x.data_ptr() % 16 == 0:
        raise AssertionError(f"offset {offset}: the view is 16-byte aligned")
    if m > 2 and n > 1:
        x[0] = 0.0                                      # flat row, largest sum
        x[1, 0] = 60.0                                  # one dominant lane
    got, want = ops.lut_softmax(x, fixed=fixed), ref.lut_softmax(x, fixed=fixed)
    row = {"variant": "fixed" if fixed else "float", "shape": [m, n],
           "slab_rows": slab_rows(n, x.data_ptr() % 16 == 0),
           "equal": True, "max_abs_err": require_equal(
               f"lut_softmax fixed={fixed} {m}x{n} offset {offset}", got, want)}
    if offset:
        row["offset"] = offset
    del got, want
    if timed:
        nbytes = 2 * 4 * m * n + 2 * 4 * 320
        b_ms, by = bound(nbytes, SOFTMAX_OPS_PER_ELEM[fixed] * m * n, F32_OPS_PER_S)
        row.update(bytes=nbytes, bound_ms=b_ms, bound_by=by, **timings(
            lambda: ops.lut_softmax(x, fixed=fixed),
            lambda: ref.lut_softmax(x, fixed=fixed),
            lambda: torch.softmax(x, dim=-1), m * n))
    return row


def check_gelu(dev, gen, shape, interp, dtype, timed, offset=0):
    """``offset`` > 0: ``x`` is a contiguous view that starts ``offset``
    elements into a buffer, so not on a 16-byte boundary."""
    numel = int(np.prod(shape))
    buf = (torch.randn((numel + offset,), generator=gen, device=dev) * 3.0).to(dtype)
    x = buf[offset:].view(shape)
    if offset and x.data_ptr() % 16 == 0:
        raise AssertionError(f"offset {offset}: the view is 16-byte aligned")
    flat = x.reshape(-1)
    edges = torch.tensor([-1.857, 1.595, -1.8570001, 1.5950001, 0.0, -10.0, 10.0],
                         device=dev).to(dtype)
    flat[:min(7, flat.numel())] = edges[:flat.numel()]
    got, want = ops.lut_gelu(x, interp=interp), ref.lut_gelu(x, interp=interp)
    name = str(dtype).split(".")[1]
    row = {"variant": "interp" if interp else "nearest", "dtype": name,
           "shape": list(shape), "equal": True, "max_abs_err": require_equal(
               f"lut_gelu interp={interp} {name} {shape} offset {offset}",
               got, want)}
    if offset:
        row["offset"] = offset
    del got, want
    if timed:
        nbytes = 2 * x.element_size() * numel + 4 * 32
        b_ms, by = bound(nbytes, GELU_OPS_PER_ELEM[interp] * numel, F32_OPS_PER_S)
        row.update(bytes=nbytes, bound_ms=b_ms, bound_by=by, **timings(
            lambda: ops.lut_gelu(x, interp=interp),
            lambda: ref.lut_gelu(x, interp=interp),
            lambda: torch.nn.functional.gelu(x), numel))
    return row


def _rand_i8(gen, shape, dev, lo=-128, hi=128):
    return torch.randint(lo, hi, shape, generator=gen, device=dev,
                         dtype=torch.int32).to(torch.int8)


def matmul_activations(gen, m, k, dev, bits=8):
    """Float activations for the fused eq-9 quantiser: normal values, and
    in front the quantiser's edges — exact .5 ties (``x * 2^5 + 0.5`` an
    integer), values just inside and beyond the clip edges, and far
    beyond them."""
    x = torch.randn((m, k), generator=gen, device=dev) * 2.0
    lo, hi = quant.int_range(bits)
    s = 2.0 ** 5
    edges = torch.tensor([0.5 / s, -0.5 / s, 1.5 / s, -1.5 / s, (hi + 0.5) / s,
                          (lo - 0.5) / s, (hi - 0.5) / s, (lo + 0.5) / s,
                          (hi + 1) / s, (lo - 1) / s, 1e6, -1e6], device=dev)
    flat = x.view(-1)
    flat[:min(edges.numel(), flat.numel())] = edges[:flat.numel()]
    return x


def matmul_library(x_int, grid, numel_hint: int) -> dict:
    """The library calls beside the matmul: ``torch._int_mm`` (the same
    int8 x int8 -> int32 product; where it refuses the shape, its error
    text) and float32 ``torch.matmul`` over the same integer grids;
    ``library_ms`` / ``library_device_ms`` are the faster of the two on
    the device, ``library_call`` names it."""
    out = {}
    try:
        torch._int_mm(x_int, grid)
        torch.cuda.synchronize()
        out.update(int_mm_ms=time_ms(lambda: torch._int_mm(x_int, grid),
                                     numel_hint),
                   int_mm_device_ms=device_ms(
                       lambda: torch._int_mm(x_int, grid), numel_hint))
    except RuntimeError as e:
        out["int_mm_error"] = str(e).splitlines()[0][:200]
    xf, wf = x_int.to(torch.float32), grid.to(torch.float32)
    out.update(f32_matmul_ms=time_ms(lambda: torch.matmul(xf, wf), numel_hint),
               f32_matmul_device_ms=device_ms(lambda: torch.matmul(xf, wf),
                                              numel_hint))
    best = "f32_matmul"
    if "int_mm_device_ms" in out and \
            out["int_mm_device_ms"] <= out["f32_matmul_device_ms"]:
        best = "int_mm"
    out.update(library_call={"int_mm": "torch._int_mm",
                             "f32_matmul": "torch.matmul (float32)"}[best],
               library_ms=out[f"{best}_ms"],
               library_device_ms=out[f"{best}_device_ms"])
    return out


def check_matmul(dev, gen, tag, m, k, n, *, bits=8, per_channel=False,
                 residual_bits=16, x_float=False, axis_range=(-2, 3),
                 timed=False):
    """The f32-epilogue mode through the public wrapper, QTensor weight
    (an int4 one nibble-packed, unpacked by the kernel), the activation
    as int8 or (``x_float``) as float32 quantised by the kernel; against
    the plain version of the same input modes (``quantize_act``, then
    ``unpack_po2``, then the integer matmul), ``torch.equal``."""
    lo, hi = quant.int_range(bits)
    x = matmul_activations(gen, m, k, dev) if x_float else \
        _rand_i8(gen, (m, k), dev)
    grid = _rand_i8(gen, (k, n), dev, lo, hi + 1)
    axis = _rand_i8(gen, (n,), dev, *axis_range) if per_channel else None
    w = quant.QTensor.store(grid, 6, bits=bits, axis_exponents=axis)
    w_shape = w.logical_shape if w.packed else None
    got = ops.int8_matmul(x, w, x_exp=5, residual_bits=residual_bits)

    def plain():
        return ref.int8_matmul_io(x, w.values, shift=0,
                                  clip16=residual_bits == 16, out_exp=11,
                                  axis_exponents=axis, x_exp=5,
                                  w_shape=w_shape)

    want = plain()
    row = {"variant": f"f32 int{bits}" + (" per-channel" if per_channel else "")
           + f" residual{residual_bits}" + (" float-x" if x_float else ""),
           "tag": tag, "shape_mkn": [m, k, n], "input": "float32 x, "
           "quantised in the kernel" if x_float else "int8 x",
           "equal": True, "max_abs_err": require_equal(
               f"int8_matmul {tag} {(m, k, n)} int{bits} pc={per_channel} "
               f"rb={residual_bits} float_x={x_float}", got, want)}
    if residual_bits == 16 and k >= 8 and not per_channel:
        row["clip_hit"] = bool((want.abs() >= 32767 * 2.0 ** -11).any())
    del got, want
    if timed:
        nbytes = (4 if x_float else 1) * m * k + w.values.numel() \
            + 4 * m * n + (n if per_channel else 0)
        b_ms, by = bound(nbytes, 2.0 * m * k * n, INT8_OPS_PER_S)
        x_int = quant.quantize_act(x, 5).to(torch.int8) if x_float else x
        hint = m * max(k, n)
        row.update(bytes=nbytes, bound_ms=b_ms, bound_by=by,
                   ms=time_ms(lambda: ops.int8_matmul(
                       x, w, x_exp=5, residual_bits=residual_bits), hint),
                   device_ms=device_ms(lambda: ops.int8_matmul(
                       x, w, x_exp=5, residual_bits=residual_bits), hint),
                   plain_ms=time_ms(plain, hint),
                   **matmul_library(x_int, grid, hint))
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


def check_attention(dev, gen, shape, causal, use_lut, *, dtype=torch.float32,
                    timed=False, exact_vs_plain=True, strided=False):
    """The wrapper against ``ref.lut_attention_tiled`` at the wrapper's
    key tile and against its plain version ``ref.lut_attention``, on the
    same CUDA tensors.  ``shape`` = (b, hq, hkv, lq, lk, d).  The exact
    mode keeps the reference kernel's clip of ``m - s`` at 10, which the
    plain version lacks: ``exact_vs_plain=False`` where rows spread wider.
    ``strided``: q, k, v are views of ``[B, L, H, D]`` tensors transposed,
    as the layer passes them, and the output must be laid out so that the
    layer's ``transpose(1, 2).reshape(B, L, H * D)`` is a view."""
    b, hq, hkv, lq, lk, d = shape
    if strided:
        q, k, v = (torch.randn(s, generator=gen, device=dev).to(dtype)
                   .transpose(1, 2)
                   for s in ((b, lq, hq, d), (b, lk, hkv, d), (b, lk, hkv, d)))
    else:
        q, k, v = (torch.randn(s, generator=gen, device=dev).to(dtype)
                   for s in ((b, hq, lq, d), (b, hkv, lk, d), (b, hkv, lk, d)))
    mode = "lut" if use_lut else "exact"
    block_k = ops.fit_block(lk, ops.ATTN_BLOCK_K)
    got = ops.lut_attention(q, k, v, causal=causal, use_lut=use_lut)
    if strided and got.transpose(1, 2).reshape(b, lq, hq * d).data_ptr() \
            != got.data_ptr():
        raise AssertionError(f"lut_attention {shape}: the output of strided "
                             "operands is not laid out [B, L, H, D]")
    want = ref.lut_attention_tiled(q, k, v, causal=causal, use_lut=use_lut,
                                   block_k=block_k)
    plain = ref.lut_attention(q, k, v, causal=causal, softmax_mode=mode)
    plain_err = max_abs_err(got, plain)
    torch.cuda.synchronize()
    what = f"lut_attention {mode} causal={causal} {shape} {dtype}"
    if got.dtype != q.dtype or got.shape != q.shape:
        raise AssertionError(f"{what}: {got.dtype} {tuple(got.shape)} out")
    if not bool(torch.isfinite(got).all()):
        raise AssertionError(f"{what}: non-finite output")
    diff = (got.to(torch.float64) - want.to(torch.float64)).abs()
    err = float(diff.max()) if diff.numel() else 0.0
    share = float((diff <= 1e-5).double().mean()) if diff.numel() else 1.0
    if dtype == torch.float32:
        if use_lut:
            ok = err <= ATTN_TIGHT_ATOL and share >= ATTN_TIGHT_MIN_SHARE \
                and plain_err <= ATTN_LUT_ATOL
        else:
            ok = all(bool(torch.allclose(got, w, rtol=ATTN_EXACT_TOL,
                                         atol=ATTN_EXACT_TOL))
                     for w in ((want, plain) if exact_vs_plain else (want,)))
        if not ok:
            raise AssertionError(f"{what}: max abs err {err}, share within "
                                 f"1e-5 {share} (tiled version), max abs err "
                                 f"{plain_err} (plain version)")
    row = {"variant": mode + (" causal" if causal else "")
           + (" strided" if strided else ""),
           "dtype": str(dtype).split(".")[1], "shape_bhhlld": list(shape),
           "block_k": block_k, "equal": False,
           "max_abs_err": err, "within_1e-5": share,
           "plain_max_abs_err": plain_err}
    del got, want, plain, diff
    if timed:
        nbytes = q.element_size() * (2 * b * hq * lq * d + 2 * b * hkv * lk * d) \
            + 4 * 320
        b_ms, by = bound(nbytes, 4.0 * b * hq * lq * lk * d, F32_OPS_PER_S)
        numel = b * hq * lq * lk
        sdpa = torch.nn.functional.scaled_dot_product_attention
        # the bytes alone, beside the float32 operations bound kept from
        # the first slices: what a tensor-core design is held to
        row.update(bytes_bound_ms=nbytes / HBM_BYTES_PER_S * 1e3)
        row.update(bytes=nbytes, bound_ms=b_ms, bound_by=by, **timings(
            lambda: ops.lut_attention(q, k, v, causal=causal, use_lut=use_lut),
            lambda: ref.lut_attention(q, k, v, causal=causal,
                                      softmax_mode=mode),
            lambda: sdpa(q, k, v, is_causal=causal), numel))
    return row


def slab_rows(n: int, aligned: bool) -> int:
    """The softmax launcher's rows per slab for rows of ``n`` floats at a
    16-byte aligned base or not, 0 for its global path."""
    return build.load().lut_softmax_slab_rows(n, int(aligned))


def max_slab_n() -> int:
    """The longest row the softmax's slab path takes."""
    n = 1
    while slab_rows(n + 1, True):
        n += 1
    return n


def softmax_edge_shapes() -> list:
    """(m, n, offset): the first ragged list, then for each row length the
    slab path's edges at its rows per slab R — one row, M < R, M = R, a
    short last slab either side of 3 R, and 40000 R + 1 (every warp walks
    several slabs, round its ring of stages more than once); rows of
    <= 16 floats, several to a warp; the slab limit and one
    above it (the global path); views that start off a 16-byte boundary
    (the global path)."""
    shapes = [(m, n, 0) for m, n in ((1000, 1000), (7, 1), (1, 1), (5, 4099),
                                     (33, 65), (3, 16384))]
    limit = max_slab_n()
    for n in (1, 3, 8, 13, 16, 17, 27, 64, 99, limit):
        r = slab_rows(n, True)
        shapes += [(m, n, 0) for m in (1, r - 1, r, 3 * r - 1, 3 * r + 1,
                                       40000 * r + 1)]
    n = limit + 1
    shapes += [(4, n, 0), (9, n, 0), (40001, n, 0)]
    shapes += [(81, 99, 1), (300, 13, 2), (9, limit, 3),
               (1000, 27, 1)]
    return shapes


def gelu_edge_shapes() -> list:
    """(shape, dtype, offset): the first ragged list in both dtypes, then
    lengths that leave 1, 3 and 7 elements past the last whole vector
    (4 f32 or 8 bf16 a vector), among them arrays shorter than a vector
    and a bf16 array of many thousand blocks, and views that start off a
    16-byte boundary, among them views that end before the next boundary
    (all head, no whole vector)."""
    f32, bf16 = torch.float32, torch.bfloat16
    shapes = [(s, d, 0) for s in ((3, 5), (1,), (257, 33), (1000003,))
              for d in (f32, bf16)]
    shapes += [((n,), f32, 0) for n in (3, 4097, 4099, 65543)]
    shapes += [((n,), bf16, 0) for n in (7, 8193, 8195, 8199, 8650759)]
    shapes += [((4099,), f32, o) for o in (1, 2, 3)]
    shapes += [((12345,), bf16, o) for o in (1, 3, 7)]
    shapes += [((3,), bf16, 5), ((37, 11), f32, 2)]
    shapes += [((2,), f32, 1), ((1,), f32, 3), ((2,), f32, 2),
               ((3,), bf16, 1), ((6,), bf16, 1), ((1,), bf16, 7)]
    return shapes


# the reference's sweep (tests/test_kernels.py): MHA, GQA, MQA, decode and
# the multi-tile long key axis; then ragged shapes
ATTN_SWEEP = [(1, 2, 2, 64, 64, 32), (2, 4, 2, 64, 64, 32),
              (1, 8, 1, 128, 128, 64), (2, 4, 2, 1, 64, 32),
              (1, 2, 2, 64, 256, 32)]
ATTN_RAGGED = [(3, 2, 1, 27, 27, 8), (1, 2, 2, 30, 1000, 32),
               (2, 2, 1, 27, 27, 72), (1, 4, 2, 40, 20, 16)]
# key tiles of 8, 27 and 99 keys (fit_block(1000, 128) = 8) against depths
# of 8, 64 and 72: a partial fragment of keys, one of depth, both, GQA
ATTN_BK_D = [(2, 2, 1, lq, lk, d) for lq, lk in ((30, 1000), (27, 27),
                                                 (99, 99))
             for d in (8, 64, 72)]
# int4 payloads with an odd K * N (a padded last nibble)
MATMUL_ODD = [(7, 13, 9), (100, 99, 35), (3, 1, 1), (6272, 40, 63)]


def phase_kernels(dev, configs) -> dict:
    """Returns, per kernel, its checked-and-timed rows."""
    gen = torch.Generator(device=dev).manual_seed(0)
    rows = {"lut_softmax": [], "lut_gelu": [], "int8_matmul": [],
            "lut_attention": []}
    for cfg in configs:
        for b in BATCHES:
            sh = model_shapes(cfg, b)
            # the LUT mode is the one the main path runs, and is timed
            for use_lut in (True, False):
                r = check_attention(dev, gen, sh["attention"], False, use_lut,
                                    timed=use_lut, exact_vs_plain=False)
                rows["lut_attention"].append(
                    {"model": cfg.name, "batch": b, **r})
            for fixed in (True, False):
                r = check_softmax(dev, gen, *sh["softmax"], fixed, timed=True)
                rows["lut_softmax"].append({"model": cfg.name, "batch": b, **r})
            for interp in (False, True):
                r = check_gelu(dev, gen, sh["gelu"], interp, torch.float32, True)
                rows["lut_gelu"].append({"model": cfg.name, "batch": b, **r})
            # the layer's strided views, held to the same terms
            r = check_attention(dev, gen, sh["attention"], False, True,
                                strided=True)
            rows["lut_attention"].append({"model": cfg.name, "batch": b, **r})
            for tag, m, k, n in sh["matmul"]:
                # the float activation is what the cuda plans pass (timed
                # as the main path's); the int8 one is int8_matmul_raw's
                # and a QTensor activation's input, timed beside it
                for x_float in (True, False):
                    r = check_matmul(dev, gen, tag, m, k, n, x_float=x_float,
                                     timed=True)
                    rows["int8_matmul"].append(
                        {"model": cfg.name, "batch": b, **r})
                if cfg.n_layers > 1:    # the int4 per-channel plan served below
                    r = check_matmul(dev, gen, tag, m, k, n, bits=4,
                                     per_channel=True, x_float=True,
                                     timed=True)
                    rows["int8_matmul"].append(
                        {"model": cfg.name, "batch": b, **r})
    # ragged shapes, the edges of the softmax's slab path and of the GELU's
    # vectors, and the options the main path does not take
    for m, n, offset in softmax_edge_shapes():
        for fixed in (True, False):
            rows["lut_softmax"].append(
                check_softmax(dev, gen, m, n, fixed, False, offset))
    for shape, dtype, offset in gelu_edge_shapes():
        for interp in (False, True):
            rows["lut_gelu"].append(
                check_gelu(dev, gen, shape, interp, dtype, False, offset))
    for m, k, n in [(33, 17, 5), (257, 256, 35), (1, 1, 1),
                    (64, 300, 129)] + MATMUL_ODD:
        for bits, pc in ((8, False), (8, True), (4, False), (4, True)):
            for rb in (16, 32):
                for x_float in (False, True):
                    # per-channel exponents over -8..8 in both input modes
                    rows["int8_matmul"].append(check_matmul(
                        dev, gen, "ragged", m, k, n, bits=bits,
                        per_channel=pc, residual_bits=rb, x_float=x_float,
                        axis_range=(-8, 9)))
        for shift, i16 in ((0, False), (5, False), (5, True), (0, True),
                           (-3, False), (-9, True)):
            rows["int8_matmul"].append(
                check_matmul_raw(dev, gen, m, k, n, shift, i16))
    for shape in ATTN_SWEEP + ATTN_RAGGED:
        for causal in (True, False):
            for use_lut in (True, False):
                rows["lut_attention"].append(
                    check_attention(dev, gen, shape, causal, use_lut))
    for shape in ATTN_BK_D:
        for causal, use_lut in ((True, True), (False, True), (False, False)):
            for strided in (False, True):
                rows["lut_attention"].append(check_attention(
                    dev, gen, shape, causal, use_lut, strided=strided))
    for causal in (True, False):
        rows["lut_attention"].append(check_attention(
            dev, gen, (1, 2, 2, 32, 32, 32), causal, True,
            dtype=torch.bfloat16))
    emit({"phase": "kernels", "all_checks_passed": True,
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


def expected_launches(cfg, forwards: int, attention: str = "xla") -> dict:
    """Per forward (or stream hop): one GELU per layer, and one softmax per
    layer under ``attention="xla"`` or one attention launch per layer
    under ``"flash_lut"``; every linear is a matmul launch — patch embed,
    head, and Q, K, V, wo, w1, w2 per layer (Q/K/V go as three launches)."""
    flash = attention == "flash_lut"
    return {"lut_softmax": 0 if flash else cfg.n_layers * forwards,
            "lut_gelu": cfg.n_layers * forwards,
            "int8_matmul": (2 + 6 * cfg.n_layers) * forwards,
            "lut_attention": cfg.n_layers * forwards if flash else 0}


def check_flash_logits(what, cfg, got, want) -> dict:
    """cuda + flash_lut against lut + flash_lut: kernel against plain
    attention, then the same integer pipeline, in which a moved LSB of
    the attention output can be amplified by the layers after it."""
    got, want = got.cpu(), want.cpu()
    diff = float((got - want).abs().max())
    agree = float((got.argmax(-1) == want.argmax(-1)).float().mean())
    tol = FLASH_TINY_ATOL if cfg.n_layers == 1 else FLASH_KWT1_ATOL
    if diff > tol or (cfg.n_layers > 1 and agree < FLASH_KWT1_MIN_ARGMAX_AGREE):
        raise AssertionError(f"{what}: cuda + flash_lut logits {diff} from lut "
                             f"+ flash_lut (tolerance {tol}), argmax "
                             f"agreement {agree}")
    return {"max_abs": diff, "argmax_agree": agree}


def phase_serve(name: str, dev, batches, recipes, requests=3) -> dict:
    cfg = registry.get(name).config
    np_tree = seeded_params(cfg, 0, dev)
    rng = np.random.default_rng(1)
    out = {"phase": f"serve_{cfg.name.replace('-', '_')}", "model": cfg.name,
           "n_layers": cfg.n_layers, "d_model": cfg.d_model, "plans": []}
    expected = {}
    for label, recipe_kw, attention in recipes:
        params = convert.from_numpy_tree(np_tree, dev)
        recipe = None if recipe_kw is None else \
            runtime.QuantRecipe.from_config(cfg, **recipe_kw)
        eng = runtime.compile_model(cfg, params, backend="cuda",
                                    recipe=recipe, attention=attention,
                                    device=dev)
        plain = runtime.compile_model(cfg, params, backend="lut",
                                      recipe=recipe, attention=attention,
                                      device=dev)
        on_cpu = runtime.compile_model(
            cfg, convert.from_numpy_tree(np_tree, "cpu"), backend="lut",
            recipe=recipe, attention=attention, device="cpu")
        flash = attention == "flash_lut"
        plan = {"recipe": label, "attention": attention,
                "describe": eng.describe(),
                "rom_bytes": eng.rom_bytes, "lut_bytes": eng.lut_bytes,
                "param_bytes": eng.param_bytes, "batches": []}
        with CountOps() as counter:
            eng.forward(np.zeros((1, *cfg.input_dim), np.float32))
        plan["aten_ops_per_forward"] = counter.n
        for b in batches:
            before = ops.launch_counts()
            lat, logits, vs_plain = [], None, []
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
                if flash:
                    vs_plain.append(check_flash_logits(
                        f"{cfg.name} {label} B={b}", cfg, logits, want))
                elif not torch.equal(logits, want):
                    raise AssertionError(
                        f"{cfg.name} {label} B={b}: cuda plan differs from the "
                        f"lut plan on the card by {max_abs_err(logits, want)}; "
                        "with the kernel phase passing, a wrapper hands its "
                        "kernel other operands than the plain path gets")
            after = ops.launch_counts()
            rose = {k: after[k] - before[k] for k in after}
            want_rise = expected_launches(cfg, requests, attention)
            if rose != want_rise:
                raise AssertionError(f"{cfg.name} B={b}: launch counters rose "
                                     f"by {rose}, expected {want_rise}")
            entry = {"batch": b, "requests": requests,
                     "p50_ms": statistics.median(lat), "launches": rose}
            if flash:
                entry["vs_lut_flash_on_card"] = {
                    "max_abs": max(v["max_abs"] for v in vs_plain),
                    "argmax_agree": min(v["argmax_agree"] for v in vs_plain)}
            if b in CPU_BATCHES:
                ref_logits = on_cpu.forward(mfcc)
                if flash:
                    v = check_flash_logits(f"{cfg.name} {label} B={b} vs CPU",
                                           cfg, logits, ref_logits)
                    entry.update(vs_cpu_max_abs=v["max_abs"],
                                 vs_cpu_argmax_agree=v["argmax_agree"])
                else:
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
        plan["launches"] = {k: sum(e["launches"][k] for e in plan["batches"])
                            for k in ops.launch_counts()}
        out["plans"].append(plan)
        # the path's count: the request forwards and the one that counted
        # ATen ops
        want = expected_launches(cfg, 1 + requests * len(batches), attention)
        expected = {k: expected.get(k, 0) + want[k] for k in want}
    emit(out)
    return expected


# ---------------------------------------------------------------------------
# phases 6 + 7: the always-on stream
# ---------------------------------------------------------------------------

STREAM_CHUNKS = (1, 2, 5)     # hops per stream_step, cycled
RESET_LANE = 3


def _rise(before: dict) -> dict:
    after = ops.launch_counts()
    return {k: after[k] - before[k] for k in after}


def phase_stream(name: str, dev, lanes: int, hops: int, reset_at: int) -> dict:
    """Stream ``lanes`` lanes of seeded audio through ``Engine.stream_step``
    for ``hops`` hops in chunks cycling through ``STREAM_CHUNKS``, under the
    cuda backend with both attention realisations.  On every hop, the
    logits of every warm lane must be ``torch.equal`` to ``Engine.forward``
    of the feature ring's window (a lane that is not warm holds zeroed
    embeddings where the window holds zeroed features, whose embedding is
    the bias).  Lane ``RESET_LANE`` is reset at hop ``reset_at`` and must
    be warm again at the end.

    The check forwards launch kernels too: the phase returns, besides its
    line, the launches of its ``stream_step`` calls and those of its check
    forwards, so that the main path's count can leave the latter out."""
    cfg = registry.get(name).config
    fcfg = features.FrontendConfig(n_mfcc=cfg.input_dim[0])
    t, hop = stream.window_frames(cfg), fcfg.hop_len
    if hops < reset_at + t:
        raise ValueError("the reset lane would not re-warm")
    np_tree = seeded_params(cfg, 0, dev)
    rng = np.random.default_rng(2)
    audio = torch.from_numpy((0.1 * rng.normal(size=(lanes, hops * hop)))
                             .astype(np.float32)).to(dev)
    hop_ms = 1e3 * hop / fcfg.sample_rate
    out = {"phase": f"stream_{cfg.name.replace('-', '_')}", "model": cfg.name,
           "n_layers": cfg.n_layers, "d_model": cfg.d_model,
           "n_mfcc": fcfg.n_mfcc, "window_frames": t, "lanes": lanes,
           "hops": hops, "chunk_hops": list(STREAM_CHUNKS),
           "reset": {"lane": RESET_LANE, "at_hop": reset_at}, "plans": []}
    steps_rose = dict.fromkeys(ops.launch_counts(), 0)
    checks_rose = dict.fromkeys(steps_rose, 0)
    expected = dict.fromkeys(steps_rose, 0)
    for attention in ("xla", "flash_lut"):
        eng = runtime.compile_model(cfg, convert.from_numpy_tree(np_tree, dev),
                                    backend="cuda", attention=attention,
                                    device=dev)
        state = stream.init_stream_state(cfg, fcfg, lanes, device=dev)
        per_hop = expected_launches(cfg, 1, attention)
        lat, rtf, ks, checked, step, i, reset = [], [], [], 0, 0, 0, False
        first_warm = None
        while i < hops:
            k = min(STREAM_CHUNKS[step % len(STREAM_CHUNKS)], hops - i)
            if not reset and i >= reset_at:
                state = stream.reset_lane(state, RESET_LANE)
                warm = stream.warm(state).cpu()
                if bool(warm[RESET_LANE]) or not bool(warm.sum() == lanes - 1):
                    raise AssertionError(f"reset_lane left warm = {warm}")
                reset = True
            before = ops.launch_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, logits = eng.stream_step(state, audio[:, i * hop:(i + k) * hop],
                                            fcfg)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
            rose = _rise(before)
            if rose != per_hop:
                raise AssertionError(f"{cfg.name} {attention} hop {i}: counters "
                                     f"rose by {rose}, expected {per_hop}")
            steps_rose = {n: steps_rose[n] + rose[n] for n in rose}
            expected = {n: expected[n] + per_hop[n] for n in per_hop}
            lat.append(ms)
            rtf.append(ms / (k * hop_ms))
            ks.append(k)
            i, step = i + k, step + 1
            if tuple(logits.shape) != (lanes, cfg.n_classes) or \
                    not bool(torch.isfinite(logits).all()):
                raise AssertionError(f"{cfg.name} hop {i}: bad logits")
            warm = stream.warm(state)
            if bool(warm.any()):
                first_warm = i if first_warm is None else first_warm
                before = ops.launch_counts()
                want = eng.forward(stream.window_mfcc(state))
                rose = _rise(before)
                if rose != per_hop:
                    raise AssertionError(f"the check forward launched {rose}")
                checks_rose = {n: checks_rose[n] + rose[n] for n in rose}
                if not torch.equal(logits[warm], want[warm]):
                    raise AssertionError(
                        f"{cfg.name} {attention} hop {i}: streaming logits "
                        f"differ from the offline forward of the window by "
                        f"{max_abs_err(logits, want)}")
                checked += 1
        if not bool(stream.warm(state).all()):
            raise AssertionError(f"lane {RESET_LANE} did not re-warm")
        off = features.mfcc(audio, fcfg)[..., -t:]
        frames = stream.window_mfcc(state)
        frames_err = max_abs_err(frames, off)
        if not torch.equal(frames, off):
            raise AssertionError(
                f"{cfg.name} {attention}: streaming MFCC frames differ from "
                f"the offline ones by {frames_err}")
        out["plans"].append({
            "attention": attention, "describe": eng.describe(),
            "steps": step, "first_warm_hop": first_warm,
            "warm_steps_checked_equal": checked,
            "p50_ms_per_step": statistics.median(lat),
            "p50_rtf": statistics.median(rtf),
            "p50_ms_by_chunk": {k: statistics.median(
                [m for m, kk in zip(lat, ks) if kk == k]) for k in STREAM_CHUNKS},
            "launches_per_step": per_hop,
            "frames_vs_offline_mfcc": {"max_abs": frames_err,
                                       "equal": True}})
    out["launches"] = steps_rose
    out["check_forward_launches"] = checks_rose
    emit(out)
    return steps_rose, checks_rose, expected


# ---------------------------------------------------------------------------
# phases 8 + 9: the always-on server (the serving cell)
# ---------------------------------------------------------------------------

CELL_TINY_ARGS = ["--arch", "kwt-tiny", "--backend", "cuda", "--streams", "24",
                  "--slots", "8", "--hops", "60", "--chunk-hops", "1",
                  "--train-steps", "20", "--degrade-queue", "8",
                  "--degrade-chunk-hops", "2", "--seed", "0"]
CELL_KWT1_SLOTS = 64
CELL_KWT1_HOPS = 120          # > 98 frames of window + 5 of smoothing
CELL_KWT1_SWAP_AT, CELL_KWT1_RESET_AT = 40, 70
CELL_RESET_LANE = 5
# the keyword class is one of 35: on random weights its smoothed posterior
# stays between 0.003 and 0.037 (measured on the card, PERF.md), so the
# detector fires at 0.005 and releases below 0.004
CELL_KWT1_DETECTOR = dict(smooth_hops=5, on_threshold=0.005,
                          off_threshold=0.004, refractory_hops=10)


def run_serve(argv: list) -> tuple:
    """``launch.stream_serve.main(argv)`` with its log lines kept out of
    this script's output (they are returned)."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        fired = stream_serve.main(argv)
    return fired, buf.getvalue()


def log_fields(log: str, event: str) -> dict:
    """The ``key=value`` fields of the last ``event=<event>`` log line."""
    line = [ln for ln in log.splitlines() if ln.startswith(f"event={event} ")][-1]
    return dict(p.split("=", 1) for p in line.split()[2:])


def phase_cell_kwt_tiny(dev, tmp: str) -> tuple:
    """KWT-Tiny served by the launcher, ``repro_torch.launch.stream_serve``,
    under ``--backend cuda``: 24 streams on 8 slots, the degrade stage on,
    tracing on.  The artifacts must pass the port's validators, the hop
    ledger must be exact, and the cell's launches must be one hop's worth
    per engine step.  Returns the line, the launches and the expected."""
    cfg = registry.get("kwt-tiny").smoke
    trace = os.path.join(tmp, "cell_kwt_tiny.json")
    argv = CELL_TINY_ARGS + ["--telemetry-out", trace]
    before = ops.launch_counts()
    t0 = time.perf_counter()
    fired, log = run_serve(argv)
    seconds = time.perf_counter() - t0
    path = _rise(before)
    done = log_fields(log, "serve_done")
    checked = telemetry_check.check_artifacts(trace, require_metrics=True)
    metrics = json.loads(Path(trace).with_suffix(".metrics.json").read_text())
    hops_total = metrics["cell_hops_total"]["value"]
    if not (int(done["ingested_hops"]) == int(done["offered_hops"])
            == hops_total) or metrics["cell_dropped_hops_total"]["value"]:
        raise AssertionError(f"hop ledger: ingested {done['ingested_hops']}, "
                             f"offered {done['offered_hops']}, counter "
                             f"{hops_total}")
    steps_run = metrics["cell_hop_latency_ms"]["summary"]["n"]
    expected = expected_launches(cfg, steps_run)
    if path != expected:
        raise AssertionError(f"the launcher's cell launched {path}, expected "
                             f"{expected} ({steps_run} engine steps)")
    events = json.loads(Path(trace).read_text())["traceEvents"]
    spans = {(e["name"], e.get("args", {}).get("parent")) for e in events}
    if not {("stream_step", "hop"), ("hop", "stream_step")} <= spans:
        raise AssertionError(f"no Engine.stream_step spans in the trace: {spans}")
    degraded = metrics["cell_admission_total"]
    out = {"phase": "cell_kwt_tiny", "model": cfg.name, "argv": argv,
           "seconds": seconds, "artifacts": checked, "engine_steps": steps_run,
           "serve_done": done, "fired": len(fired),
           "admission": degraded, "launches": path,
           "launches_per_step": expected_launches(cfg, 1),
           "p50_hop_ms": float(done["p50_ms"]),
           "rtf_p50_one_hop": float(done["p50_ms"]) / 10.0}
    emit(out)
    return path, expected


def _cell_chunks(n_lanes: int, hops: int, hop: int) -> np.ndarray:
    """[hops, lanes, hop] host chunks of seeded keyword event streams."""
    audio = np.stack([pipeline.keyword_event_stream(1, lane, n_hops=hops,
                                                    hop_len=hop)[0]
                      for lane in range(n_lanes)])
    return np.ascontiguousarray(audio.reshape(n_lanes, hops, hop)
                                .transpose(1, 0, 2))


def _zeroed_lane(lanes, lane: int) -> bool:
    d, s = lanes.dstate, lanes.state
    return (int(d["hist"]["count"][lane]) == 0 and not bool(d["active"][lane])
            and int(d["cooldown"][lane]) == 0 and int(d["warm_hops"][lane]) == 0
            and int(s["embed"]["count"][lane]) == 0
            and not bool(s["frontend"]["tail"][lane].any()))


def cell_kwt1_plan(dev, cfg, np_tree, np_tree2, attention: str, tmp: str):
    """One attention realisation of ``cell_kwt_1``.  Returns the plan's line,
    the launches of its lane hops and those of its checks."""
    fcfg = stream_serve.frontend_for(cfg)
    dcfg = detector.DetectorConfig(**CELL_KWT1_DETECTOR)
    per_hop = expected_launches(cfg, 1, attention)
    eng = runtime.compile_model(cfg, convert.from_numpy_tree(np_tree, dev),
                                backend="cuda", attention=attention, device=dev)
    watch = os.path.join(tmp, f"watch_{attention}")
    probe = np.random.RandomState(3).normal(
        0, 0.5, (1, *cfg.input_dim)).astype(np.float32)
    cell = cellmod.ServeCell(
        eng, slots=CELL_KWT1_SLOTS, registry=telemetry.Registry(),
        watch_dir=watch, watch_like=eng.params, probe=probe,
        flight=telemetry.FlightConfig(dump_dir=os.path.join(
            tmp, f"flight_{attention}")))
    chunks = _cell_chunks(CELL_KWT1_SLOTS, CELL_KWT1_HOPS, fcfg.hop_len)
    lanes_rose = dict.fromkeys(ops.launch_counts(), 0)
    checks_rose = dict(lanes_rose)

    def count(into, before):
        for k, v in _rise(before).items():
            into[k] += v

    with cell:
        joint = cell.stream_lanes(fcfg, dcfg)
        piped = cell.stream_lanes(fcfg, dcfg, pipelined=True)
        ingest = cell.stream_lanes(fcfg, dcfg, feature_ingest=True)
        for lanes in (joint, piped, ingest):
            for lane in range(CELL_KWT1_SLOTS):
                lanes.join(lane)
        edge = features.frontend_init(fcfg, CELL_KWT1_SLOTS, device=dev)
        ev = {"joint": [], "pipelined": [], "ingest": []}
        ms = {"joint": [], "pipelined": []}
        bounds = (0, CELL_KWT1_SWAP_AT, CELL_KWT1_RESET_AT, CELL_KWT1_HOPS)
        gen0 = cell.handle.generation
        for seg in range(3):
            lo, hi = bounds[seg], bounds[seg + 1]
            if seg == 1:          # a packed artifact published mid-stream
                packed = runtime.QuantRecipe.from_config(cfg).quantize(
                    convert.from_numpy_tree(np_tree2, dev))
                ckpt_manager.save(watch, 1, packed)
                before = ops.launch_counts()
                buf = io.StringIO()
                with contextlib.redirect_stdout(buf):
                    swapped = cell.maybe_swap()
                if not swapped:
                    raise AssertionError("maybe_swap did not install the "
                                         "published artifact")
                count(checks_rose, before)
                gate_err = float(log_fields(buf.getvalue(), "hot_swap")
                                 ["probe_err"])
            if seg == 2:          # one lane evicted and re-joined
                for lanes in (joint, piped, ingest):
                    lanes.evict(CELL_RESET_LANE)
                    lanes.join(CELL_RESET_LANE)
                    if not _zeroed_lane(lanes, CELL_RESET_LANE):
                        raise AssertionError("a re-joined lane kept state")
                tail = edge["tail"].clone()
                tail[CELL_RESET_LANE] = 0.0
                edge = {"tail": tail}
            before = ops.launch_counts()
            for h in range(lo, hi):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                ev["joint"].append(joint.hop(chunks[h]))
                ms["joint"].append((time.perf_counter() - t0) * 1e3)
                with torch.inference_mode():
                    edge, frames = features.frontend_push(
                        edge, torch.from_numpy(chunks[h]).to(dev), fcfg)
                ev["ingest"].append(ingest.hop(frames))
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for e in piped.run(chunks[lo:hi]):
                ev["pipelined"].append(e)
                t1 = time.perf_counter()
                ms["pipelined"].append((t1 - t0) * 1e3)
                t0 = t1
            count(lanes_rose, before)
        if cell.handle.generation != gen0 + 1:
            raise AssertionError(f"generation {cell.handle.generation}, "
                                 f"expected {gen0 + 1}")
        for mode in ("pipelined", "ingest"):
            for h, (a, b) in enumerate(zip(ev["joint"], ev[mode])):
                for key in ("fired", "score"):
                    if not np.array_equal(a[key], b[key]):
                        raise AssertionError(
                            f"{attention} hop {h}: {mode} lanes' {key} differ "
                            f"from the joint lanes' by "
                            f"{np.abs(a[key] - b[key]).max()}")
        m = cell.metrics
        want_hops = 3 * CELL_KWT1_HOPS * CELL_KWT1_SLOTS
        ledger = m.hops.value
        if ledger != want_hops or m.dropped_hops.value:
            raise AssertionError(f"hop ledger {ledger}, expected {want_hops}")
        # where a hop's time goes: the card's busy share under the profiler
        # (lane hops too: their launches count on the lane side)
        before = ops.launch_counts()
        window = chunks[:PROFILED_HOPS]
        profiled = {
            "joint": profile_hops(lambda: [joint.hop(c) for c in window]),
            "pipelined": profile_hops(lambda: list(piped.run(window)))}
        count(lanes_rose, before)
        # a corrupted artifact fails closed
        serving, failures = cell.engine, m.swap_failures.value
        bad = tree_map(lambda leaf: dataclasses.replace(
            leaf, exponent=leaf.exponent - 10)
            if isinstance(leaf, quant.QTensor) else leaf,
            runtime.QuantRecipe.from_config(cfg).quantize(
                convert.from_numpy_tree(np_tree2, dev)))
        before = ops.launch_counts()
        try:
            cellmod.hot_swap(cell.handle, bad, probe, metrics=m)
        except cellmod.SwapRejected:
            pass
        else:
            raise AssertionError("the corrupted artifact was installed")
        count(checks_rose, before)
        cell.flight.check()
        dumps = [json.loads(Path(d).read_text())["reason"]
                 for d in cell.flight.dumps]
        if m.swap_failures.value != failures + 1 or cell.engine is not serving \
                or dumps != ["swap_failure"]:
            raise AssertionError(f"corrupted artifact: swap_failures "
                                 f"{m.swap_failures.value}, dumps {dumps}")
        # taps on the cuda plan: the served logits are the untapped plan's
        x = np.random.RandomState(4).normal(
            0, 0.5, (CELL_KWT1_SLOTS, *cfg.input_dim)).astype(np.float32)
        before = ops.launch_counts()
        tapped = runtime.compile_model(
            cfg, convert.from_numpy_tree(np_tree, dev), backend="cuda",
            attention=attention, taps=True, device=dev)
        logits, aux = tapped.forward(x)
        require_equal(f"{attention} taps plan logits vs untapped",
                      logits, eng.forward(x))
        bad_taps = [f"{site}/{k}" for site, st in aux.items()
                    for k, v in st.items() if not bool(torch.isfinite(v))]
        if bad_taps or "block11/gelu" not in aux:
            raise AssertionError(f"taps: non-finite {bad_taps}, sites {list(aux)}")
        count(checks_rose, before)
    lane_hops = 3 * CELL_KWT1_HOPS + 2 * PROFILED_HOPS
    expected = {k: lane_hops * per_hop[k] for k in per_hop}
    if lanes_rose != expected:
        raise AssertionError(f"{attention}: the lanes launched {lanes_rose}, "
                             f"expected {expected}")
    hop_ms = 1e3 * fcfg.hop_len / fcfg.sample_rate
    line = {"attention": attention, "describe": eng.describe(),
            "hops": CELL_KWT1_HOPS, "lanes": CELL_KWT1_SLOTS,
            "lane_hops_launched": lane_hops,
            "modes_equal": ["joint", "pipelined (two streams)",
                            "feature ingest"],
            "generation": cell.handle.generation, "ledger_hops": ledger,
            "swap_ms": m.swap_ms.summary(), "swap_gate_err": gate_err,
            "swap_gate_tol": cellmod.hotswap._INT_EXEC_PROBE_TOL,
            "swap_failures": m.swap_failures.value,
            "flight_dumps": dumps, "taps_sites": len(aux),
            "fired": int(sum(e["fired"].sum() for e in ev["joint"])),
            "score_range": [float(min(e["score"].min() for e in ev["joint"])),
                            float(max(e["score"].max() for e in ev["joint"]))],
            "p50_hop_ms": {k: statistics.median(v) for k, v in ms.items()},
            "p50_rtf": {k: statistics.median(v) / hop_ms for k, v in ms.items()},
            "cell_hop_latency_ms": m.hop_ms.summary(),
            "profiled": profiled,
            "launches_per_hop": per_hop, "launches": lanes_rose,
            "check_launches": checks_rose}
    return line, lanes_rose, checks_rose, expected


PROFILED_HOPS = 20


def profile_hops(run_hops) -> dict:
    """``run_hops()`` under ``torch.profiler``: wall ms per hop, the
    kernels' device time per hop, and the share of the window in which the
    card ran a kernel (the union of the kernel intervals of the profiler's
    Chrome trace over the wall time; the profiler's own host cost is in
    the wall time, so the busy share without it is at least this)."""
    from torch.profiler import ProfilerActivity, profile
    with tempfile.TemporaryDirectory() as d:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            run_hops()
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
        path = os.path.join(d, "trace.json")
        prof.export_chrome_trace(path)
        events = json.loads(Path(path).read_text())["traceEvents"]
    spans = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]))
                   for e in events
                   if e.get("cat") == "kernel" and e.get("ph") == "X")
    if not spans:
        return {"device_busy_share": "not measured (no kernel events)"}
    busy, end = 0.0, -1.0
    for lo, hi in spans:
        if hi > end:
            busy += hi - max(lo, end)
            end = hi
    return {"hops": PROFILED_HOPS, "wall_ms_per_hop": wall_us / 1e3 / PROFILED_HOPS,
            "kernel_ms_per_hop": sum(hi - lo for lo, hi in spans) / 1e3
            / PROFILED_HOPS, "kernels_per_hop": len(spans) / PROFILED_HOPS,
            "device_busy_share": busy / wall_us}


def phase_cell_kwt_1(dev, tmp: str) -> tuple:
    """KWT-1 at full width and depth served by ``ServeCell`` directly (the
    launcher serves the smoke configs), 64 slots of seeded event streams,
    under ``cuda`` + ``xla`` and ``cuda`` + ``flash_lut``: joint, pipelined
    (two CUDA streams) and feature-ingest lanes on the same chunks give the
    same events and scores bit for bit; a packed artifact published mid-
    stream is hot-swapped in with an exact hop ledger; a lane evicted and
    re-joined comes back zeroed; a corrupted artifact is refused with one
    flight dump; the taps plan serves the untapped logits."""
    cfg = registry.get("kwt-1").config
    np_tree, np_tree2 = seeded_params(cfg, 0, dev), seeded_params(cfg, 1, dev)
    out = {"phase": "cell_kwt_1", "model": cfg.name, "n_layers": cfg.n_layers,
           "d_model": cfg.d_model, "plans": []}
    lanes = dict.fromkeys(ops.launch_counts(), 0)
    checks, expected = dict(lanes), dict(lanes)
    for attention in ("xla", "flash_lut"):
        line, rose, chk, exp = cell_kwt1_plan(dev, cfg, np_tree, np_tree2,
                                              attention, tmp)
        out["plans"].append(line)
        for k in lanes:
            lanes[k] += rose[k]
            checks[k] += chk[k]
            expected[k] += exp[k]
    out["launches"], out["check_launches"] = lanes, checks
    emit(out)
    return lanes, checks, expected


# ---------------------------------------------------------------------------
# phases 10 + 11: the train path
# ---------------------------------------------------------------------------

TRAIN_TINY_ARGS = ["--arch", "kwt-tiny", "--qat", "--qat-backend", "cuda",
                   "--distill-teacher-arch", "kwt-1",
                   "--distill-teacher-steps", "20", "--steps", "60",
                   "--global-batch", "64"]
TRAIN_TINY_CKPT_EVERY, TRAIN_TINY_FAIL_AT = 10, 35
TRAIN_KWT1_ARGS = ["--arch", "kwt-1", "--qat", "--qat-backend", "cuda",
                   "--steps", "10", "--global-batch", "64"]
TRAIN_BATCH = 64
QAT_ENVELOPE = 0.35           # int-executing plan vs QAT eval: the
                              # reference's own envelope (tests/test_qat.py)
TIMED_STEPS = 20              # student-alone QAT steps timed per model


def train_launches(cfg, steps_run: int) -> dict:
    """A QAT step under the cuda backend launches the softmax and the GELU
    once per layer in its forward, nothing in its backward (the STEs'
    backward is the exact ops' gradient in plain PyTorch), and no matmul
    (its linears are float products of fake-quant weights) or attention
    (einsum attention: the flash-LUT kernel has no gradient)."""
    return {"lut_softmax": cfg.n_layers * steps_run,
            "lut_gelu": cfg.n_layers * steps_run,
            "int8_matmul": 0, "lut_attention": 0}


def run_main(argv: list) -> tuple:
    """``launch.train.main(argv)`` with its per-step lines kept out of this
    script's output (they are returned)."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        result = train.main(argv)
    return result, buf.getvalue()


def check_ste(dev, cfg, b: int) -> dict:
    """The STE Functions on the card at the step's own shapes: forward
    ``torch.equal`` to the plain version, input gradient ``torch.equal``
    to ``torch.autograd.grad`` of the exact op on the same tensor; one
    launch in the forward, none in the backward."""
    gen = torch.Generator(device=dev).manual_seed(5)
    sh = model_shapes(cfg, b)
    out = {}
    cases = {
        # the model's call: approx.masked_softmax(scores, None, "cuda")
        "lut_softmax": (sh["softmax"],
                        lambda x: approx.masked_softmax(x, None, mode="cuda"),
                        lambda x: approx.softmax_lut(x, fixed=True),
                        lambda x: torch.softmax(x, dim=-1)),
        "lut_gelu": (sh["gelu"], lambda x: approx.gelu(x, mode="cuda"),
                     approx.gelu_lut, approx.gelu_exact)}
    for name, (shape, fn, plain, exact) in cases.items():
        x = (torch.randn(shape, generator=gen, device=dev) * 3.0
             ).requires_grad_(True)
        g = torch.randn(shape, generator=gen, device=dev)
        before = ops.launch_counts()
        y = fn(x)
        fwd = _rise(before)
        (gx,) = torch.autograd.grad(y, x, g)
        torch.cuda.synchronize()
        bwd = {k: v - fwd[k] for k, v in _rise(before).items()}
        want_fwd = {k: int(k == name) for k in fwd}
        if fwd != want_fwd or any(bwd.values()):
            raise AssertionError(f"STE {name}: forward launched {fwd}, "
                                 f"backward {bwd}; expected {want_fwd} and none")
        if y.grad_fn is None or "Ste" not in type(y.grad_fn).__name__:
            raise AssertionError(f"STE {name}: the output's grad_fn is "
                                 f"{y.grad_fn}, not the STE Function's")
        with torch.no_grad():
            want_y = plain(x)
        (want_g,) = torch.autograd.grad(exact(x), x, g)
        out[name] = {"shape": list(shape),
                     "forward_max_abs_err": require_equal(
                         f"STE {name} forward", y.detach(), want_y),
                     "grad_max_abs_err": require_equal(
                         f"STE {name} input gradient", gx, want_g),
                     "forward_launches": fwd[name], "backward_launches": 0}
    return out


def _setup_step(cfg, dev, b: int, seed: int):
    params = kwt.init_params(cfg, torch.Generator().manual_seed(seed), dev)
    batch = steps.to_device(pipeline.keyword_batch(
        seed, 0, batch=b, input_dim=cfg.input_dim, n_classes=cfg.n_classes),
        dev)
    hp = adamw.HParams(lr=1e-3, warmup_steps=2, total_steps=50)
    return params, batch, hp, ShapeSpec("chip", cfg.input_dim[1], b, "train")


def check_cuda_vs_lut_step(dev, cfg, b: int) -> dict:
    """One QAT step under ``cuda`` and one under ``lut``, from the same
    params and batch on the card: loss, every gradient and every new
    parameter ``torch.equal``."""
    params, batch, hp, shape = _setup_step(cfg, dev, b, 7)
    got = {}
    for backend in ("cuda", "lut"):
        spec = qat.QATSpec(runtime.QuantRecipe.from_config(cfg),
                           qat.QATConfig(backend=backend))
        qs = qat.init_qat_state(spec, dev)
        loss, grads = steps.value_and_grad(
            qat_train.make_qat_loss(cfg, spec), params, batch,
            qs["weight_exponent"], qs["step"] >= spec.config.start_step)
        step = steps.make_train_step(cfg, shape, hp, n_micro=1, qat=spec)
        new_p, new_opt, _, m = step(params, adamw.init(params, hp), qs, batch)
        got[backend] = (loss, grads, new_p, new_opt, m["loss"])
    (lc, gc, pc, oc, mc), (ll, gl, pl, ol, ml) = got["cuda"], got["lut"]
    require_equal(f"{cfg.name} QAT loss cuda vs lut", lc, ll)
    require_equal(f"{cfg.name} QAT step loss cuda vs lut", mc, ml)
    for what, a, b_ in (("gradient", gc, gl), ("new param", pc, pl),
                        ("new moment", oc, ol)):
        for i, (x, y) in enumerate(zip(tree_leaves(a), tree_leaves(b_))):
            require_equal(f"{cfg.name} QAT {what} {i} cuda vs lut", x, y)
    return {"loss": float(lc), "leaves_equal": len(tree_leaves(gc)),
            "equal": True}


def time_qat_steps(dev, cfg, spec, b: int, n: int) -> dict:
    """p50 ms per QAT step (forward + backward + AdamW: the host clock
    around the step and a synchronize), launches per step, and the ATen
    ops one step dispatches (backward included)."""
    params, batch, hp, shape = _setup_step(cfg, dev, b, 9)
    step = steps.make_train_step(cfg, shape, hp, n_micro=1, qat=spec)
    opt, qs = adamw.init(params, hp), qat.init_qat_state(spec, dev)
    for _ in range(2):
        params, opt, qs, _ = step(params, opt, qs, batch)
    lat, per_step = [], train_launches(cfg, 1)
    for _ in range(n):
        before = ops.launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, opt, qs, m = step(params, opt, qs, batch)
        torch.cuda.synchronize()
        lat.append((time.perf_counter() - t0) * 1e3)
        if _rise(before) != per_step:
            raise AssertionError(f"{cfg.name} QAT step launched {_rise(before)}"
                                 f", expected {per_step}")
    with CountOps() as counter:
        params, opt, qs, m = step(params, opt, qs, batch)
        torch.cuda.synchronize()
    if not bool(torch.isfinite(m["loss"])):
        raise AssertionError(f"{cfg.name}: timed QAT steps diverged")
    return {"steps": n, "p50_ms_per_step": statistics.median(lat),
            "aten_ops_per_step": counter.n, "launches_per_step": per_step}


def check_export(dev, cfg, result, tmp: str) -> dict:
    """The trained run's export on the card: QAT eval under the cuda exec
    config ``torch.equal`` to the non-executing ``lut`` engine; the
    integer-executing ``cuda`` plan within ``QAT_ENVELOPE``; the artifact
    written to disk and read back deploys bit-identically on that plan."""
    ex, spec = result.export, result.qat_spec
    rng = np.random.default_rng(11)
    x = torch.from_numpy(rng.normal(0, 1.0, (TRAIN_BATCH, *cfg.input_dim))
                         .astype(np.float32)).to(dev)
    ev = qat.eval_forward(cfg, spec, ex.recipe)(result.params, x)
    lut = runtime.compile_model(cfg, ex.params, backend="lut", recipe=ex.recipe,
                                integer_exec=False, device=dev).forward(x)
    require_equal(f"{cfg.name} QAT eval vs exported lut engine", ev, lut)
    plan = runtime.compile_model(cfg, ex.params, backend="cuda",
                                 recipe=ex.recipe, device=dev)
    served = plan.forward(x)
    envelope = max_abs_err(served, ev)
    if not envelope < QAT_ENVELOPE:
        raise AssertionError(f"{cfg.name}: cuda plan {envelope} from the QAT "
                             f"eval (envelope {QAT_ENVELOPE})")
    path = os.path.join(tmp, "artifact")
    qat_export.save(path, ex)
    recipe, qtree = qat_export.load(path, ex.qparams, device=dev)
    if recipe != ex.recipe:
        raise AssertionError(f"artifact recipe {recipe} != {ex.recipe}")
    loaded = runtime.compile_model(cfg, qtree, backend="cuda", device=dev)
    require_equal(f"{cfg.name} artifact from disk on the cuda plan",
                  loaded.forward(x), served)
    return {"eval_vs_lut_engine": "torch.equal", "cuda_plan_vs_eval": envelope,
            "envelope": QAT_ENVELOPE, "artifact_reload": "torch.equal",
            "artifact_bytes": list(ex.quantized_bytes),
            "argmax_agree_cuda_vs_eval": float(
                (served.argmax(-1) == ev.argmax(-1)).float().mean())}


def phase_train_kwt_tiny(dev, tmp: str) -> tuple:
    """KWT-Tiny trained by ``launch.train.main`` under ``--qat-backend
    cuda`` with the KWT-1 teacher: a run that fails at step 35, its
    rerun that resumes from the newest step complete in every tree (30)
    and an uninterrupted run of the same seed, whose params must be
    ``torch.equal``; then the loss, the export and the checks of both
    train phases.  Returns the line, the launches of the ``main`` runs
    (the path's), those of the checks, and the path's expected count."""
    cfg = registry.get("kwt-tiny").config
    out = {"phase": "train_kwt_tiny", "model": cfg.name,
           "n_layers": cfg.n_layers, "d_model": cfg.d_model,
           "argv": TRAIN_TINY_ARGS}
    ckpt = os.path.join(tmp, "ckpt")
    ck = ["--ckpt-dir", ckpt, "--ckpt-every", str(TRAIN_TINY_CKPT_EVERY)]
    before = ops.launch_counts()
    t0 = time.perf_counter()
    try:
        run_main(TRAIN_TINY_ARGS + ck + ["--fail-at-step",
                                         str(TRAIN_TINY_FAIL_AT)])
    except RuntimeError as err:
        if "injected failure" not in str(err):
            raise
    else:
        raise AssertionError("the run with --fail-at-step did not fail")
    resumed, log = run_main(TRAIN_TINY_ARGS + ck)
    full, _ = run_main(TRAIN_TINY_ARGS)
    path = _rise(before)
    out["seconds_three_runs"] = time.perf_counter() - t0
    want_resume = TRAIN_TINY_FAIL_AT // TRAIN_TINY_CKPT_EVERY * \
        TRAIN_TINY_CKPT_EVERY
    if resumed.resumed_from != want_resume or \
            f"[restore] resuming from step {want_resume}" not in log:
        raise AssertionError(f"resumed from {resumed.resumed_from}, expected "
                             f"{want_resume}")
    for i, (a, b) in enumerate(zip(tree_leaves(resumed.params),
                                   tree_leaves(full.params))):
        require_equal(f"resumed vs uninterrupted param {i}", a, b)
    n_steps = int(TRAIN_TINY_ARGS[TRAIN_TINY_ARGS.index("--steps") + 1])
    steps_run = TRAIN_TINY_FAIL_AT + (n_steps - want_resume) + n_steps
    expected = train_launches(cfg, steps_run)
    if path != expected:
        raise AssertionError(f"the train runs launched {path}, expected "
                             f"{expected}")
    losses = full.losses
    first, last = statistics.mean(losses[:5]), statistics.mean(losses[-5:])
    if not all(np.isfinite(losses)) or not last < first:
        raise AssertionError(f"loss: first five {first}, last five {last}")
    out.update(resumed_from=resumed.resumed_from, resume_params_equal=True,
               steps_run=steps_run, loss_first5=first, loss_last5=last,
               p50_ms_per_step_with_teacher=statistics.median(full.step_ms),
               recipe=full.export.recipe.to_dict())
    before = ops.launch_counts()
    out["export"] = check_export(dev, cfg, full, tmp)
    out.update(common_train_checks(dev, cfg, full.qat_spec))
    checks = _rise(before)
    out["launches"], out["check_launches"] = path, checks
    emit(out)
    return path, checks, expected


def common_train_checks(dev, cfg, spec_with_teacher=None) -> dict:
    """The checks both train phases make: the STE at the step's shapes,
    ``cuda`` against ``lut`` on one step, and the step's time and ATen ops
    (student alone, and with the teacher where there is one)."""
    out = {"ste": check_ste(dev, cfg, TRAIN_BATCH),
           "cuda_vs_lut_step": check_cuda_vs_lut_step(dev, cfg, TRAIN_BATCH)}
    student = qat.QATSpec(runtime.QuantRecipe.from_config(cfg),
                          qat.QATConfig(backend="cuda"))
    out["timed_student"] = time_qat_steps(dev, cfg, student, TRAIN_BATCH,
                                          TIMED_STEPS)
    if spec_with_teacher is not None:
        out["timed_with_teacher"] = time_qat_steps(
            dev, cfg, spec_with_teacher, TRAIN_BATCH, TIMED_STEPS)
    return out


def phase_train_kwt_1(dev) -> tuple:
    """KWT-1 at full width and depth on its 40x98 input, 35 classes,
    trained by ``launch.train.main`` under ``--qat-backend cuda``."""
    cfg = registry.get("kwt-1").config
    out = {"phase": "train_kwt_1", "model": cfg.name,
           "n_layers": cfg.n_layers, "d_model": cfg.d_model,
           "argv": TRAIN_KWT1_ARGS}
    before = ops.launch_counts()
    result, _ = run_main(TRAIN_KWT1_ARGS)
    path = _rise(before)
    n_steps = int(TRAIN_KWT1_ARGS[TRAIN_KWT1_ARGS.index("--steps") + 1])
    expected = train_launches(cfg, n_steps)
    if path != expected:
        raise AssertionError(f"the train run launched {path}, expected "
                             f"{expected}")
    if not all(np.isfinite(result.losses)) or len(result.losses) != n_steps:
        raise AssertionError(f"KWT-1 losses {result.losses}")
    out.update(losses=result.losses,
               p50_ms_per_step_launcher=statistics.median(result.step_ms))
    before = ops.launch_counts()
    out.update(common_train_checks(dev, cfg))
    checks = _rise(before)
    out["launches"], out["check_launches"] = path, checks
    emit(out)
    return path, checks, expected


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
    "lut_attention": ("src/repro_torch/csrc/lut_attention.cu",
                      "src/repro/kernels/lut_attention.py:98"),
}
TIMED_KEYS = ("ms", "device_ms", "plain_ms", "bound_ms", "bound_by",
              "library_ms", "library_device_ms", "bytes")
# where a row has them: the attention's bytes bound; the matmul's input
# mode and both of its library calls (or _int_mm's refusal)
EXTRA_KEYS = ("bytes_bound_ms", "input", "library_call", "int_mm_ms",
              "int_mm_device_ms", "int_mm_error", "f32_matmul_ms",
              "f32_matmul_device_ms")


def _variants(rows: list, model: str, batch: int, tag) -> list:
    out = {}
    for r in rows:
        v = out.setdefault(r["variant"], {"variant": r["variant"], "equal": True,
                                          "shapes_checked": 0, "max_abs_err": 0.0})
        v["shapes_checked"] += 1
        v["equal"] = v["equal"] and r["equal"]
        v["max_abs_err"] = max(v["max_abs_err"], r["max_abs_err"])
        if "ms" in r and r.get("model") == model and r.get("batch") == batch \
                and r.get("tag") == tag:
            v.update({k: r[k] for k in TIMED_KEYS})
            v.update({k: r[k] for k in EXTRA_KEYS if k in r})
    return list(out.values())


def kernels_line(rows: dict, launches: dict, expected: dict,
                 headline_model: str, headline_batch: int) -> dict:
    """One entry per kernel.  The headline numbers are those of the
    variant the main path runs (Q8.24 softmax, nearest GELU, the float32
    epilogue at the MLP's first linear, LUT attention) at
    ``headline_model`` / ``headline_batch``; ``variants`` sums up every
    checked variant (all shapes, ragged ones included) with its own
    headline times where it was timed.  ``launches`` is the sum over the
    main paths, ``launches_by_path`` each path's own count, which must be
    ``expected[path]``; every kernel must be launched by some path (the
    train path launches neither the matmul nor the attention).  The
    ``kernels`` phase line above holds every row."""
    for path, counts in launches.items():
        if counts != expected[path]:
            raise AssertionError(f"the {path} path launched {counts}, "
                                 f"expected {expected[path]}")
    main_variant = {"lut_softmax": lambda r: r["variant"] == "fixed",
                    "lut_gelu": lambda r: r["variant"] == "nearest",
                    # the int8 plans' input: the float activation
                    "int8_matmul": lambda r: r.get("tag") == "w1"
                    and r["variant"] == "f32 int8 residual16 float-x",
                    "lut_attention": lambda r: r["variant"] == "lut"}
    entries = []
    for name, (source, replaces) in SOURCES.items():
        head = next(r for r in rows[name]
                    if r.get("model") == headline_model
                    and r.get("batch") == headline_batch
                    and main_variant[name](r))
        by_path = {path: counts[name] for path, counts in launches.items()}
        if sum(by_path.values()) <= 0:
            raise AssertionError(f"no main path launched {name}: {by_path}")
        entries.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": sum(by_path.values()),
            "launches_by_path": by_path,
            "max_abs_err": max(r["max_abs_err"] for r in rows[name]),
            "ms": head["ms"], "device_ms": head["device_ms"],
            "plain_ms": head["plain_ms"],
            "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
            "library_ms": head["library_ms"],
            "library_device_ms": head["library_device_ms"],
            **{k: head[k] for k in EXTRA_KEYS if k in head},
            "shape": head.get("shape", head.get("shape_mkn",
                                                head.get("shape_bhhlld"))),
            "model": headline_model, "batch": headline_batch,
            "equal": all(r["equal"] for r in rows[name]),
            "variants": _variants(rows[name], headline_model, headline_batch,
                                  head.get("tag"))})
    return {"kernels": entries}


def main() -> None:
    info = phase_device()
    dev = torch.device("cuda")
    phase_build()
    tiny, kwt1 = registry.get("kwt-tiny").config, registry.get("kwt-1").config
    rows = phase_kernels(dev, (tiny, kwt1))

    # The main paths.  Every count goes to 0 just before each and is read
    # just after it: launches made above to compare kernels do not count.
    launches, expected = {}, {}
    ops.reset_launch_counts()
    serve = [phase_serve("kwt-tiny", dev, (1, 8, 64, 4096),
                         [("int8 (Table V)", None, "xla"),
                          ("int8 (Table V)", None, "flash_lut")], requests=5),
             phase_serve("kwt-1", dev, (1, 64),
                         [("int8 (Table V defaults)", None, "xla"),
                          ("int4 per-channel", dict(bits=4, weight_exponent=4,
                                                    per_channel=True), "xla"),
                          ("int8 (Table V defaults)", None, "flash_lut")])]
    launches["serve"] = ops.launch_counts()
    expected["serve"] = {n: sum(e[n] for e in serve) for n in serve[0]}
    ops.reset_launch_counts()
    runs = [phase_stream("kwt-tiny", dev, lanes=64, hops=64, reset_at=30),
            phase_stream("kwt-1", dev, lanes=64, hops=216, reset_at=104)]
    counted = ops.launch_counts()
    # the stream path's own launches: what the counters read less what the
    # check forwards added, which must be what its stream_step calls added
    launches["stream"] = {n: counted[n] - sum(c[n] for _, c, _ in runs)
                          for n in counted}
    expected["stream"] = {n: sum(e[n] for _, _, e in runs) for n in counted}
    steps_rose = {n: sum(s[n] for s, _, _ in runs) for n in counted}
    if launches["stream"] != steps_rose:
        raise AssertionError(f"stream launches {launches['stream']} are not "
                             f"those of its steps, {steps_rose}")
    # the cell path: the lanes' hops (the launcher's, and the KWT-1 cell's
    # three lane sets and its profiled joint and pipelined hops), less the launches of the KWT-1 phase's checks
    # (hot-swap's warm and probe forwards, the refused artifact's, the taps
    # plan's and its untapped comparison)
    ops.reset_launch_counts()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_cell_",
                                     dir=build.build_dir()) as tmp:
        tiny_rose, tiny_expected = phase_cell_kwt_tiny(dev, tmp)
        k1_rose, k1_checks, k1_expected = phase_cell_kwt_1(dev, tmp)
    counted = ops.launch_counts()
    launches["cell"] = {n: counted[n] - k1_checks[n] for n in counted}
    expected["cell"] = {n: tiny_expected[n] + k1_expected[n] for n in counted}
    lanes_rose = {n: tiny_rose[n] + k1_rose[n] for n in counted}
    if launches["cell"] != lanes_rose:
        raise AssertionError(f"cell launches {launches['cell']} are not those "
                             f"of its hops, {lanes_rose}")
    # the train path: the launcher's runs, less the launches of the checks
    # each train phase makes after them
    ops.reset_launch_counts()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_train_",
                                     dir=build.build_dir()) as tmp:
        runs = [phase_train_kwt_tiny(dev, tmp), phase_train_kwt_1(dev)]
    counted = ops.launch_counts()
    launches["train"] = {n: counted[n] - sum(c[n] for _, c, _ in runs)
                         for n in counted}
    expected["train"] = {n: sum(e[n] for _, _, e in runs) for n in counted}
    runs_rose = {n: sum(p[n] for p, _, _ in runs) for n in counted}
    if launches["train"] != runs_rose:
        raise AssertionError(f"train launches {launches['train']} are not "
                             f"those of its runs, {runs_rose}")

    emit(kernels_line(rows, launches, expected, "kwt-1", 64))
    print(info["nvidia_smi"], flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
