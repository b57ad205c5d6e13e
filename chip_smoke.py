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

The serve phases (4, 5) and the stream phases (6, 7) are the main paths:
the counters go to 0 just before each pair and are read just after it;
the launches of the stream phases' check forwards are taken out of the
stream path's count, which must then equal what its steps launched.
Any failing phase lets its exception out (non-zero exit); nothing falls
back to the CPU.  Each phase prints one JSON line; the line before the
last is ``{"kernels": [...]}`` with, per kernel, its launches on the main
paths, its error against the plain version and its times; the last line
is ``{"ok": true, "device": {...}}``.

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
from repro_torch.stream import engine as stream  # noqa: E402
from repro_torch.stream import features  # noqa: E402

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
    emit(out)
    return out


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
        out["plans"].append({
            "attention": attention, "describe": eng.describe(),
            "steps": step, "first_warm_hop": first_warm,
            "warm_steps_checked_equal": checked,
            "p50_ms_per_step": statistics.median(lat),
            "p50_rtf": statistics.median(rtf),
            "p50_ms_by_chunk": {k: statistics.median(
                [m for m, kk in zip(lat, ks) if kk == k]) for k in STREAM_CHUNKS},
            "launches_per_step": per_hop,
            "frames_vs_offline_mfcc": {
                "max_abs": max_abs_err(frames, off),
                "equal": bool(torch.equal(frames, off))}})
    out["launches"] = steps_rose
    out["check_forward_launches"] = checks_rose
    emit(out)
    return steps_rose, checks_rose


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


def kernels_line(rows: dict, launches: dict, headline_model: str,
                 headline_batch: int) -> dict:
    """One entry per kernel.  The headline numbers are those of the
    variant the main path runs (Q8.24 softmax, nearest GELU, the float32
    epilogue at the MLP's first linear, LUT attention) at
    ``headline_model`` / ``headline_batch``; ``variants`` sums up every
    checked variant (all shapes, ragged ones included) with its own
    headline times where it was timed.  ``launches`` is the sum over the
    main paths, ``launches_by_path`` each path's own count.  The
    ``kernels`` phase line above holds every row."""
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
        if min(by_path.values()) <= 0:
            raise AssertionError(f"a main path launched {name} no time: "
                                 f"{by_path}")
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
    launches = {}
    ops.reset_launch_counts()
    phase_serve("kwt-tiny", dev, (1, 8, 64, 4096),
                [("int8 (Table V)", None, "xla"),
                 ("int8 (Table V)", None, "flash_lut")], requests=5)
    phase_serve("kwt-1", dev, (1, 64),
                [("int8 (Table V defaults)", None, "xla"),
                 ("int4 per-channel", dict(bits=4, weight_exponent=4,
                                           per_channel=True), "xla"),
                 ("int8 (Table V defaults)", None, "flash_lut")])
    launches["serve"] = ops.launch_counts()
    ops.reset_launch_counts()
    runs = [phase_stream("kwt-tiny", dev, lanes=64, hops=64, reset_at=30),
            phase_stream("kwt-1", dev, lanes=64, hops=216, reset_at=104)]
    counted = ops.launch_counts()
    # the stream path's own launches: what the counters read less what the
    # check forwards added, which must be what its stream_step calls added
    launches["stream"] = {n: counted[n] - sum(c[n] for _, c in runs)
                          for n in counted}
    steps = {n: sum(s[n] for s, _ in runs) for n in counted}
    if launches["stream"] != steps:
        raise AssertionError(f"stream launches {launches['stream']} are not "
                             f"those of its steps, {steps}")

    emit(kernels_line(rows, launches, "kwt-1", 64))
    print(info["nvidia_smi"], flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
