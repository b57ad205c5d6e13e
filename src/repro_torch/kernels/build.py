"""Compile ``csrc/*.cu`` with ``nvcc`` and load the result with ``ctypes``.

One ``nvcc -c`` per source, all started together, then one link into
``build/repro_torch/libkernels.so``.  The sources expose plain C entry
points (no PyTorch headers, so a source compiles in seconds): pointers
come from ``tensor.data_ptr()``, the stream from
``torch.cuda.current_stream().cuda_stream``.  Each entry point launches on
that stream, does not synchronise, allocates nothing and returns
``cudaGetLastError()``; :func:`check` raises when that is not 0.

The build happens at the first kernel launch, never at import.  It is
redone when a source or a flag changed (a hash of both is kept beside the
library).  A failed build raises with the compiler's output; nothing
falls back to a plain version.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC")

_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
# entry point -> argument types (every pointer and the stream are c_void_p:
# ctypes would otherwise pass a Python int as a 32-bit int and cut it)
SIGNATURES = {
    # x, exp_tab, inv_tab, out, m, n, stream
    "lut_softmax_fixed_launch": (_P, _P, _P, _P, _I, _I, _P),
    # x, exp_tab, out, m, n, stream
    "lut_softmax_float_launch": (_P, _P, _P, _I, _I, _P),
    # n, aligned -> rows per slab, 0 for the global path (a report)
    "lut_softmax_slab_rows": (_I, _I),
    # x, tab, out, numel, mode (2 * bf16 + interp), stream
    "lut_gelu_launch": (_P, _P, _P, _L, _I, _P),
    # x, w, out, axis, m, k, n, shift, mode (clip16 | out_mode << 1 |
    # x_f32 << 3 | w_int4 << 4 | x_bits << 8), out_exp, x_exp, stream
    "int8_matmul_launch": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P),
    # q, k, v, exp_tab, out, b, hq, hkv, lq, lk, d, block_k, causal, use_lut,
    # is_bf16, scale, then the (batch, head, row) strides of q, k, v and out,
    # stream
    "lut_attention_launch": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                             _I, _I, _I, _F) + (_I,) * 12 + (_P,),
    # the launchers' geometry for the same arguments, into out4 = grid,
    # threads, dynamic shared memory, variant (analysis.geometry):
    # x, out, m, n, fixed, out4
    "lut_softmax_geometry": (_P, _P, _I, _I, _I, _P),
    # x, out, numel, mode, out4
    "lut_gelu_geometry": (_P, _P, _L, _I, _P),
    # x, w, out, m, k, n, mode, out4
    "int8_matmul_geometry": (_P, _P, _P, _I, _I, _I, _I, _P),
    # b, hq, hkv, lq, lk, d, block_k, out4
    "lut_attention_geometry": (_I,) * 7 + (_P,),
    # b, hq, hkv, lq, lk, d, block_k, causal, out3: the wide kernel's
    # (item, key tile) steps walked, of a full walk, of the busiest block
    "lut_attention_wide_steps": (_I,) * 8 + (_P,),
    # blocks an SM holds, as each launcher asks it: g, vpl, fixed
    "lut_softmax_occupancy": (_I, _I, _I),
    # kloop, qf, bytes
    "int8_matmul_occupancy": (_I, _I, _L),
    # dt, nt, threads, bytes
    "lut_attention_occupancy": (_I, _I, _I, _L),
}

_lock = threading.Lock()
_lib = None
build_seconds: float | None = None   # wall time of the build this process did


def build_dir() -> Path:
    """``build/repro_torch`` at the root of the checkout (the directory
    that holds ``src/``)."""
    return Path(__file__).resolve().parents[3] / "build" / "repro_torch"


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH"),
                 "/usr/local/cuda"):
        if root and (Path(root) / "bin" / "nvcc").exists():
            return str(Path(root) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels of repro_torch are "
                       "compiled from source and need the CUDA toolkit")


def sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def _digest(srcs) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for s in list(srcs) + sorted(CSRC.glob("*.cuh")):
        h.update(s.name.encode())
        h.update(s.read_bytes())
    return h.hexdigest()


def _compile(out: Path, srcs) -> None:
    nvcc = _nvcc()
    out.mkdir(parents=True, exist_ok=True)
    procs = []
    for s in srcs:
        obj = out / (s.stem + ".o")
        cmd = [nvcc, *NVCC_FLAGS, "-Xptxas", "-v", "-c", str(s), "-o", str(obj)]
        procs.append((cmd, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    log, failed = [], []
    for cmd, obj, p in procs:
        text, _ = p.communicate()
        log.append("$ " + " ".join(cmd) + "\n" + text)
        if p.returncode != 0:
            failed.append(obj.name)
    (out / "build.log").write_text("\n".join(log))
    if failed:
        raise RuntimeError("nvcc failed for " + ", ".join(failed) + ":\n"
                           + "\n".join(log))
    link = [nvcc, "-shared", "-o", str(out / "libkernels.so"),
            *[str(obj) for _, obj, _ in procs]]
    r = subprocess.run(link, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                       text=True)
    if r.returncode != 0:
        raise RuntimeError("linking libkernels.so failed:\n" + r.stdout)


def load() -> ctypes.CDLL:
    """The loaded kernel library, building it first when needed."""
    global _lib, build_seconds
    if _lib is not None:
        return _lib
    with _lock:
        if _lib is not None:
            return _lib
        srcs = sources()
        if not srcs:
            raise RuntimeError(f"no CUDA sources under {CSRC}")
        out = build_dir()
        so, stamp = out / "libkernels.so", out / "sources.sha256"
        digest = _digest(srcs)
        if not (so.exists() and stamp.exists()
                and stamp.read_text() == digest):
            t0 = time.perf_counter()
            _compile(out, srcs)
            stamp.write_text(digest)
            build_seconds = time.perf_counter() - t0
        lib = ctypes.CDLL(str(so))
        for name, argtypes in SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = list(argtypes)
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def check(code: int, what: str) -> None:
    """Raise when an entry point reported a refused launch."""
    if code != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with error {code}")
