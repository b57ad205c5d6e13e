#!/usr/bin/env python3
"""The wide flash-LUT attention (128 < D <= 256) alone on the card.

    python3 tools/attention_wide_check.py [--root DIR] [--timed-only]
                                          [--against DIR] [--out FILE]

Builds the kernels of the checkout at ``--root`` (default: this one),
prints ptxas' registers and spills of each wide instance, holds the
kernel to its plain version at every wide edge row of that checkout's
``chip_smoke.nemotron_edge_cases`` (the tight terms, the oracle, rows
that see no key; ``--timed-only`` skips them) and times nemotron-4-340b's
causal GQA ``(2, 96(8), 1024, 192)`` on strided views, float32 and bf16,
beside SDPA.  It uses the checkout's own ``chip_smoke.check_attention``,
so two checkouts timed in one call on one card (``--root`` of each, in
turns) are compared with their own code.  ``--against DIR`` builds the
attention sources of another checkout into a library of its own and runs
both kernels on the same seeded inputs through this checkout's wrapper
(float32, LUT): each one's share of outputs within 1e-5 of the tiled
plain version and its largest error against it, and the largest
difference between the two.  One JSON line a row; the last line is
``{"ok": true, ...}``.  Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from pathlib import Path


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[1]))
    ap.add_argument("--timed-only", action="store_true",
                    help="skip the edge shapes")
    ap.add_argument("--against", default=None,
                    help="another checkout whose attention kernel runs on "
                         "the same inputs")
    ap.add_argument("--out", default=None, help="also append the lines here")
    args = ap.parse_args(argv)
    root = Path(args.root).resolve()
    sys.path[:0] = [str(root), str(root / "src")]
    if args.out:     # chip_smoke's own lines (the build's) go there too
        os.environ["CHIP_SMOKE_OUT"] = str(Path(args.out).resolve())
    import torch
    import chip_smoke as cs

    def emit(obj):
        line = json.dumps(obj)
        print(line, flush=True)
        if args.out:
            with open(os.environ["CHIP_SMOKE_OUT"], "a") as fh:
                fh.write(line + "\n")

    info = cs.phase_device()
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    cs.phase_build()
    emit({"root": str(root), "build_s": time.perf_counter() - t0})
    gen = torch.Generator(device=dev).manual_seed(0)
    if not args.timed_only:
        t0 = time.perf_counter()
        n = 0
        for shape, causal, lut, dt, strided in cs.nemotron_edge_cases():
            emit({"edge": cs.check_attention(dev, gen, shape, causal, lut,
                                             dtype=dt, strided=strided)})
            n += 1
        emit({"edges": n, "seconds": time.perf_counter() - t0})
    if args.against:
        against(cs, dev, Path(args.against).resolve(), emit)
    shape = (2, 96, 8, 1024, 1024, 192)
    for dt in (torch.float32, torch.bfloat16):
        r = cs.check_attention(dev, gen, shape, True, True, dtype=dt,
                               timed=True, strided=True)
        emit({"nemotron": r})
    print(info["nvidia_smi"], flush=True)
    emit({"ok": True, "device": torch.cuda.get_device_name(0)})


# (shape (b, hq, hkv, lq, lk, d), causal, seeds) of the comparison
AGAINST = [((16, 8, 2, 1, 256, 200), True, 20),
           ((16, 8, 2, 1, 256, 192), False, 20),
           ((2, 4, 2, 64, 256, 256), True, 10),
           ((2, 96, 8, 1024, 1024, 192), True, 16)]


def against(cs, dev, other: Path, emit) -> None:
    """The checkout's kernel and ``other``'s, both through this checkout's
    wrapper (``other``'s attention sources built here into a library of
    their own, which the wrapper's launch state takes in turn), on the
    same inputs."""
    import ctypes
    import subprocess
    import torch
    from repro_torch.kernels import _launch, build, ops, ref
    src = other / "src" / "repro_torch" / "csrc"
    lib_path = build.build_dir() / "against" / "libattention.so"
    lib_path.parent.mkdir(parents=True, exist_ok=True)
    cmd = [build._nvcc(), *build.NVCC_FLAGS, "-shared",
           str(src / "lut_attention.cu"), str(src / "lut_attention_wide.cu"),
           "-o", str(lib_path)]
    r = subprocess.run(cmd, capture_output=True, text=True)
    if r.returncode:
        raise RuntimeError(f"building {src} failed:\n{r.stdout}{r.stderr}")
    theirs = ctypes.CDLL(str(lib_path))
    theirs.lut_attention_launch.argtypes = list(
        build.SIGNATURES["lut_attention_launch"])
    st = _launch.state(dev.index or 0)
    ours = st.lib

    def run(lib, q, k, v, causal):
        st.lib = lib
        try:
            return ops.lut_attention(q, k, v, causal=causal)
        finally:
            st.lib = ours

    for (b, hq, hkv, lq, lk, d), causal, seeds in AGAINST:
        shares, errs = ([], []), ([], [])
        diff = 0.0
        for seed in range(seeds):
            g = torch.Generator(device=dev).manual_seed(1000 + seed)
            q = torch.randn((b, hq, lq, d), generator=g, device=dev)
            k, v = (torch.randn((b, hkv, lk, d), generator=g, device=dev)
                    for _ in range(2))
            want = ref.lut_attention_tiled(
                q, k, v, causal=causal, use_lut=True,
                block_k=ops.fit_block(lk, ops.ATTN_BLOCK_K))
            outs = [run(lib, q, k, v, causal) for lib in (ours, theirs)]
            for out, share, err in zip(outs, shares, errs):
                share.append(float(((out.double() - want.double()).abs()
                                    <= 1e-5).double().mean()))
                err.append(cs.max_abs_err(out, want))
            diff = max(diff, cs.max_abs_err(*outs))
        emit({"against": str(other), "shape": [b, hq, hkv, lq, lk, d],
              "causal": causal, "share_ours": shares[0],
              "share_theirs": shares[1], "err_ours": errs[0],
              "err_theirs": errs[1], "max_abs_diff": diff})


if __name__ == "__main__":
    main()
