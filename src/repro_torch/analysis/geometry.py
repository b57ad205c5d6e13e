"""CUDA launch geometry pass: each kernel launch's grid, threads and
shared memory against the H100's limits, before the launch.

The reference validates Pallas block shapes against a TPU core's VMEM.
The port's kernels choose their geometry on the host, in their C
launchers (``csrc/*.cu``): the softmax's slab or global path and rows a
slab, the GELU's vector split, the int8 matmul's columns a block and
shared-memory stages, the attention's warps a block and K/V stages.  So
every kernel charge of a forward (``op_walk``) carries its launch's
arguments, and this pass asks what geometry the launcher would choose
for them — on a CUDA plan the launcher's own C geometry query, on the
CPU its Python mirror (each wrapper's ``geometry``) — then checks it
against what an sm_90 card allows:

  * at most 1024 threads a block;
  * at most 232 448 B (227 KB) of dynamic shared memory a block, above
    48 KB only after ``cudaFuncSetAttribute`` raised the kernel's limit
    (the int8 matmul and the attention launchers do; the softmax slab
    path and the GELU stay below);
  * a grid of at least one block, and at most 2^31 - 1 (x) — the port's
    grids are 1-D, so y and z are 1, within 65 535;
  * a launcher that refuses its arguments (a nonzero return code of its
    query) is a violation too.

Each C launcher has a geometry query that runs the launcher's own host
code and returns before the launch (``lut_softmax_geometry`` and its
siblings).  The grid depends on how many blocks an SM holds, which the
card answers (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``); the
mirror, on the CPU, uses :func:`h100_occupancy`, a model of the H100
(132 SMs; threads, shared memory and, for the attention, its 255
registers a thread).  ``chip_smoke.py`` holds the mirror, with the
card's occupancy, equal to the C query at the launches it logs
(:func:`check_launch_log`), and a plan's geometry on the CPU equal to
the same plan's on the card.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.analysis import op_walk as ow
from repro_torch.analysis.report import Finding, PassResult

MAX_THREADS = 1024
MAX_SMEM = 232448              # bytes a block may opt into on sm_90
DEFAULT_SMEM = 48 * 1024       # without cudaFuncSetAttribute
MAX_GRID_X = 2 ** 31 - 1
H100_SMS = 132
# the opt-in each launcher makes (cudaFuncSetAttribute): the kernels that
# may use more than 48 KB
_OPTS_IN = {"int8_matmul": True, "lut_attention": True,
            "lut_softmax": False, "lut_gelu": False}

# an SM of the H100 (sm_90): threads, shared memory (228 KB, 1 KB of it
# reserved a block), blocks, registers
_SM_THREADS, _SM_SMEM, _SM_BLOCKS, _SM_REGS = 2048, 233472, 32, 65536
# registers a thread where the kernel's launch bounds fix them
# (csrc/lut_attention.cu: one block an SM, all 255 registers, at every
# depth)
_REGS = {"lut_attention": 255}


def h100_occupancy(key, threads: int, smem: int) -> int:
    """A model of the blocks an H100 SM holds of the kernel ``key`` (its
    first item the kernel's name) at ``threads`` threads and ``smem``
    bytes: the smallest of the SM's thread, shared-memory, block and —
    where the kernel's register count is fixed — register limits."""
    fit = min(_SM_BLOCKS, _SM_THREADS // threads,
              _SM_SMEM // (smem + 1024))
    regs = _REGS.get(key[0])
    if regs is not None:
        per_warp = -(-regs * 32 // 256) * 256
        fit = min(fit, _SM_REGS // (per_warp * -(-threads // 32)))
    return fit


def _module(kernel: str):
    from repro_torch.kernels import ops
    return ops._KERNEL_MODULES[kernel]


def card_occupancy(key, threads: int, smem: int) -> int:
    """The card's answer, from the kernel's C occupancy query."""
    from repro_torch.kernels import build
    lib = build.load()
    if key[0] == "lut_softmax":
        return lib.lut_softmax_occupancy(key[1], key[2], key[3])
    if key[0] == "int8_matmul":
        return lib.int8_matmul_occupancy(key[1], key[2], smem)
    return lib.lut_attention_occupancy(key[1], key[2], threads, smem)


def device_model(device) -> tuple:
    """``(SMs, occupancy)`` the mirror uses for a plan on ``device``."""
    device = torch.device(device)
    if device.type == "cuda":
        props = torch.cuda.get_device_properties(device)
        return props.multi_processor_count, card_occupancy
    return H100_SMS, h100_occupancy


def mirror(kernel: str, args: tuple, device) -> tuple:
    """``(code, (grid, threads, smem, variant))`` the launcher of
    ``kernel`` would choose for its geometry query's ``args``."""
    sms, occ = device_model(device)
    return _module(kernel).geometry(*args, sms=sms, occupancy=occ)


def c_query(kernel: str, args: tuple) -> tuple:
    """The same from the kernel's C geometry query (on the card)."""
    from repro_torch.kernels import build
    out = (ctypes.c_longlong * 4)()
    code = getattr(build.load(), kernel + "_geometry")(*args, out)
    return code, tuple(int(v) for v in out)


def c_wide_steps(args: tuple) -> dict:
    """The wide attention kernel's (item, key tile) steps at
    ``lut_attention_wide_steps``' arguments ``(b, hq, hkv, lq, lk, d,
    block_k, causal)``, walked on the host by the kernel's own item order
    (on the card): ``walked``, ``full`` (every tile) and ``busiest``."""
    from repro_torch.kernels import build
    out = (ctypes.c_longlong * 3)()
    code = build.load().lut_attention_wide_steps(*args, out)
    build.check(code, "lut_attention_wide_steps")
    return dict(zip(("walked", "full", "busiest"), (int(v) for v in out)))


def _al(ptr) -> int:
    """An address by what the launchers read of it: its offset into a
    16-byte unit (none needs more)."""
    return (ptr or 0) % 16


# the launch entry points -> (kernel, their geometry query's arguments)
def _query_args(entry: str, args: tuple) -> tuple:
    if entry == "lut_softmax_fixed_launch":
        return "lut_softmax", (_al(args[0]), _al(args[3]), args[4], args[5], 1)
    if entry == "lut_softmax_float_launch":
        return "lut_softmax", (_al(args[0]), _al(args[2]), args[3], args[4], 0)
    if entry == "lut_gelu_launch":
        return "lut_gelu", (_al(args[0]), _al(args[2]), args[3], args[4])
    if entry == "int8_matmul_launch":
        return "int8_matmul", tuple(map(_al, args[0:3])) + tuple(args[4:7]) \
            + (args[8],)
    if entry == "lut_attention_launch":
        return "lut_attention", tuple(args[5:12])
    raise KeyError(entry)


def check_launch_log(log, device) -> dict:
    """Hold the Python mirror equal to each kernel's C geometry query at
    every launch of ``log`` (``kernels._launch.LOG``), on the card; the
    launches are told apart by their shapes and their addresses'
    alignment.  Returns ``{kernel: {"shapes": n, "mismatches": [...]}}``."""
    out = {}
    for kernel, qargs in sorted({_query_args(e, a) for e, a in log}):
        row = out.setdefault(kernel, {"shapes": 0, "mismatches": []})
        row["shapes"] += 1
        want = c_query(kernel, qargs)
        got = mirror(kernel, qargs, device)
        if got != want:
            row["mismatches"].append({"args": list(qargs), "c": want,
                                      "mirror": got})
    return out


def launch_geometry(rec, device) -> tuple:
    """``(kernel, code, (grid, threads, smem, variant))`` of a charge: the
    launcher's C query on the card, its Python mirror on the CPU."""
    kernel, args = rec.launch
    if torch.device(device).type == "cuda":
        code, geo = c_query(kernel, args)
    else:
        code, geo = mirror(kernel, args, device)
    return kernel, code, geo


def _violations(kernel: str, code: int, geo: tuple) -> list:
    grid, threads, smem, _ = geo
    bad = []
    if code:
        bad.append(("refused-launch",
                    f"the launcher refuses these arguments (code {code})"))
        return bad
    if grid <= 0:
        bad.append(("empty-grid", f"grid {grid} is not positive"))
    if grid > MAX_GRID_X:
        bad.append(("grid-overflow", f"grid {grid} exceeds {MAX_GRID_X}"))
    if not 0 < threads <= MAX_THREADS:
        bad.append(("threads", f"{threads} threads a block (1..{MAX_THREADS})"))
    cap = MAX_SMEM if _OPTS_IN[kernel] else DEFAULT_SMEM
    if smem > cap:
        bad.append(("smem-overflow",
                    f"{smem} B of shared memory a block exceeds {cap} B"
                    + ("" if _OPTS_IN[kernel] else
                       " (the launcher does not opt in above 48 KB)")))
    return bad


def check_geometry(engine, x) -> PassResult:
    """Walk the forward and vet every kernel launch's geometry."""
    findings = []
    metrics = {"kernels": 0, "max_threads": 0, "max_smem_bytes": 0}
    cfg = engine.exec_cfg
    w = ow.walk(lambda p, xx: engine._mod.forward(p, xx, cfg),
                engine.params, x, declared=(x,))
    rows = {}
    for rec in w.records:
        if rec.launch is None:
            continue
        metrics["kernels"] += 1
        kernel, code, geo = launch_geometry(rec, engine.device)
        for kind, text in _violations(kernel, code, geo):
            findings.append(Finding("violation", kind, f"{kernel}: {text}",
                                    ow.user_site(rec)))
        if not code:
            metrics["max_threads"] = max(metrics["max_threads"], geo[1])
            metrics["max_smem_bytes"] = max(metrics["max_smem_bytes"], geo[2])
        key = (kernel, geo)
        rows[key] = rows.get(key, 0) + 1
    for (kernel, (grid, threads, smem, variant)), n in rows.items():
        findings.append(Finding(
            "info", "kernel-geometry",
            f"{kernel} x{n}: grid {grid}, {threads} threads, {smem} B "
            f"shared memory of {MAX_SMEM} B, variant {variant}"))
    if metrics["kernels"] == 0:
        findings.append(Finding(
            "info", "scope",
            f"plan {engine.backend_name!r} launches no CUDA kernels"))
    return PassResult("geometry", findings, metrics)
