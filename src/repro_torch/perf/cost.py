"""Static cost model: FLOPs / bytes moved per named stage of an Engine plan.

The paper's headline result is a cost ledger — per-op clock cycles
(Figs 3-5, Table IX) pinning GELU/SoftMax as the 26M-cycle inference's
hot spots and auditing the 5x win down to 5.5M cycles.  This module is
the port's analogue at ATen-op granularity: it runs an Engine program
once under the op recorder (:mod:`repro_torch.analysis.op_walk`) and
accumulates, per recorded op,

* **flops** — 2*M*N*K for ``mm``/``bmm``/``addmm``/``baddbmm``/
  ``_int_mm`` (``einsum`` is seen through the ops it dispatches to; a
  pair of its operands that sums no index, a ``mul`` here, is priced as
  the reference's ``dot_general`` of depth 1: 2 per output element),
  output size for element-wise math, input size for reductions,
  ``5*n*log2(n)`` per row for ``_fft_r2c``, none for ``square`` (the
  reference prices its ``square`` primitive as traffic only); layout
  ops (view, reshape, permute, expand, slice, a ``clone`` of a view, a
  same-dtype ``_to_copy``) and allocations are free, and are not counted in a
  line's ``eqns`` (a cached constant made on the first walk only would
  otherwise change the count);
* **bytes moved** — operand + result buffer bytes of every other op (a
  flat-memory traffic model: each operand is read once, each result
  written once);
* **arithmetic intensity** — flops / bytes, the roofline x-axis.

A composite ATen op that one ``jnp`` call of the reference decomposes
into several equations (``mean``, ``var``, ``var_mean``, ``_softmax``,
``gelu``, ``native_layer_norm``) is priced as the
reference's decomposition counts it (:data:`_COMPOSITE`), so the two
models agree op class by op class.

Hand-written kernels are priced by what they compute, not by what runs
them: each wrapper of ``kernels.ops`` reports one charge (its op class,
operations and bytes: :func:`softmax_charge`, :func:`gelu_charge`,
:func:`matmul_charge`, :func:`attention_charge`) and the recorder ignores
the ATen ops below it, so a ``cuda`` plan prices the same on the CPU,
where the wrappers take their plain versions, and on the card.  The
reference charges its Pallas kernels per grid step over their padded
blocks; the port's kernels mask their ragged edges and are charged no
padding.  Likewise a row-blocked product (``core.rowwise``) is priced as
the one product it stands for.

Each op is attributed to a **stage** (``unpack`` / ``featurise`` /
``embed`` / ``encode`` / ``detector`` — from the recorded repo frames)
and an **op class** (``matmul`` / ``softmax`` / ``gelu`` / ``norm`` /
``fft`` / ``requant`` / ``other``), so the table reads like the paper's:
one row per (stage, op), with an estimated-cycles column once a
:class:`repro_torch.perf.roofline.MachineModel` prices it.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch

from repro_torch.analysis import op_walk as ow

# -- kernel charges -----------------------------------------------------------

# arithmetic per element, counted from the first kernel sources (two
# passes of the exp lookup, the limb multiply, the max and the sum for the
# softmax); the slab softmax looks each exp up once, but the count is kept
# so that every bound stays comparable with the earlier ones
SOFTMAX_OPS_PER_ELEM = {True: 40, False: 20}      # fixed, float
GELU_OPS_PER_ELEM = {False: 8, True: 14}          # nearest, interp
EXP_LUT_BYTES = 4 * 320                           # one float32 table
SOFTMAX_LUT_BYTES = 2 * EXP_LUT_BYTES             # exp + reciprocal
GELU_LUT_BYTES = 4 * 32


def softmax_charge(x: torch.Tensor, fixed: bool) -> tuple:
    return (("softmax", SOFTMAX_OPS_PER_ELEM[fixed] * x.numel(),
             2 * 4 * x.numel() + SOFTMAX_LUT_BYTES),)


def gelu_charge(x: torch.Tensor, interp: bool) -> tuple:
    return (("gelu", GELU_OPS_PER_ELEM[interp] * x.numel(),
             2 * ow.tensor_bytes(x) + GELU_LUT_BYTES),)


def matmul_charge(m: int, k: int, n: int, in_bytes: int,
                  out_bytes: int) -> tuple:
    return (("matmul", 2 * m * k * n, in_bytes + out_bytes),)


def attention_charge(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor
                     ) -> tuple:
    """Both products, 4*B*H*Lq*Lk*D (q, k, v read once, the output written
    once), plus the online softmax's B*H*Lq*Lk elements."""
    b, h, lq, d = q.shape
    lk = k.shape[2]
    nbytes = 2 * ow.tensor_bytes(q) + ow.tensor_bytes(k) \
        + ow.tensor_bytes(v) + EXP_LUT_BYTES
    return (("matmul", 4 * b * h * lq * lk * d, nbytes),
            ("softmax", SOFTMAX_OPS_PER_ELEM[False] * b * h * lq * lk, 0))


# -- op classification --------------------------------------------------------

# op class by recorded frame function name (innermost frame wins)
_OP_BY_FUNC = {
    "softmax": ("softmax_exact", "softmax_lut", "fixed_softmax",
                "masked_softmax", "softmax", "_pre_shift", "lut_softmax",
                "_softmax_kernel"),
    "gelu": ("gelu_exact", "gelu_lut", "gelu", "lut_gelu", "silu",
             "silu_exact", "sigmoid_lut", "softplus", "sqrelu",
             "_gelu_kernel", "activation"),
    "norm": ("apply_norm", "_rms"),
    "fft": ("_frame_features", "mfcc"),
    # integer-execution epilogue/prologue work (quant.int_exec_einsum):
    # activation quantise, container moves, per-channel requant, row
    # gather-descale — everything around the integer GEMM itself (the
    # product still classifies as matmul by op fallback)
    "requant": ("quantize_act", "requant", "int_container",
                "gather_descale"),
    # an elementwise multiply-add chain (quant.matmul_unrolled): still the
    # linear algebra, priced as MACs in program_cost so matmul_flops stays
    # 2*M*N*K, as for the product it equals (int_exec_einsum does not
    # route through it: ROADMAP C13)
    "matmul": ("matmul_unrolled",),
}
_OP_OF_FUNC = {fn: op for op, fns in _OP_BY_FUNC.items() for fn in fns}

# stage by frame function name, scanned innermost -> outermost.  Names
# are qualified, as the reference's frames carry them under jax 0.9: the
# method ``QTensor.dequantize`` matches no entry, so a resident leaf's
# float view taken inside the model (the positional table of an
# integer-executing plan) stays in the stage that consumes it
_STAGE_BY_FUNC = {
    "embed_frames": "embed",
    "encode_window": "encode",
    "dequantize_tree": "unpack",
    "unpack_po2": "unpack",
    "unpack_payload": "unpack",
}

# stage by the repo file the innermost frame lives in (when no function
# matches); a row-blocked product (core/rowwise.py) stands for its caller
_STAGE_BY_FILE = {
    "features.py": "featurise",
    "detector.py": "detector",
}
_TRANSPARENT_FILES = ("rowwise.py",)

_MATMUL_OPS = frozenset({"mm", "bmm", "addmm", "baddbmm", "_int_mm"})

# layout/metadata ops and allocations: no flops, no modelled traffic
_FREE_OPS = frozenset({
    "view", "_unsafe_view", "reshape", "_reshape_alias", "permute",
    "expand", "slice", "select", "transpose", "t", "unsqueeze", "squeeze",
    "alias", "as_strided", "detach", "unfold", "split", "split_with_sizes",
    "unbind", "narrow", "view_as_real", "view_as_complex", "real", "imag",
    "empty", "empty_like", "empty_strided", "new_empty", "zeros",
    "zeros_like", "new_zeros", "ones", "ones_like", "full", "full_like",
    "new_full", "arange", "scalar_tensor", "lift_fresh", "lift_fresh_copy",
    "fill", "zero",
})

# one flop per output element (in-place spellings are matched without
# their trailing underscore)
_ELEMENTWISE = frozenset({
    "add", "sub", "rsub", "mul", "div", "remainder", "fmod", "maximum",
    "minimum", "neg", "abs", "sign", "exp", "exp2", "expm1", "log",
    "log1p", "log2", "tanh", "sin", "cos", "erf", "erfc", "erfinv", "rsqrt",
    "sqrt", "reciprocal", "sigmoid", "pow", "floor", "ceil",
    "round", "trunc", "frac", "clamp", "clamp_min", "clamp_max", "where",
    "masked_fill", "lerp", "addcmul", "addcdiv", "floor_divide",
    "bitwise_and", "bitwise_or", "bitwise_xor", "bitwise_not",
    "bitwise_left_shift", "bitwise_right_shift", "__lshift__",
    "__rshift__", "__and__", "__or__", "__xor__", "logical_and",
    "logical_or", "logical_not", "eq", "ne", "lt", "le", "gt", "ge",
    "isfinite", "nan_to_num", "relu",
})

# one flop per *input* element (reductions)
_REDUCTIONS = frozenset({
    "sum", "prod", "amax", "amin", "argmax", "argmin", "cumsum", "cumprod",
    "cummax", "cummin", "any", "all", "std", "norm", "aminmax",
})

# Composite ops priced as the reference's jaxpr of the same jnp call
# counts them (float32 operands): flops and bytes are a*E + b*R + c, with
# E the input's elements and R its rows (a reduction's output elements;
# E / N for the row-wise softmax, GELU and LayerNorm), plus 8 bytes per
# feature of a LayerNorm's scale and bias.  Fitted exactly on the
# reference's equations: jnp.mean = reduce_sum + div; jnp.var = the mean,
# sub, square, reduce_sum, div and its ddof guard; jax.nn.softmax =
# reduce_max, max, sub, exp, reduce_sum, div; jax.nn.gelu = mul, neg,
# mul, erfc, mul, copy; jax.nn.silu = logistic, mul; jax.nn.softplus =
# logaddexp(x, 0): abs, neg, exp, log1p, max, two adds, sub, ne, select
# (three of them against a scalar); layers.apply_norm =
# mean, var, sub, add, rsqrt and three products / sums.
_COMPOSITE = {                  # name: ((a, b, c) flops, (a, b, c) bytes)
    "silu": ((2, 0, 0), (20, 0, 0)),
    "softplus": ((10, 0, 0), (90, 0, 12)),
    "mean": ((1, 1, 0), (4, 12, 4)),
    "var": ((3, 3, 2), (24, 40, 46)),
    "var_mean": ((4, 4, 2), (28, 52, 50)),
    "_softmax": ((5, 1, 0), (32, 24, 4)),
    "gelu": ((5, 0, 0), (44, 0, 8)),
    "native_layer_norm": ((8, 6, 2), (60, 76, 54)),
}

# jnp.clip is a max and a min, each against a scalar converted in the
# program; jnp.take of a table guards negative indices (lt, add, select)
# before its gather, all on int32 indices
_CLIP_SCALAR_BYTES = 4 + 8
_TAKE_INDEX_BYTES = (5 + 8 + 13 + 4, 8)     # per index element, constant


def _base(name: str) -> str:
    return name[:-1] if name.endswith("_") and not name.endswith("__") \
        else name


def _einsum_product(rec) -> bool:
    """A pair of a ``torch.einsum`` contraction that sums no index: the
    reference's ``jnp.einsum`` makes it a ``dot_general`` (a product of
    depth 1), PyTorch a ``mul``."""
    return rec.einsum and _base(rec.name) == "mul"


def _rows(rec) -> int:
    """Rows of a composite op: its first output's elements for a
    reduction, the input's elements over its last dimension otherwise."""
    name = rec.name
    if name in ("_softmax", "gelu", "native_layer_norm"):
        x = rec.inputs[0]
        return x.numel // max(int(x.shape[-1]) if x.shape else 1, 1)
    return rec.outputs[0].numel if rec.outputs else 1


def op_flops(rec) -> float:
    """Modelled floating(/integer)-op count of one recorded op."""
    if rec.charge is not None:
        return rec.charge[1]
    name = _base(rec.name)
    if name in _FREE_OPS or not rec.inputs:
        return 0.0
    if name in _MATMUL_OPS:
        # the product's operands are the last two inputs (addmm /
        # baddbmm carry the added term first): [.., M, K] @ [.., K, N]
        k = int(rec.inputs[-2].shape[-1])
        return 2.0 * rec.outputs[0].numel * k
    if _einsum_product(rec):               # a dot_general summing nothing
        return 2.0 * rec.outputs[0].numel
    if name == "_fft_r2c":
        x = rec.inputs[0]
        n = int(x.shape[-1])
        rows = x.numel / max(n, 1)
        return 5.0 * rows * n * max(math.log2(max(n, 2)), 1.0)
    if name in _COMPOSITE:
        a, b, c = _COMPOSITE[name][0]
        return float(a * rec.inputs[0].numel + b * _rows(rec) + c)
    if name in ("max", "min"):             # binary = element-wise
        name = "maximum" if len(rec.inputs) > 1 else "amax"
    if name == "clamp" and rec.scalars + len(rec.inputs) > 2:
        return 2.0 * rec.outputs[0].numel   # jnp.clip: max, then min
    if name == "index":                     # jnp.take: lt, add, select
        return 3.0 * sum(m.numel for m in rec.inputs[1:])
    if name in _ELEMENTWISE:
        return float(rec.outputs[0].numel) if rec.outputs else 0.0
    if name in _REDUCTIONS or name == "amax":
        return float(rec.inputs[0].numel)
    return 0.0


def _is_free(rec) -> bool:
    name = _base(rec.name)
    if name in _FREE_OPS:
        return True
    if name == "clone":                    # a layout copy of a view
        return bool(rec.inputs) and rec.inputs[0].view
    if name == "_to_copy":                 # a same-dtype copy
        return bool(rec.inputs) and bool(rec.outputs) and \
            rec.inputs[0].dtype == rec.outputs[0].dtype
    return False


def op_bytes(rec) -> float:
    """Modelled memory traffic of one recorded op (operands read +
    results written once; layout-only ops move nothing)."""
    if rec.charge is not None:
        return rec.charge[2]
    if _is_free(rec):
        return 0.0
    name = _base(rec.name)
    if name in _COMPOSITE:
        a, b, c = _COMPOSITE[name][1]
        extra = 0
        if name == "native_layer_norm":
            extra = 8 * int(rec.inputs[0].shape[-1])
        return float(a * rec.inputs[0].numel + b * _rows(rec) + c + extra)
    out = float(sum(ow.tensor_bytes(m) for m in rec.outputs))
    if name == "index":
        per, const = _TAKE_INDEX_BYTES
        idx = sum(m.numel for m in rec.inputs[1:])
        return ow.tensor_bytes(rec.inputs[0]) + out + per * idx + const
    nbytes = float(sum(ow.tensor_bytes(m) for m in rec.inputs)) + out
    if name == "clamp":
        bounds = rec.scalars + len(rec.inputs) - 1
        return bounds * (nbytes + _CLIP_SCALAR_BYTES)
    if name in _ELEMENTWISE or name in ("max", "min"):
        nbytes += 4 * rec.scalars           # a scalar operand is read too
    return nbytes


def classify(rec, default_stage: str) -> tuple[str, str]:
    """(stage, op) attribution of one record from its frames."""
    frames = ow.user_frames(rec)
    op = stage = None
    file_checked = False
    for f in frames:
        fn = f.function_name
        fname = f.file_name.rsplit("/", 1)[-1]
        if op is None:
            op = _OP_OF_FUNC.get(fn)
        if stage is None:
            stage = _STAGE_BY_FUNC.get(fn)
            if stage is None and not file_checked and \
                    fname not in _TRANSPARENT_FILES:
                stage = _STAGE_BY_FILE.get(fname)
                file_checked = True
    if op is None:
        if rec.charge is not None:
            op = rec.charge[0]
        else:
            op = "matmul" if _base(rec.name) in _MATMUL_OPS \
                or _einsum_product(rec) else "other"
    return stage or default_stage, op


# -- accumulation -----------------------------------------------------------

@dataclasses.dataclass
class CostLine:
    """Accumulated cost of one (stage, op) cell of the table."""

    stage: str
    op: str
    flops: float = 0.0
    bytes: float = 0.0
    eqns: int = 0

    @property
    def intensity(self) -> float:
        return self.flops / self.bytes if self.bytes else 0.0


@dataclasses.dataclass
class CostReport:
    """Per-(stage, op) cost lines of one (or several merged) programs."""

    lines: dict = dataclasses.field(default_factory=dict)
    notes: list = dataclasses.field(default_factory=list)

    def add(self, stage: str, op: str, flops: float, bytes_: float,
            mult: float = 1.0) -> None:
        line = self.lines.get((stage, op))
        if line is None:
            line = self.lines[(stage, op)] = CostLine(stage, op)
        line.flops += mult * flops
        line.bytes += mult * bytes_
        line.eqns += 1

    def merge(self, other: "CostReport") -> "CostReport":
        for (stage, op), line in other.lines.items():
            cur = self.lines.get((stage, op))
            if cur is None:
                self.lines[(stage, op)] = dataclasses.replace(line)
            else:
                cur.flops += line.flops
                cur.bytes += line.bytes
                cur.eqns += line.eqns
        self.notes.extend(other.notes)
        return self

    # -- totals -----------------------------------------------------------

    @property
    def flops(self) -> float:
        return sum(ln.flops for ln in self.lines.values())

    @property
    def bytes(self) -> float:
        return sum(ln.bytes for ln in self.lines.values())

    @property
    def matmul_flops(self) -> float:
        """Product flops only — backend-invariant for identical math (the
        LUT/kernel backends change softmax/GELU realisation, never the
        linear algebra; tests/test_torch_perf.py pins this)."""
        return sum(ln.flops for ln in self.lines.values()
                   if ln.op == "matmul")

    @property
    def intensity(self) -> float:
        return self.flops / self.bytes if self.bytes else 0.0

    def by_stage(self) -> dict:
        out: dict = {}
        for ln in self.lines.values():
            cur = out.setdefault(ln.stage, CostLine(ln.stage, "*"))
            cur.flops += ln.flops
            cur.bytes += ln.bytes
            cur.eqns += ln.eqns
        return out

    def stage_weights(self, machine=None) -> dict:
        """Relative time share per stage (flight-recorder attribution):
        modelled stage time on ``machine`` (roofline max of compute and
        memory terms), normalised to sum to 1; flops share if no machine."""
        stages = self.by_stage()
        if machine is None:
            tot = sum(ln.flops for ln in stages.values()) or 1.0
            return {s: ln.flops / tot for s, ln in stages.items()}
        t = {s: machine.time_s(ln.flops, ln.bytes)
             for s, ln in stages.items()}
        tot = sum(t.values()) or 1.0
        return {s: v / tot for s, v in t.items()}

    # -- rendering --------------------------------------------------------

    def rows(self, machine=None) -> list[dict]:
        """Table rows (dicts), paper-style: one per (stage, op) plus an
        estimated-cycles column when a MachineModel prices the plan."""
        out = []
        for (stage, op) in sorted(self.lines):
            ln = self.lines[(stage, op)]
            row = {"stage": stage, "op": op, "flops": round(ln.flops),
                   "bytes_moved": round(ln.bytes),
                   "arithmetic_intensity": round(ln.intensity, 4),
                   "eqns": ln.eqns}
            if machine is not None:
                row["est_cycles"] = round(machine.cycles(ln.flops, ln.bytes))
            out.append(row)
        return out

    def table(self, machine=None) -> str:
        cols = ["stage", "op", "flops", "bytes_moved",
                "arithmetic_intensity", "eqns"]
        if machine is not None:
            cols.append("est_cycles")
        rows = self.rows(machine)
        head = "| " + " | ".join(cols) + " |"
        sep = "|" + "|".join("---" for _ in cols) + "|"
        body = ["| " + " | ".join(str(r[c]) for c in cols) + " |"
                for r in rows]
        total = {"stage": "**total**", "op": "", "flops": round(self.flops),
                 "bytes_moved": round(self.bytes),
                 "arithmetic_intensity": round(self.intensity, 4),
                 "eqns": sum(ln.eqns for ln in self.lines.values())}
        if machine is not None:
            total["est_cycles"] = round(machine.cycles(self.flops,
                                                       self.bytes))
        body.append("| " + " | ".join(str(total[c]) for c in cols) + " |")
        return "\n".join([head, sep] + body)

    def to_dict(self, machine=None) -> dict:
        return {"flops": round(self.flops),
                "bytes_moved": round(self.bytes),
                "matmul_flops": round(self.matmul_flops),
                "arithmetic_intensity": round(self.intensity, 4),
                "lines": self.rows(machine),
                "notes": list(self.notes)}


# -- walking ------------------------------------------------------------------

def program_cost(fn, *args, stage: str = "forward") -> CostReport:
    """Cost of running ``fn(*args)`` once; ``stage`` labels unattributed
    ops.  The kernel launch counters (``kernels.ops.launch_counts``) read
    the same after the walk as before it."""
    from repro_torch.kernels import ops
    saved = ops.launch_counts()
    try:
        _, records = ow.record(fn, *args)
    finally:
        ops.restore_launch_counts(saved)
    rep = CostReport()
    for rec in records:
        flops, nbytes = op_flops(rec), op_bytes(rec)
        if flops or nbytes:        # layout ops and allocations: no line
            where, op = classify(rec, stage)
            name = _base(rec.name)
            if op == "matmul" and name in _ELEMENTWISE and not rec.einsum:
                # the unrolled MAC chain: each product a multiply-add (2
                # flops), the sums already priced in, 2*M*N*K in all
                flops = 2.0 * flops if name == "mul" else 0.0
            rep.add(where, op, flops, nbytes)
    return rep


# -- Engine-level entry points ----------------------------------------------

def _unpack_cost(engine) -> Optional[CostReport]:
    """Cost of the per-call unpack of integer-resident plans that do not
    execute on integers — None for float plans AND for integer-executing
    plans (no unpack stage exists; the eliminated work is the int-exec
    flavour's headline saving)."""
    if not engine.int_resident or engine.int_exec:
        return None
    from repro_torch.core import quant
    return program_cost(quant.dequantize_tree, engine.params,
                        stage="unpack")


def _live_params(engine):
    """The operand tree the model runs on: the packed QTensors of
    integer-executing plans, the per-call float view of non-executing
    resident plans (made outside the walk: its cost is the ``unpack``
    stage, not embed/encode's), the float tree otherwise."""
    if not engine.int_resident or engine.int_exec:
        return engine.params
    with torch.no_grad():
        return engine.live_params()


def engine_cost(engine, x=None, batch: int = 1) -> CostReport:
    """Full per-forward cost of an Engine plan (paper-table shape).

    Covers everything ``Engine.forward`` executes: the unpack of
    non-executing integer-resident plans (stage ``unpack``) plus the
    model — KWT walked as its ``embed_frames``/``encode_window``
    factorisation so the stage split matches the telemetry span names;
    the LM families (dense, moe, rwkv, hybrid) as one ``encode`` stage
    of their ``forward`` on ``x`` (default: ``analysis.example_input``,
    ``[batch, 8]`` tokens).  KWT's inputs are zeros on the engine's
    device.  The encdec family raises ``TypeError`` (ROADMAP C11), as
    ``Engine.forward`` does.
    """
    from repro_torch import analysis

    cfg = engine.exec_cfg
    if x is None:
        x = analysis.example_input(cfg, batch, engine.device)
    rep = CostReport()
    up = _unpack_cost(engine)
    if up is not None:
        rep.merge(up)
    lp = _live_params(engine)
    if cfg.family != "kwt":
        # engine_cost prices Engine.forward, which the encdec family does
        # not run (ROADMAP C11): its refusal, in its words
        engine._refuse_encdec("forward")
        rep.merge(program_cost(
            lambda p, xx: engine._mod.forward(p, xx, cfg),
            lp, x, stage="encode"))
        return rep
    f, t = cfg.input_dim
    b = x.shape[0]
    frames = torch.zeros((b, t, f), dtype=torch.float32, device=engine.device)
    window = torch.zeros((b, t, cfg.d_model), dtype=getattr(torch, cfg.dtype),
                         device=engine.device)
    rep.merge(program_cost(
        lambda p, fr: engine._mod.embed_frames(p, fr, cfg),
        lp, frames, stage="embed"))
    rep.merge(program_cost(
        lambda p, w: engine._mod.encode_window(p, w, cfg),
        lp, window, stage="encode"))
    return rep


def stream_hop_cost(engine, fcfg, batch: int = 1, chunk_hops: int = 1,
                    feature_ingest: bool = False) -> CostReport:
    """Cost of one streaming hop under an Engine plan:
    ``stream.engine.stream_step`` (audio ingest: featurise + embed +
    encode) or ``stream_step_frames`` (edge-featurised ingest), plus the
    unpack of non-executing integer-resident plans.  The detector step is
    not modelled (its per-hop work is a handful of [B] element-wise ops)."""
    from repro_torch.stream import engine as stream_engine

    cfg = engine.exec_cfg
    dev = engine.device
    state = stream_engine.init_stream_state(cfg, fcfg, batch, device=dev)
    rep = CostReport()
    up = _unpack_cost(engine)
    if up is not None:
        rep.merge(up)
    lp = _live_params(engine)
    if feature_ingest:
        chunk = torch.zeros((batch, chunk_hops, cfg.input_dim[0]),
                            dtype=torch.float32, device=dev)
        rep.merge(program_cost(
            lambda p, s, c: stream_engine.stream_step_frames(p, s, c, cfg),
            lp, state, chunk, stage="encode"))
    else:
        chunk = torch.zeros((batch, chunk_hops * fcfg.hop_len),
                            dtype=torch.float32, device=dev)
        rep.merge(program_cost(
            lambda p, s, c: stream_engine.stream_step(p, s, c, cfg, fcfg),
            lp, state, chunk, stage="encode"))
    return rep
