"""Q8.24 interval analysis: static overflow / precondition verification.

An abstract interpreter over the ATen records of a run
(:func:`repro_torch.analysis.op_walk.walk`) where every tensor carries a
value interval ``[lo, hi]`` (exact Python ints for integer dtypes,
floats for float dtypes).  Constants — notably the LUT ROM tables from
``core/lut.py`` — enter with their concrete min/max (a tensor no recorded
op produced from the declared inputs), which is what makes the analysis
precise enough to verify the fixed-point pipelines: a gather from
``LUT_EXP`` is *provably* in ``[e^-9.97, 1.0]`` in Q8.24 no matter how
wild the index interval is.

A walk records the branch its example input takes.  The contract
functions below (``approx.softmax(mode="lut_fixed")``,
``lut.reciprocal_q24``, ``fixedpoint.fixed_mul``,
``approx.gelu(mode="lut")``, ``fixedpoint.fixed_shift_mul``) branch only
on Python values — shapes, modes, shift counts — never on tensor data,
so the one recorded path is the path of every input.

Checks performed while interpreting:

  * **int32 overflow**: every integer ``add``/``sub``/``mul``/``sum``/
    ``cumsum``/``<<`` whose exact mathematical result interval escapes the
    result dtype's range.  A result that feeds ONLY ``torch.where``
    choice lanes (through views) is recognised as the repo's
    saturating-guard idiom (``torch.where(a > limit, MAX, a << s)``) and
    reported as ``whitelisted`` instead — the wrapped value is statically
    dead.
  * **fixed_mul precondition**: the 12/12-limb product is exact only for
    24-bit magnitudes (``|a|,|b| <= 1.0`` in Q8.24).  The ``abs`` ops
    inside ``fixed_mul`` are checked against ``ONE``.

Verification is compositional (assume-guarantee): :func:`check_ranges`
runs one contract per pipeline stage with declared input intervals
(reported as ``assumption`` findings), and the full-pipeline contract
suppresses checks inside stages that have their own dedicated contract.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.analysis import op_walk as ow
from repro_torch.analysis.report import Finding, PassResult

_F32_MAX = 3.4028235e38


@dataclasses.dataclass(frozen=True)
class Interval:
    lo: float
    hi: float

    def __post_init__(self):
        assert self.lo <= self.hi, (self.lo, self.hi)

    def hull(self, other: "Interval") -> "Interval":
        return Interval(min(self.lo, other.lo), max(self.hi, other.hi))

    def __repr__(self):
        return f"[{self.lo}, {self.hi}]"


def _is_int(dtype) -> bool:
    return dtype == torch.bool or not (dtype.is_floating_point
                                       or dtype.is_complex)


def dtype_interval(dtype) -> Interval:
    if dtype == torch.bool:
        return Interval(0, 1)
    if _is_int(dtype):
        info = torch.iinfo(dtype)
        return Interval(int(info.min), int(info.max))
    return Interval(-_F32_MAX, _F32_MAX)


def from_value(val) -> Interval:
    if isinstance(val, bool):
        return Interval(int(val), int(val))
    if isinstance(val, int):
        return Interval(val, val)
    if isinstance(val, float):
        return Interval(val, val)
    lo, hi = ow.concrete(torch.as_tensor(val))
    return Interval(lo, hi)


def _corners(f, a: Interval, b: Interval) -> Interval:
    vals = []
    for x in (a.lo, a.hi):
        for y in (b.lo, b.hi):
            v = f(x, y)
            if isinstance(v, float) and math.isnan(v):
                return Interval(-math.inf, math.inf)
            vals.append(v)
    return Interval(min(vals), max(vals))


def _mono(f, a: Interval) -> Interval:
    lo, hi = f(a.lo), f(a.hi)
    return Interval(min(lo, hi), max(lo, hi))


def _shift_corners(f, a: Interval, s: Interval) -> Interval:
    slo = max(0, int(s.lo))
    shi = min(63, max(slo, int(s.hi)))
    vals = [f(int(x), y) for x in (a.lo, a.hi) for y in (slo, shi)]
    return Interval(min(vals), max(vals))


def _cmp(a: Interval, b: Interval, op: str) -> Interval:
    true_, false_ = Interval(1, 1), Interval(0, 0)
    if op in ("ge", "gt"):
        strict = op == "gt"
        if a.lo > b.hi or (not strict and a.lo >= b.hi):
            return true_
        if a.hi < b.lo or (strict and a.hi <= b.lo):
            return false_
    elif op in ("le", "lt"):
        strict = op == "lt"
        if a.hi < b.lo or (not strict and a.hi <= b.lo):
            return true_
        if a.lo > b.hi or (strict and a.lo >= b.hi):
            return false_
    elif op == "eq":
        if a.lo == a.hi == b.lo == b.hi:
            return true_
        if a.hi < b.lo or a.lo > b.hi:
            return false_
    elif op == "ne":
        if a.hi < b.lo or a.lo > b.hi:
            return true_
        if a.lo == a.hi == b.lo == b.hi:
            return false_
    return Interval(0, 1)


# ATen names of the shifts (``>>`` / ``<<`` dispatch the dunder ops)
_ALIASES = {"__rshift__": "shift_right", "bitwise_right_shift": "shift_right",
            "__irshift__": "shift_right", "__lshift__": "shift_left",
            "bitwise_left_shift": "shift_left", "__ilshift__": "shift_left",
            "sigmoid": "logistic"}

# one output with the first operand's values
_SAME = frozenset((
    "view", "_unsafe_view", "expand", "permute", "t", "transpose",
    "unsqueeze", "squeeze", "slice", "select", "alias", "clone", "detach",
    "lift_fresh", "lift_fresh_copy", "as_strided", "repeat", "flip", "roll",
    "_reshape_alias", "index", "index_select", "gather", "take", "amax",
    "amin", "max", "min"))
# every output with the first operand's values
_SPLITS = frozenset(("split", "split_with_sizes", "unbind"))
# views and copies followed when deciding whether a value only reaches
# torch.where choice lanes
_PASS = frozenset(("view", "_unsafe_view", "expand", "permute", "t",
                   "transpose", "unsqueeze", "squeeze", "alias", "clone",
                   "detach", "_reshape_alias"))


def op_name(rec) -> str:
    name = rec.name
    if name.endswith("_") and not name.startswith("__"):
        name = name[:-1]          # in-place: the same values as out-of-place
    return _ALIASES.get(name, name)


class _Ctx:
    """Shared per-analysis state: findings, options, dedup sets."""

    def __init__(self, findings, records, *, suppress_frames=(),
                 check_fixed_mul=True, label="", whitelist=(), outputs=()):
        self.findings = findings
        self.suppress_frames = frozenset(suppress_frames)
        self.check_fixed_mul = check_fixed_mul
        self.label = label
        self.whitelist = tuple(whitelist)   # (frame, op, reason)
        self.outputs = frozenset(outputs)
        self._seen = set()
        self._suppressed_noted = set()
        self.consumers = _consumer_map(records)

    def once(self, key) -> bool:
        if key in self._seen:
            return False
        self._seen.add(key)
        return True

    def suppressed(self, rec) -> bool:
        for f in ow.frame_functions(rec):
            if f in self.suppress_frames:
                if f not in self._suppressed_noted:
                    self._suppressed_noted.add(f)
                    self.findings.append(Finding(
                        "info", "delegated",
                        f"{self.label}: checks inside {f!r} delegated to its "
                        "dedicated contract"))
                return True
        return False


def _refs(arg):
    if isinstance(arg, ow.Ref):
        return [arg.ident]
    if isinstance(arg, (list, tuple)):
        return [a.ident for a in arg if isinstance(a, ow.Ref)]
    return []


def _consumer_map(records):
    """identity -> [(record, argument position)]."""
    cons = {}
    for rec in records:
        if rec.charge is not None:
            for i in rec.in_ids:
                cons.setdefault(i, []).append((rec, -1))
            continue
        for pos, arg in enumerate(rec.args):
            for i in _refs(arg):
                cons.setdefault(i, []).append((rec, pos))
        for arg in (rec.kwargs or {}).values():
            for i in _refs(arg):
                cons.setdefault(i, []).append((rec, -1))
    return cons


def _guarded_uses(ident, ctx, depth=0) -> bool:
    """True when every (transitive, through views) use of ``ident`` is a
    ``torch.where`` choice lane (the saturating-guard idiom): the
    out-of-range value is statically dead — the predicate lane replaces
    it."""
    uses = ctx.consumers.get(ident, [])
    if not uses or ident in ctx.outputs or depth > 4:
        return False
    for user, pos in uses:
        name = op_name(user)
        if name == "where" and pos in (1, 2):
            continue
        if name in _PASS and pos == 0 and user.out_ids:
            if _guarded_uses(user.out_ids[0], ctx, depth + 1):
                continue
        return False
    return True


def _check_int_result(ctx, rec, raw: Interval) -> Interval:
    """Flag integer results escaping their dtype; return the clamped
    interval (what saturation — or the guarding select — would keep)."""
    dtype = rec.outputs[0].dtype
    if dtype == torch.bool or not _is_int(dtype):
        return raw
    rng = dtype_interval(dtype)
    if raw.lo >= rng.lo and raw.hi <= rng.hi:
        return raw
    clamped = Interval(max(raw.lo, rng.lo), min(raw.hi, rng.hi))
    if not ctx.suppressed(rec):
        site = ow.user_site(rec)
        name = op_name(rec)
        dname = str(dtype).replace("torch.", "")
        desc = (f"{ctx.label}: {name} on {dname} may reach {raw} "
                f"(range {rng})")
        wl_reason = None
        fns = ow.frame_functions(rec)
        for frame, op, reason in ctx.whitelist:
            if op == name and frame in fns:
                wl_reason = reason
                break
        if _guarded_uses(rec.out_ids[0], ctx):
            if ctx.once(("guard", name, site)):
                ctx.findings.append(Finding(
                    "whitelisted", "guarded-overflow",
                    desc + " — result only feeds saturating select lanes",
                    site))
        elif wl_reason is not None:
            if ctx.once(("wl", name, site)):
                ctx.findings.append(Finding(
                    "whitelisted", "known-safe-overflow",
                    desc + f" — {wl_reason}", site))
        elif ctx.once(("overflow", name, site)):
            ctx.findings.append(Finding(
                "violation", f"{dname}-overflow",
                desc + " — unguarded: silently wraps", site))
    return clamped


def _precondition_check(ctx, rec, operand: Interval):
    """The fixed_mul 24-bit-magnitude precondition, checked at its |.|."""
    one = 1 << 24
    if "fixed_mul" not in ow.frame_functions(rec) or not ctx.check_fixed_mul:
        return
    if ctx.suppressed(rec):
        return
    if operand.lo < -one or operand.hi > one:
        site = ow.user_site(rec)
        if ctx.once(("precond", site)):
            ctx.findings.append(Finding(
                "violation", "fixed-mul-precondition",
                f"{ctx.label}: fixed_mul operand may reach {operand}; the "
                "12/12-limb product is only exact for |q| <= 2^24",
                site))


def _arg(rec, pos, name, default=None):
    if pos < len(rec.args):
        return rec.args[pos]
    return (rec.kwargs or {}).get(name, default)


def _elementwise_math(name, a: Interval, rec, read) -> Interval:
    fns = {
        "exp": lambda x: math.exp(min(x, 700.0)),
        "exp2": lambda x: 2.0 ** min(x, 1000.0),
        "log": lambda x: math.log(x) if x > 0 else -math.inf,
        "log2": lambda x: math.log2(x) if x > 0 else -math.inf,
        "tanh": math.tanh,
        "logistic": lambda x: 1.0 / (1.0 + math.exp(-max(min(x, 700), -700))),
        "erf": math.erf,
        "sqrt": lambda x: math.sqrt(max(x, 0.0)),
    }
    if name in ("sin", "cos"):
        return Interval(-1.0, 1.0)
    if name in ("isfinite", "isnan", "isinf"):
        return Interval(0, 1)
    if name == "rsqrt":
        return Interval(1.0 / math.sqrt(a.hi) if a.hi > 0 else math.inf,
                        1.0 / math.sqrt(a.lo) if a.lo > 0 else math.inf)
    if name in ("square", "pow"):
        y = 2 if name == "square" else _arg(rec, 1, "exponent")
        if isinstance(y, (int, float)) and float(y).is_integer():
            y = int(y)
            vals = [x ** y for x in (a.lo, a.hi)]
            if y % 2 == 0 and a.lo <= 0 <= a.hi:
                vals.append(0)
            return Interval(min(vals), max(vals))
        return _corners(lambda x, e: x ** e if x > 0 else 0.0, a, read(y))
    if name == "reciprocal":
        if a.lo <= 0 <= a.hi:
            return Interval(-math.inf, math.inf)
        return _mono(lambda x: 1.0 / x, a)
    return _mono(fns[name], a)


_MATH = frozenset(("exp", "exp2", "log", "log2", "tanh", "logistic", "erf",
                   "sqrt", "rsqrt", "sin", "cos", "isfinite", "isnan",
                   "isinf", "square", "pow", "reciprocal"))
_FILL = {"zeros": 0, "zeros_like": 0, "new_zeros": 0, "ones": 1,
         "ones_like": 1, "new_ones": 1}


def _transfer(rec, name, read, ctx, out_dtype):
    """The first output's interval, or None for no transfer function."""
    a0 = _arg(rec, 0, "self")
    if name in ("add", "sub", "mul", "rsub"):
        a, b = read(a0), read(_arg(rec, 1, "other"))
        alpha = (rec.kwargs or {}).get("alpha", 1)
        if alpha != 1:
            b = _corners(lambda x, y: x * y, b, Interval(alpha, alpha))
        if name == "rsub":
            a, b, name = b, a, "sub"
        f = {"add": lambda x, y: x + y, "sub": lambda x, y: x - y,
             "mul": lambda x, y: x * y}[name]
        return _check_int_result(ctx, rec, _corners(f, a, b))
    if name == "div":
        a, b = read(a0), read(_arg(rec, 1, "other"))
        if b.lo <= 0 <= b.hi:
            return Interval(-math.inf, math.inf)
        out = _corners(lambda x, y: x / y, a, b)
        mode = (rec.kwargs or {}).get("rounding_mode")
        if mode is not None:
            out = Interval(math.floor(out.lo), math.ceil(out.hi))
        return out
    if name == "neg":
        a = read(a0)
        return Interval(-a.hi, -a.lo)
    if name == "abs":
        a = read(a0)
        _precondition_check(ctx, rec, a)
        return Interval(0 if a.lo <= 0 <= a.hi else min(abs(a.lo), abs(a.hi)),
                        max(abs(a.lo), abs(a.hi)))
    if name == "sign":
        a = read(a0)
        return Interval(-1 if a.lo < 0 else (0 if a.lo == 0 else 1),
                        1 if a.hi > 0 else (0 if a.hi == 0 else -1))
    if name in ("maximum", "minimum") or (
            name in ("max", "min") and len(rec.in_ids) == 2):
        a, b = read(a0), read(_arg(rec, 1, "other"))
        if name in ("maximum", "max"):
            return Interval(max(a.lo, b.lo), max(a.hi, b.hi))
        return Interval(min(a.lo, b.lo), min(a.hi, b.hi))
    if name in ("clamp", "clamp_min", "clamp_max"):
        x = read(a0)
        if name == "clamp_max":
            lo_arg, hi_arg = None, _arg(rec, 1, "max")
        else:
            lo_arg = _arg(rec, 1, "min")
            hi_arg = _arg(rec, 2, "max") if name == "clamp" else None
        # each end from the bounds' own ends: max(x, mn) then min(., mx)
        # are monotone in both operands
        lo, hi = x.lo, x.hi
        if lo_arg is not None:
            mn = read(lo_arg)
            lo, hi = max(lo, mn.lo), max(hi, mn.hi)
        if hi_arg is not None:
            mx = read(hi_arg)
            lo, hi = min(lo, mx.lo), min(hi, mx.hi)
        return Interval(lo, hi)
    if name == "shift_left":
        out = _shift_corners(lambda a, s: a << s, read(a0),
                             read(_arg(rec, 1, "other")))
        return _check_int_result(ctx, rec, out)
    if name == "shift_right":
        return _shift_corners(lambda x, s: x >> s, read(a0),
                              read(_arg(rec, 1, "other")))
    if name in ("bitwise_and", "bitwise_or", "bitwise_xor"):
        if out_dtype == torch.bool:
            return Interval(0, 1)
        ins = [read(a0), read(_arg(rec, 1, "other"))]
        if all(i.lo >= 0 for i in ins):
            if name == "bitwise_and":
                return Interval(0, min(i.hi for i in ins))
            bits = max(int(i.hi).bit_length() for i in ins)
            return Interval(0, (1 << bits) - 1)
        return dtype_interval(out_dtype)
    if name in ("logical_and", "logical_or", "logical_xor", "logical_not",
                "bitwise_not"):
        return dtype_interval(out_dtype)
    if name in ("ge", "gt", "le", "lt", "eq", "ne"):
        return _cmp(read(a0), read(_arg(rec, 1, "other")), name)
    if name == "where":
        pred = read(a0)
        cases = [read(_arg(rec, 1, "self")), read(_arg(rec, 2, "other"))]
        if pred.lo == pred.hi:
            return cases[0] if int(pred.lo) else cases[1]
        return cases[0].hull(cases[1])
    if name == "_to_copy":
        a = read(a0)
        if _is_int(out_dtype):
            rng = dtype_interval(out_dtype)
            lo = rng.lo if a.lo == -math.inf else int(math.floor(a.lo))
            hi = rng.hi if a.hi == math.inf else int(math.ceil(a.hi))
            if lo < rng.lo or hi > rng.hi:
                return rng        # a narrowing integer cast wraps
            return Interval(lo, hi)
        return Interval(float(a.lo), float(a.hi))
    if name == "copy":                      # copy(self, src): src's values
        return read(_arg(rec, 1, "src"))
    if name in _SAME:
        return read(a0)
    if name in ("cat", "stack"):
        ivs = [read(r) for r in a0]
        out = ivs[0]
        for i in ivs[1:]:
            out = out.hull(i)
        return out
    if name in ("sum", "cumsum"):
        a = read(a0)
        n_in = rec.inputs[0].numel
        n = max(1, n_in // max(1, rec.outputs[0].numel)) \
            if name == "sum" else max(1, n_in)
        out = Interval(min(a.lo * n, a.lo), max(a.hi * n, a.hi))
        return _check_int_result(ctx, rec, out)
    if name in ("full", "full_like", "new_full", "fill", "scalar_tensor"):
        pos = {"full": 1, "full_like": 1, "new_full": 2, "fill": 1,
               "scalar_tensor": 0}[name]
        v = _arg(rec, pos, "fill_value" if name != "fill" else "value")
        return read(v)
    if name in _FILL:
        return Interval(_FILL[name], _FILL[name])
    if name == "arange":
        nums = [a for a in rec.args if isinstance(a, (int, float))]
        start, end = (0, nums[0]) if len(nums) == 1 else (nums[0], nums[1])
        return Interval(start, max(start, end - 1))
    if name in ("floor", "ceil", "round", "trunc"):
        a = read(a0)
        return Interval(math.floor(a.lo), math.ceil(a.hi))
    if name in _MATH:
        return _elementwise_math(name, read(a0), rec, read)
    return None


def _run(records, env, ctx, metas):
    def read(arg):
        if isinstance(arg, ow.Ref):
            hit = env.get(arg.ident)
            if hit is not None:
                return hit
            return dtype_interval(metas[arg.ident])
        if isinstance(arg, (bool, int, float)):
            return from_value(arg)
        return Interval(-math.inf, math.inf)

    for rec in records:
        if rec.charge is not None:
            if ctx.once(("charge", rec.charge[0])):
                ctx.findings.append(Finding(
                    "info", "widened",
                    f"{ctx.label}: a kernel charge ({rec.charge[0]}); its "
                    "results widened to their dtype range"))
            for i in rec.out_ids:
                env[i] = dtype_interval(metas[i])
            continue
        if not rec.out_ids:
            continue
        name = op_name(rec)
        out_dtype = rec.outputs[0].dtype
        if name in _SPLITS:
            iv = read(_arg(rec, 0, "self"))
            for i in rec.out_ids:
                env[i] = iv
            continue
        out = _transfer(rec, name, read, ctx, out_dtype)
        if out is None:
            if ctx.once(("widen", name)):
                ctx.findings.append(Finding(
                    "info", "widened",
                    f"{ctx.label}: no transfer function for op {name!r}; "
                    "result widened to its dtype range"))
            for i in rec.out_ids:
                env[i] = dtype_interval(metas[i])
            continue
        env[rec.out_ids[0]] = out
        for i in rec.out_ids[1:]:
            env[i] = dtype_interval(metas[i])
    return env


def _metas(records) -> dict:
    metas = {}
    for rec in records:
        for i, m in zip(rec.in_ids, rec.inputs):
            metas.setdefault(i, m.dtype)
        for i, m in zip(rec.out_ids, rec.outputs):
            metas[i] = m.dtype
    return metas


def analyze_fn(fn, example_args, input_intervals, *, label="fn",
               suppress_frames=(), check_fixed_mul=True, whitelist=()):
    """Interval-analyze ``fn`` run at ``example_args``.

    ``input_intervals``: one Interval per input tensor (None entries
    default to the tensor dtype's full range).  Returns ``(findings,
    out_intervals)``.
    """
    findings = []
    w = ow.walk(fn, *example_args, values=True)
    ctx = _Ctx(findings, w.records, suppress_frames=suppress_frames,
               check_fixed_mul=check_fixed_mul, label=label,
               whitelist=whitelist, outputs=w.output_ids)
    metas = _metas(w.records)
    env = {i: Interval(*lohi) for i, lohi in w.recorder.consts.items()}
    tensors = [a for a in example_args if isinstance(a, torch.Tensor)]
    ivs = list(input_intervals) + [None] * (len(tensors) - len(input_intervals))
    for t, i, iv in zip(tensors, w.declared, ivs):
        env[i] = iv if iv is not None else dtype_interval(t.dtype)
    _run(w.records, env, ctx, metas)
    outs = []
    for t in ow._tensors(w.output):
        i = w.ident(t)
        outs.append(env.get(i, dtype_interval(t.dtype)) if i is not None
                    else from_value(t))
    return findings, outs


# ---------------------------------------------------------------------------
# Engine-level contracts
# ---------------------------------------------------------------------------

def _assume(findings, label, text):
    findings.append(Finding("assumption", "domain-fact", f"{label}: {text}"))


FIXED_SOFTMAX = ("lut_fixed", "cuda")
LUT_ACT = ("lut", "cuda")


def check_ranges(engine, x) -> PassResult:
    """Run the Q8.24 contracts selected by the engine's execution modes.
    A ``cuda`` plan is a fixed-point plan here: its kernels run the same
    Q8.24 ops per lane as the plain pipeline the contracts walk."""
    from repro_torch.core import approx, fixedpoint as fxp, lut as lutlib

    cfg = engine.exec_cfg
    dev = engine.device
    findings = []
    metrics = {}
    one = 1 << fxp.FRAC_BITS
    if cfg.softmax_mode not in FIXED_SOFTMAX and cfg.act_approx == "exact":
        findings.append(Finding(
            "info", "scope", "plan uses no fixed-point pipelines; nothing "
            "to range-check"))
        return PassResult("ranges", findings, metrics)
    if cfg.softmax_mode == "cuda":
        findings.append(Finding(
            "info", "scope",
            "cuda kernels execute the same Q8.24 ops lane by lane; "
            "contracts verify the plain pipeline the kernels are held bit "
            "for bit against (chip_smoke.py)"))

    if cfg.family == "kwt":
        from repro_torch.models import kwt
        k_lens = [kwt.seqlen(cfg)]
    else:
        k_lens = [int(x.shape[-1])] if x.ndim else [64]

    if cfg.softmax_mode in FIXED_SOFTMAX:
        for k in k_lens:
            pre = approx.pre_shift_bits(k)
            label = f"softmax_q824[K={k}]"
            # (1) full pipeline; reciprocal + product have own contracts
            f1, _ = analyze_fn(
                lambda v: approx.softmax(v, mode="lut_fixed"),
                (torch.zeros((1, k), device=dev),), [None], label=label,
                suppress_frames=("reciprocal_q24", "fixed_mul"))
            findings += f1
            # (2) reciprocal stage under the dominant-lane row-sum bound
            _assume(findings, label,
                    f"row sum s_q >= 2^(24-pre)={1 << (24 - pre)} (the "
                    "max-normalised row always has a z=0 lane at e^0=1)")
            bank = lutlib.make_lut_bank()
            f2, _ = analyze_fn(
                lambda s: lutlib.reciprocal_q24(s, bank),
                (torch.zeros((1, 1), dtype=torch.int32, device=dev),),
                [Interval(one >> pre, k * (one >> pre))],
                label=f"{label}/reciprocal",
                whitelist=((
                    "reciprocal_q24", "shift_left",
                    "mantissa normalisation (s>>tp)<<tn: tp/tn are "
                    "magnitude-correlated with s (ilog2), so the result "
                    "is in [1,2) Q8.24 — invisible to intervals"),))
            findings += f2
            # (3) the normalisation product's exactness precondition
            _assume(findings, label,
                    "1/s <= 2^pre in Q8.24 (s >= 2^-pre real), so the "
                    "post-shift reciprocal magnitude is <= 1.0")
            f3, _ = analyze_fn(
                lambda a, b: fxp.fixed_mul(a, b),
                (torch.zeros((1, k), dtype=torch.int32, device=dev),
                 torch.zeros((1, 1), dtype=torch.int32, device=dev)),
                [Interval(0, one), Interval(0, one)],
                label=f"{label}/normalise")
            findings += f3
        metrics["softmax_contracts"] = 3 * len(k_lens)

    if cfg.act_approx in LUT_ACT and cfg.activation == "gelu":
        f4, _ = analyze_fn(
            lambda v: approx.gelu(v, mode="lut"),
            (torch.zeros((1, max(k_lens)), device=dev),), [None],
            label="gelu_lut")
        findings += f4
        metrics["gelu_contracts"] = 1

    # (4) the power-of-2 rescale primitive at the recipe's input gain
    shift = engine.recipe.input_exponent if engine.recipe else 5
    envelope = 8.0
    _assume(findings, "po2_rescale",
            f"normalised activations |x| <= {envelope} entering the input "
            f"gain 2^{shift} (post-LayerNorm envelope)")
    f5, _ = analyze_fn(
        lambda v: fxp.fixed_shift_mul(fxp.to_fixed(v), shift),
        (torch.zeros((4,), device=dev),), [Interval(-envelope, envelope)],
        label="po2_rescale")
    findings += f5
    metrics["violations"] = sum(
        1 for f in findings if f.severity == "violation")
    return PassResult("ranges", findings, metrics)
