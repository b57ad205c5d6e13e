"""Record a program's ATen ops by running it: the port's twin of the
reference's jaxpr walker.

The reference traces a jitted program with ``jax.make_jaxpr`` and walks
its equations.  Eager PyTorch has no program to trace, so the port runs
the function once under a ``TorchDispatchMode`` (with ``torch.no_grad``)
and records every ATen op that reaches the dispatcher: its name, the
shapes and dtypes of its tensor inputs and outputs, and the repo frames
it was called from (innermost first), taken from the Python stack and
kept to files under ``src/repro_torch/``.

Python loops simply run, so the reference's call-like primitives have no
counterpart here: a loop's body is recorded once per trip (the
reference's ``scan`` multiplier and its ``while`` note are not needed),
and of a branch only the one taken is recorded.

Hand-written kernels are priced by what they compute, not by what runs
them: a kernel wrapper (``kernels.ops``) that finds :data:`recorder` set
reports one **charge** — its op class, operations and bytes — through
:func:`charged` and runs its body with recording muted.  On the card the
kernel itself is launched through ``ctypes`` and no dispatch mode sees
it; on the CPU the wrapper takes its plain version, whose ATen ops are
muted, so a ``cuda`` plan records the same on either device.

**Dataflow.** The verification passes (:mod:`repro_torch.analysis`) need
to know which tensor feeds which op: :func:`walk` records the same ops
with a tensor identity on every input and output (``in_ids`` /
``out_ids``), the op itself and its arguments with each tensor replaced by
a :class:`Ref`.  Identity is per tensor object; a view (an op whose
schema returns an alias of its input) is given its base's **buffer**, so
that liveness can charge a view nothing and keep its base alive.  A
kernel charge carries its operands' and results' identities too, so
taint and liveness flow through a kernel launched by ``ctypes`` whose own
ops are muted.  With ``values=True`` every tensor that does not depend on
the walk's declared inputs — one no recorded op produced (the LUT
tables, constants), or one an op computed from such tensors only — is
kept with its concrete min/max (the reference's constvars).  A walk
records only the branch its inputs take: the analysed functions branch
on Python values (shapes, modes, exponents), never on tensor data.

The helper names are the reference's: :func:`user_frames`,
:func:`frame_functions`, :func:`user_site` and :func:`tensor_bytes` (the
counterpart of ``aval_bytes``).
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import sys
import weakref
from typing import Any, Optional

import torch
from torch.overrides import TorchFunctionMode
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils._pytree import tree_map as _pytree_map

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_PREFIX = _PKG_DIR + os.sep
_THIS_FILE = os.path.abspath(__file__)
_IS_REPO: dict = {}          # code filename -> is a repo frame


@dataclasses.dataclass(frozen=True)
class Frame:
    """One repo-level stack frame (the reference's ``Frame`` fields)."""

    function_name: str
    file_name: str
    start_line: int


@dataclasses.dataclass(frozen=True)
class TensorMeta:
    """Shape and dtype of one operand; ``view`` marks a tensor that shares
    another's storage (a layout copy of it moves nothing new)."""

    shape: tuple
    dtype: torch.dtype
    view: bool = False

    @property
    def numel(self) -> int:
        n = 1
        for s in self.shape:
            n *= int(s)
        return n


@dataclasses.dataclass(frozen=True)
class OpRecord:
    """One recorded ATen op, or one kernel charge (``charge`` is then
    ``(op class, operations, bytes)`` and ``name`` is ``"charge"``).
    ``scalars`` counts the Python numbers among the positional arguments
    (an element-wise op's scalar operands); ``einsum`` marks an op that a
    ``torch.einsum`` call dispatched (one of its pairwise products)."""

    name: str
    inputs: tuple
    outputs: tuple
    frames: tuple
    charge: Optional[tuple] = None
    scalars: int = 0
    einsum: bool = False
    # dataflow walks (:func:`walk`) only: the identity of each input and
    # output tensor, the op, its arguments (tensors as :class:`Ref`); and,
    # on a kernel charge, ``(kernel name, launch geometry)``
    in_ids: tuple = ()
    out_ids: tuple = ()
    func: Any = None
    args: tuple = ()
    kwargs: Any = None
    launch: Optional[tuple] = None


@dataclasses.dataclass(frozen=True)
class Ref:
    """A tensor argument of a dataflow record: its identity."""

    ident: int


def _is_repo(filename: str) -> bool:
    hit = _IS_REPO.get(filename)
    if hit is None:
        path = os.path.abspath(filename)
        hit = _IS_REPO[filename] = \
            path.startswith(_PREFIX) and path != _THIS_FILE
    return hit


def stack_frames(depth: int = 1) -> tuple:
    """The repo frames of the current Python stack, innermost first."""
    out = []
    f = sys._getframe(depth)
    while f is not None:
        code = f.f_code
        if _is_repo(code.co_filename):
            out.append(Frame(code.co_qualname, code.co_filename, f.f_lineno))
        f = f.f_back
    return tuple(out)


def _meta(t: torch.Tensor) -> TensorMeta:
    return TensorMeta(tuple(t.shape), t.dtype, t._is_view())


def _metas(tree) -> tuple:
    return tuple(_meta(t) for t in tree_leaves(tree)
                 if isinstance(t, torch.Tensor))


_POW_SCALAR = torch.ops.aten.pow.Tensor_Scalar
_VIEW_OPS: dict = {}         # OpOverload -> returns an alias of an input


def _is_view_op(func) -> bool:
    hit = _VIEW_OPS.get(func)
    if hit is None:
        hit = _VIEW_OPS[func] = any(
            r.alias_info is not None and not r.alias_info.is_write
            for r in func._schema.returns)
    return hit


def _tensors(tree) -> list:
    return [t for t in tree_leaves(tree) if isinstance(t, torch.Tensor)]


def concrete(t: torch.Tensor) -> tuple:
    """``(min, max)`` of a tensor's values as Python numbers (``(0, 0)``
    when empty)."""
    if t.numel() == 0:
        return (0, 0)
    if t.dtype == torch.bool:
        return (int(t.min()), int(t.max()))
    lo, hi = t.min().item(), t.max().item()
    return (lo, hi)


class Recorder(TorchDispatchMode):
    """Appends one :class:`OpRecord` per ATen op while not muted; with
    ``dataflow`` set, with identities (module docstring)."""

    def __init__(self, dataflow: bool = False, values: bool = False):
        super().__init__()
        self.records: list = []
        self.muted = 0
        self.einsum = 0          # depth of torch.einsum calls in progress
        self.dataflow = dataflow or values
        self.values = values
        self._ids: dict = {}     # id(tensor) -> (identity, weakref)
        self._next = 0
        self.buffer: dict = {}   # identity -> identity of its buffer
        self.nbytes: dict = {}   # identity -> bytes at its creation
        self.produced: set = set()
        self.consts: dict = {}   # identity -> (min, max), values walks
        self.depends: set = set()   # identities computed from the inputs

    def ident(self, t: torch.Tensor) -> tuple:
        """``(identity, first seen)`` of a tensor object."""
        hit = self._ids.get(id(t))
        if hit is not None and hit[1]() is t:
            return hit[0], False
        i = self._next
        self._next += 1
        self._ids[id(t)] = (i, weakref.ref(t))
        self.buffer[i] = i
        self.nbytes[i] = tensor_bytes(t)
        return i, True

    def lookup(self, t) -> Optional[int]:
        """The identity of a tensor the walk saw, or None."""
        hit = self._ids.get(id(t))
        return hit[0] if hit is not None and hit[1]() is t else None

    def declare(self, t: torch.Tensor) -> int:
        i, _ = self.ident(t)
        self.depends.add(i)
        return i

    def _inputs(self, ts) -> tuple:
        ids = []
        for t in ts:
            i, new = self.ident(t)
            if new and self.values:
                self.consts[i] = self._concrete(t)
            ids.append(i)
        return tuple(ids)

    def _outputs(self, ts, in_ids, view: bool) -> tuple:
        dep = any(i in self.depends for i in in_ids)
        ids = []
        for t in ts:
            i, new = self.ident(t)
            if new and view and in_ids:
                self.buffer[i] = self.buffer[in_ids[0]]
            self.produced.add(i)
            if dep:
                self.depends.add(i)
            elif self.values and new:
                self.consts[i] = self._concrete(t)
            ids.append(i)
        return tuple(ids)

    def _concrete(self, t):
        self.muted += 1          # its reductions are not the program's
        try:
            return concrete(t)
        finally:
            self.muted -= 1

    def _ref(self, a):
        return Ref(self.ident(a)[0]) if isinstance(a, torch.Tensor) else a

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if not self.muted:
            name = func.overloadpacket.__name__
            if func is _POW_SCALAR and args[1] == 2:
                name = "square"         # x.square(): the reference's square
            flow = {}
            if self.dataflow:
                in_ids = self._inputs(_tensors((args, kwargs)))
                flow = dict(
                    in_ids=in_ids,
                    out_ids=self._outputs(_tensors(out), in_ids,
                                          _is_view_op(func)),
                    func=func, args=_pytree_map(self._ref, tuple(args)),
                    kwargs=_pytree_map(self._ref, dict(kwargs)))
            self.records.append(OpRecord(
                name, _metas((args, kwargs)),
                _metas(out), stack_frames(2),
                scalars=sum(isinstance(a, (int, float)) for a in args),
                einsum=self.einsum > 0, **flow))
        return out


class _EinsumDepth(TorchFunctionMode):
    """Marks the ATen ops a ``torch.einsum`` call dispatches.  The
    reference's ``jnp.einsum`` takes a contraction of several operands
    pairwise, each pair one ``dot_general`` even where nothing is summed;
    PyTorch does such a pair as a ``mul``."""

    def __init__(self, rec: Recorder):
        super().__init__()
        self.rec = rec

    def __torch_function__(self, func, types, args=(), kwargs=None):
        if func is not torch.functional.einsum:
            return func(*args, **(kwargs or {}))
        self.rec.einsum += 1
        try:
            return func(*args, **(kwargs or {}))
        finally:
            self.rec.einsum -= 1


# The recorder of the walk in progress, or None.  Kernel wrappers test it
# on every call, so it is a plain module attribute.
recorder: Optional[Recorder] = None


def charged(charges, fn, *args, **kwargs):
    """``fn(*args, **kwargs)`` as one priced call of the walk in progress:
    one record per ``(op class, operations, bytes)`` of ``charges``, with
    the caller's frames, and none of ``fn``'s ATen ops (nor of a charge
    inside it)."""
    return _charged(charges, None, fn, args, kwargs)


def charged_launch(charges, launch, fn, *args, **kwargs):
    """:func:`charged` for a kernel launch: the records also carry
    ``launch``, ``(kernel name, geometry)`` (``analysis.geometry``)."""
    return _charged(charges, launch, fn, args, kwargs)


def _charged(charges, launch, fn, args, kwargs):
    rec = recorder
    if rec.muted:
        return fn(*args, **kwargs)
    frames = stack_frames(3)
    in_ids = rec._inputs(_tensors((args, kwargs))) if rec.dataflow else ()
    rec.muted += 1
    try:
        out = fn(*args, **kwargs)
    finally:
        rec.muted -= 1
    out_ids = rec._outputs(_tensors(out), in_ids, False) \
        if rec.dataflow else ()
    # one launch, on the first of its charges
    rec.records.extend(
        OpRecord("charge", (), (), frames, (op, float(f), float(b)),
                 in_ids=in_ids, out_ids=out_ids,
                 launch=launch if n == 0 else None)
        for n, (op, f, b) in enumerate(charges))
    return out


def record(fn, *args, **kwargs) -> tuple:
    """Run ``fn(*args, **kwargs)`` under ``torch.no_grad`` and return
    ``(output, records)``.  Walks do not nest."""
    rec = Recorder()
    out = _run(rec, fn, args, kwargs)
    return out, rec.records


@dataclasses.dataclass
class Walk:
    """What :func:`walk` returns: the output, the records and the
    recorder's identity tables."""

    output: Any
    records: list
    recorder: Recorder
    declared: tuple          # identities of the declared input tensors

    def ident(self, t) -> Optional[int]:
        """The identity of a tensor the walk saw (None if unseen)."""
        return self.recorder.lookup(t)

    @property
    def output_ids(self) -> tuple:
        return tuple(i for i in map(self.ident, _tensors(self.output))
                     if i is not None)


def walk(fn, *args, values: bool = False, declared=None, **kwargs) -> Walk:
    """Run ``fn(*args, **kwargs)`` once under the recorder with dataflow
    (module docstring).  ``declared`` are the input tensors (default: the
    tensors among ``args``); with ``values=True`` every tensor that does
    not depend on them carries its concrete min/max."""
    rec = Recorder(dataflow=True, values=values)
    decl = tuple(rec.declare(t) for t in _tensors(
        args if declared is None else declared))
    out = _run(rec, fn, args, kwargs)
    return Walk(out, rec.records, rec, decl)


def run_with(rec: Recorder, fn, args, einsum: bool = True):
    """``fn(*args)`` under ``rec`` (a :class:`Recorder` of the caller's)
    with ``torch.no_grad``; its records stay in ``rec``.  ``einsum=False``
    leaves the records' ``einsum`` marks unset (a walk that reads no
    cost, spared the function mode's toll on every call)."""
    return _run(rec, fn, args, {}, einsum)


def _run(rec: Recorder, fn, args, kwargs, einsum: bool = True):
    global recorder
    if recorder is not None:
        raise RuntimeError("op_walk.record does not nest")
    marks = _EinsumDepth(rec) if einsum else contextlib.nullcontext()
    with torch.no_grad(), marks, rec:
        recorder = rec
        try:
            return fn(*args, **kwargs)
        finally:
            recorder = None


# -- the reference's helper names ---------------------------------------------

def user_frames(rec: OpRecord) -> list:
    """Repo-level stack frames (innermost first) of a record."""
    return list(rec.frames)


def frame_functions(rec: OpRecord) -> list:
    """Function names of the user frames (innermost first)."""
    return [f.function_name for f in rec.frames]


def user_site(rec: OpRecord) -> str:
    """Human-readable innermost repo frame: ``fn (file.py:line)``."""
    if not rec.frames:
        return ""
    f = rec.frames[0]
    fname = f.file_name.rsplit(os.sep, 1)[-1]
    return f"{f.function_name} ({fname}:{f.start_line})"


def tensor_bytes(meta) -> int:
    """Buffer bytes of a tensor or its :class:`TensorMeta` (bools count
    one byte)."""
    if isinstance(meta, torch.Tensor):
        meta = _meta(meta)
    return meta.numel * max(meta.dtype.itemsize, 1)
