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

The helper names are the reference's: :func:`user_frames`,
:func:`frame_functions`, :func:`user_site` and :func:`tensor_bytes` (the
counterpart of ``aval_bytes``).
"""

from __future__ import annotations

import dataclasses
import os
import sys
from typing import Optional

import torch
from torch.overrides import TorchFunctionMode
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

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


class Recorder(TorchDispatchMode):
    """Appends one :class:`OpRecord` per ATen op while not muted."""

    def __init__(self):
        super().__init__()
        self.records: list = []
        self.muted = 0
        self.einsum = 0          # depth of torch.einsum calls in progress

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if not self.muted:
            name = func.overloadpacket.__name__
            if func is _POW_SCALAR and args[1] == 2:
                name = "square"         # x.square(): the reference's square
            self.records.append(OpRecord(
                name, _metas((args, kwargs)),
                _metas(out), stack_frames(2),
                scalars=sum(isinstance(a, (int, float)) for a in args),
                einsum=self.einsum > 0))
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
    rec = recorder
    if not rec.muted:
        frames = stack_frames(2)
        rec.records.extend(
            OpRecord("charge", (), (), frames, (op, float(f), float(b)))
            for op, f, b in charges)
    rec.muted += 1
    try:
        return fn(*args, **kwargs)
    finally:
        rec.muted -= 1


def record(fn, *args, **kwargs) -> tuple:
    """Run ``fn(*args, **kwargs)`` under ``torch.no_grad`` and return
    ``(output, records)``.  Walks do not nest."""
    global recorder
    if recorder is not None:
        raise RuntimeError("op_walk.record does not nest")
    rec = Recorder()
    with torch.no_grad(), _EinsumDepth(rec), rec:
        recorder = rec
        try:
            out = fn(*args, **kwargs)
        finally:
            recorder = None
    return out, rec.records


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
