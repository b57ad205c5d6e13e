"""Mesh/sharding context: the model code's "where am I running".

The model code calls the helpers below at the reference's activation
boundaries.  They are no-ops off a device mesh (one device, the KWT
path, a ``launch.mesh.HostMesh``) and act on the entered ``DeviceMesh``
inside

    with mesh, ctx.mesh_context(dp_axes, seq_axis=...):
        ...

Axis conventions (``launch/mesh.py``): ``'pod'``, ``'data'`` are the
data-parallel axes (``dp_axes``); ``'model'`` the tensor-parallel one.
With ``seq_axis='model'`` the activations between blocks also shard
their sequence dim over it (Megatron-SP), gathered by ``unshard_seq``
before attention and the MLP.

The port runs a mesh in local view, as the reference's ``shard_map``
regions do: each rank's tensors are its own part.  A batch dim over the
DP axes is what each rank already holds (``dist.spmd`` hands it its data
shard), so a constraint to that layout moves nothing.  The sequence
constraints move data: ``shard_activations`` keeps this rank's chunk of
the sequence (``torch.chunk`` over the model ranks) and ``unshard_seq``
gathers the chunks back, each a ``DTensor`` ``redistribute`` on the
mesh's ``model`` dim — the counterpart of ``with_sharding_constraint``,
with its gradient (gather for a chunk, a chunk for a gather).  A tensor
already in the asked layout passes unchanged, so the calls may repeat
as the reference's do.  The layout is told by the sequence length
against the full length that the forward in progress declares
(``with ctx.sequence(S):``): a tensor of ``S`` positions is whole, any
other a chunk.  ``shard_logits`` gathers a chunked sequence and keeps
the vocabulary whole: the port's head runs on the gathered weight, so
each rank holds all of V and the loss needs no vocabulary-parallel
reduction.

The declarations are the calling thread's (as the entered ``DeviceMesh``
is).  Code that runs later on another thread takes them along:
:func:`snapshot` and :func:`resumed` (a checkpointed layer's recompute,
which autograd runs on its device thread on the card).
"""

from __future__ import annotations

import contextlib
import threading

import torch

TP = "model"   # tensor-parallel axis name


class _State(threading.local):
    active = False
    dp = None
    seq_axis = None
    seq = None        # the forward's full sequence length under SP


_STATE = _State()


@contextlib.contextmanager
def mesh_context(dp_axes, seq_axis=None):
    """Declare the data-parallel axes (and optional Megatron-SP sequence
    axis) that activation constraints shard over.  ``dp_axes`` may be
    None/() for a replicated batch.  Contexts nest; the outer declaration
    is restored on exit."""
    with _declared(True, tuple(dp_axes) if dp_axes else None, seq_axis,
                   None):
        yield


@contextlib.contextmanager
def _declared(active, dp, seq_axis, seq):
    prev = (_STATE.active, _STATE.dp, _STATE.seq_axis, _STATE.seq)
    _STATE.active, _STATE.dp, _STATE.seq_axis, _STATE.seq = \
        active, dp, seq_axis, seq
    try:
        yield
    finally:
        _STATE.active, _STATE.dp, _STATE.seq_axis, _STATE.seq = prev


@contextlib.contextmanager
def sequence(length: int):
    """Declare the full sequence length of the forward in progress: under
    Megatron-SP a tensor of ``length`` positions is whole, any other this
    rank's chunk."""
    with _declared(_STATE.active, _STATE.dp, _STATE.seq_axis, length):
        yield


def snapshot():
    """The calling thread's declarations and entered mesh, for
    :func:`resumed` on another thread."""
    return (_STATE.active, _STATE.dp, _STATE.seq_axis, _STATE.seq,
            current_mesh())


@contextlib.contextmanager
def resumed(snap):
    """Run under the declarations and the mesh of ``snap``
    (:func:`snapshot`), whichever thread this is."""
    *declared, mesh = snap
    with _declared(*declared), \
            (mesh if mesh is not None else contextlib.nullcontext()):
        yield


def current_mesh():
    """The innermost entered ``DeviceMesh`` (``with mesh:``), else None."""
    try:
        from torch.distributed.device_mesh import _mesh_resources
    except ImportError:          # a build without torch.distributed
        return None
    stack = getattr(_mesh_resources, "mesh_stack", None)
    return stack[-1] if stack else None


def _mesh_active() -> bool:
    """True only under ``mesh_context`` AND an entered ``DeviceMesh``
    (of one rank or more)."""
    return _STATE.active and current_mesh() is not None


def dp_axes():
    """The data-parallel axes declared by the enclosing ``mesh_context``."""
    return _STATE.dp


def _seq_sharded() -> bool:
    return _mesh_active() and _STATE.seq_axis is not None


def _model_mesh():
    return current_mesh()[_STATE.seq_axis]


def _full_length() -> int:
    if _STATE.seq is None:
        raise ValueError("Megatron-SP (seq_axis) tells a chunk from a whole "
                         "sequence by the forward's length: declare it "
                         "with ctx.sequence(S)")
    return _STATE.seq


def _is_chunk(x) -> bool:
    return x.shape[1] != _full_length()


def _redistribute(x, src, dst, full_len):
    from repro_torch.dist import sharding

    sub = _model_mesh()
    shape = (x.shape[0], full_len) + tuple(x.shape[2:])
    dt = sharding.from_local(x.contiguous(), sub, (src,), shape)
    return dt.redistribute(sub, (dst,)).to_local()


def shard_activations(x):
    """[B, S, D] activations: batch over the DP axes, sequence over the
    Megatron-SP axis when one was declared.  No-op off-mesh."""
    if not _seq_sharded() or _is_chunk(x):
        return x
    from torch.distributed.tensor import Replicate, Shard

    return _redistribute(x, Replicate(), Shard(1), x.shape[1])


def unshard_seq(x):
    """Gather Megatron-SP sequence shards (attention and the MLP need the
    whole sequence); no-op unless a ``seq_axis`` was declared."""
    if not _seq_sharded() or not _is_chunk(x):
        return x
    from torch.distributed.tensor import Replicate, Shard

    return _redistribute(x, Shard(1), Replicate(), _full_length())


def shard_logits(x):
    """[B, S, V] logits: batch over DP, the whole sequence (gathered under
    Megatron-SP) and, on this rank, the whole vocabulary.  No-op
    off-mesh."""
    return unshard_seq(x)


def embed_lookup(x):
    """The looked-up token embeddings ``[B, S, D]`` in the DP activation
    layout (the reference pins its table gather there).  In local view a
    rank's rows are its own batch shard already, so ``x`` is returned as
    it is, on a mesh or off it."""
    return x


# ---------------------------------------------------------------------------
# Collectives with their gradients, for the expert-parallel region
# ---------------------------------------------------------------------------

class _Enter(torch.autograd.Function):
    """Identity forward; the gradient summed over ``group`` (the region's
    input is replicated there, its uses are split across it)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        import torch.distributed as dist
        g = g.contiguous()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _Exit(torch.autograd.Function):
    """Sum over ``group`` forward; identity gradient (the sum is used
    replicated over ``group``)."""

    @staticmethod
    def forward(ctx, x, group):
        import torch.distributed as dist
        x = x.clone()
        dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, g):
        return g, None


def region_enter(x, group):
    return _Enter.apply(x, group)


def region_exit(x, group):
    return _Exit.apply(x, group)
