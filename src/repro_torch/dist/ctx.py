"""Mesh/sharding context: the model code's "where am I running".

The reference's model code calls the helpers below at every activation
boundary; they resolve to a no-op off a device mesh (a single device —
the KWT path) or to a sharding constraint on the ambient mesh inside

    with mesh, ctx.mesh_context(dp_axes, seq_axis=...):
        ...

The port runs on one device until ROADMAP queue A item 4 brings meshes,
so every helper here is the reference's off-mesh no-op: ``mesh_context``
records the declared axes (and restores the outer declaration on exit),
``dp_axes`` reads them back, and the activation helpers return their
input unchanged.  The API is the reference's, so that the serving cell
and, later, the mesh programs call it as they would there.
"""

from __future__ import annotations

import contextlib
import threading

TP = "model"   # tensor-parallel axis name


class _State(threading.local):
    active = False
    dp = None
    seq_axis = None


_STATE = _State()


@contextlib.contextmanager
def mesh_context(dp_axes, seq_axis=None):
    """Declare the data-parallel axes (and optional Megatron-SP sequence
    axis) that activation constraints would shard over.  Contexts nest;
    the outer declaration is restored on exit."""
    prev = (_STATE.active, _STATE.dp, _STATE.seq_axis)
    _STATE.active = True
    _STATE.dp = tuple(dp_axes) if dp_axes else None
    _STATE.seq_axis = seq_axis
    try:
        yield
    finally:
        _STATE.active, _STATE.dp, _STATE.seq_axis = prev


def _mesh_active() -> bool:
    """Whether the model code runs on a device mesh.  The reference needs
    ``mesh_context`` and an entered device mesh; the port has no device
    mesh until ROADMAP queue A item 4, so this is always False."""
    return False


def dp_axes():
    """The data-parallel axes declared by the enclosing ``mesh_context``."""
    return _STATE.dp


def shard_activations(x):
    """[B, S, D] activations: batch over the DP axes on a mesh.  No-op on
    one device."""
    return x


def unshard_seq(x):
    """Gather Megatron-SP sequence shards; no-op on one device."""
    return x


def shard_logits(x):
    """[B, S, V] logits: batch over DP, vocab over TP on a mesh; no-op on
    one device."""
    return x
