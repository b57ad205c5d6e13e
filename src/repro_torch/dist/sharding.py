"""Partition specs and their placements on a ``torch.distributed`` mesh.

:class:`P` is the port's own ``jax.sharding.PartitionSpec``: one entry
per tensor dim, each an axis name, ``None`` (replicated) or a tuple of
names (the dim split over several mesh axes, major first).  A
one-name tuple reads as the name, as ``PartitionSpec`` normalises it.
The models' ``*_specs(cfg)`` build trees of them with the same structure
as their parameter trees.

On a ``DeviceMesh`` with named dims (``launch.mesh.make_host_mesh``:
``("data", "model")``) a spec becomes ``torch.distributed.tensor``
placements (:func:`placements`): ``Shard(d)`` on every mesh dim that
tensor dim ``d`` names, ``Replicate()`` on the others.  Names the mesh
lacks are dropped, as the reference's ``ctx._present`` drops them, so
one spec tree serves ``(data,)``, ``(data, model)`` and ``(pod, data,
model)`` meshes.  Shards follow ``torch.chunk`` (a dim that does not
divide gives uneven shards, the last ones shorter or empty), where
GSPMD pads.

:func:`place` turns a tree of full tensors (equal on every rank, as a
seeded ``init_params`` makes them) into ``DTensor`` s by cutting each
rank's own shard locally: no communication.  :func:`full` gathers a
placed tree back (a checkpoint's save).
"""

from __future__ import annotations

import math

import torch

from repro_torch.core.tree import tree_map


class P:
    """A partition spec: per tensor dim an axis name, ``None`` or a tuple
    of names.  Equal to another ``P`` or a tuple with the same entries."""

    __slots__ = ("parts",)

    def __init__(self, *parts):
        self.parts = tuple(_norm(p) for p in parts)

    def __iter__(self):
        return iter(self.parts)

    def __len__(self) -> int:
        return len(self.parts)

    def __getitem__(self, i):
        return self.parts[i]

    def __eq__(self, other) -> bool:
        if isinstance(other, P):
            return self.parts == other.parts
        if isinstance(other, tuple):
            return self.parts == tuple(_norm(p) for p in other)
        return NotImplemented

    def __hash__(self) -> int:
        return hash(self.parts)

    def __repr__(self) -> str:
        return "P(" + ", ".join(repr(p) for p in self.parts) + ")"


def _norm(part):
    if isinstance(part, (tuple, list)):
        part = tuple(part)
        if not part:
            return None
        return part[0] if len(part) == 1 else part
    return part


def stacked(tree):
    """Every spec of ``tree`` with a leading unsharded layer dim (the
    stacked ``[n_layers, ...]`` block leaves)."""
    return tree_map(lambda s: P(None, *s), tree)


# ---------------------------------------------------------------------------
# Meshes
# ---------------------------------------------------------------------------

def is_device_mesh(mesh) -> bool:
    from torch.distributed.device_mesh import DeviceMesh
    return isinstance(mesh, DeviceMesh)


def axis_names(mesh) -> tuple:
    """The mesh's axis names (a ``DeviceMesh``'s dim names or a
    ``launch.mesh.HostMesh``'s)."""
    if is_device_mesh(mesh):
        return tuple(mesh.mesh_dim_names)
    return tuple(mesh.axis_names)


def axis_size(mesh, name: str) -> int:
    return int(dict(zip(axis_names(mesh), tuple(mesh.shape)))[name])


def present(axis, names):
    """``axis`` without the names the mesh lacks (``None`` if none is
    left), the reference's ``ctx._present``."""
    if axis is None:
        return None
    if isinstance(axis, (tuple, list)):
        kept = tuple(a for a in axis if a in names)
        return _norm(kept)
    return axis if axis in names else None


def placements(spec, mesh) -> tuple:
    """``spec`` as one placement per mesh dim: ``Shard(d)`` where tensor
    dim ``d`` names that mesh dim, ``Replicate()`` elsewhere."""
    from torch.distributed.tensor import Replicate, Shard

    names = axis_names(mesh)
    out = [Replicate()] * len(names)
    for d, part in enumerate(spec):
        part = present(part, names)
        for name in (part if isinstance(part, tuple) else (part,)):
            if name is not None:
                out[names.index(name)] = Shard(d)
    return tuple(out)


def _coordinate(mesh) -> list:
    coord = mesh.get_coordinate()
    return [0] * mesh.ndim if coord is None else list(coord)


def local_chunk(full: torch.Tensor, mesh, places, skip=()) -> torch.Tensor:
    """This rank's shard of ``full`` under ``places``: ``torch.chunk``
    per sharding mesh dim, in mesh-dim order (empty where the chunks run
    out, as ``DTensor`` shards).  Mesh dims named in ``skip`` are left
    whole (their dim is already this rank's)."""
    from torch.distributed.tensor import Shard

    names = axis_names(mesh)
    coord = _coordinate(mesh)
    out = full
    for i, pl in enumerate(places):
        if not isinstance(pl, Shard) or names[i] in skip:
            continue
        n = mesh.size(i)
        pieces = list(torch.chunk(out, n, dim=pl.dim))
        if coord[i] < len(pieces):
            out = pieces[coord[i]]
        else:
            out = out.narrow(pl.dim, 0, 0)
    return out


def from_local(local: torch.Tensor, mesh, places, shape) -> "torch.Tensor":
    """A ``DTensor`` of global ``shape`` whose shard here is ``local``."""
    from torch.distributed.tensor import DTensor

    stride = tuple(math.prod(shape[i + 1:]) for i in range(len(shape)))
    return DTensor.from_local(local, mesh, places, run_check=False,
                              shape=torch.Size(shape), stride=stride)


def is_dtensor(x) -> bool:
    try:
        from torch.distributed.tensor import DTensor
    except ImportError:          # a build without torch.distributed
        return False
    return isinstance(x, DTensor)


def place(tree, specs, mesh):
    """``tree`` (full tensors, the same on every rank) as ``DTensor`` s
    placed by ``specs`` (a same-structure tree of :class:`P`); a non-tensor
    leaf (a decode state's int index) is kept as it is."""
    def one(x, spec):
        if not isinstance(x, torch.Tensor):
            return x
        places = placements(spec, mesh)
        return from_local(local_chunk(x, mesh, places).contiguous(), mesh,
                          places, tuple(x.shape))
    return tree_map(one, tree, specs)


def full(tree):
    """A placed tree's full tensors (gathered where sharded); other
    leaves as they are."""
    return tree_map(lambda x: x.full_tensor() if is_dtensor(x) else x, tree)


def local(tree):
    """A placed tree's local shards; other leaves as they are."""
    return tree_map(lambda x: x.to_local() if is_dtensor(x) else x, tree)
