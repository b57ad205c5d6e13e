"""Host mesh construction for the port.

``make_host_mesh(data, model)`` is the mesh the launchers run on: with a
``torch.distributed`` process group initialised, a ``DeviceMesh`` with
axes ``("data", "model")`` over the world's ranks (``data * model`` must
equal the world size), on the device type of the entry point's device —
``cuda`` beside NCCL, ``cpu`` beside gloo.  Without a process group it
is the one-device :class:`HostMesh` the reference builds on a one-device
host — shape (1, 1) — whose context is a no-op: the port's single-device
path.  ``dp_axes`` is the reference's.

A one-rank ``DeviceMesh`` (one card, NCCL) runs every mesh code path on
its one rank; NCCL refuses two ranks on one card, so a mesh of several
ranks needs a card each, or gloo on the CPU.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.dist import sharding


@dataclasses.dataclass(frozen=True)
class HostMesh:
    """A device mesh over the port's single device."""

    shape: tuple = (1, 1)
    axis_names: tuple = ("data", "model")

    @property
    def size(self) -> int:
        return math.prod(self.shape)

    @property
    def empty(self) -> bool:
        return False

    def __enter__(self) -> "HostMesh":
        return self

    def __exit__(self, *exc) -> None:
        return None


def make_host_mesh(data: int = 1, model: int = 1, device=None):
    """A ``DeviceMesh`` of shape ``(data, model)`` over the process
    group's ranks, or the one-device :class:`HostMesh` without a process
    group (``data`` and ``model`` then clamp to one device, as the
    reference clamps them to the host's device count).  ``device`` (a
    torch device or its type) picks the mesh's device type; by default
    ``cuda`` under an NCCL group, else ``cpu``."""
    import torch.distributed as dist

    if not (dist.is_available() and dist.is_initialized()):
        return HostMesh(shape=(1, 1))
    world = dist.get_world_size()
    if data * model != world:
        raise ValueError(f"a ({data}, {model}) mesh needs {data * model} "
                         f"ranks; the process group has {world}")
    if device is None:
        kind = "cuda" if dist.get_backend() == "nccl" else "cpu"
    else:
        kind = torch.device(device).type
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh(kind, (data, model),
                            mesh_dim_names=("data", "model"))


def dp_axes(mesh) -> tuple:
    """The data-parallel axes of a mesh ('pod' included when present)."""
    return tuple(a for a in ("pod", "data")
                 if a in sharding.axis_names(mesh))
