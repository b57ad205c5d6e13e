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

``make_production_mesh(multi_pod)`` is the reference's production mesh,
(16, 16) ``("data", "model")`` or (2, 16, 16) ``("pod", "data",
"model")``, for the dry run (``launch.dryrun``): a ``DeviceMesh`` over a
**fake** process group of 512 ranks (``torch.distributed``'s ``fake``
backend: every collective returns at once and moves nothing), this
process being rank 0; the single pod is its first 256 ranks.  The fake
world is set up by :func:`init_fake_world`, which only the dry run and
its tests call (it takes the process's one process group, where the
reference sets ``XLA_FLAGS`` before jax starts).  The H100 constants
are re-exported here as the reference re-exports its v5e ones.
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


PRODUCTION_WORLD = 512


def init_fake_world(world: int = PRODUCTION_WORLD) -> None:
    """Make this process rank 0 of a fake ``world``-rank process group
    (the dry run's: shapes and collectives are recorded, nothing moves).
    A process group already there must be a fake one of ``world`` ranks;
    a host without the fake backend raises, naming it."""
    import torch.distributed as dist

    try:
        from torch.testing._internal.distributed.fake_pg import FakeStore
    except ImportError as e:
        raise RuntimeError(
            "the dry run's production mesh needs torch.distributed's fake "
            "process group (torch.testing._internal.distributed.fake_pg), "
            "which this torch build lacks") from e
    if dist.is_initialized():
        if dist.get_backend() != "fake" or dist.get_world_size() != world:
            raise RuntimeError(
                f"a {dist.get_backend()} process group of "
                f"{dist.get_world_size()} ranks is set up: the fake "
                f"{world}-rank world needs a process of its own")
        return
    dist.init_process_group("fake", rank=0, world_size=world,
                            store=FakeStore())


def make_production_mesh(*, multi_pod: bool = False):
    """The reference's production mesh as a ``DeviceMesh`` over the fake
    world (:func:`init_fake_world`, which must have run): (16, 16)
    ``("data", "model")`` on ranks 0-255, or (2, 16, 16) ``("pod",
    "data", "model")`` on all 512."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    if not dist.is_initialized() or dist.get_backend() != "fake":
        raise RuntimeError("make_production_mesh runs over the fake world: "
                           "call launch.mesh.init_fake_world() first")
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    ranks = torch.arange(math.prod(shape)).reshape(shape)
    return DeviceMesh("cpu", ranks, mesh_dim_names=axes)


def dp_axes(mesh) -> tuple:
    """The data-parallel axes of a mesh ('pod' included when present)."""
    return tuple(a for a in ("pod", "data")
                 if a in sharding.axis_names(mesh))


# H100 hardware constants, re-exported from the shared machine model in
# repro_torch.perf.roofline so launch planning and the perf layer can
# never disagree on the card's envelope.  NVLink is launch-specific (the
# two-ceiling roofline model has no interconnect term).
from repro_torch.perf.roofline import (          # noqa: E402
    H100_HBM_BW as HBM_BW,
    H100_HBM_BYTES as HBM_BYTES,
    H100_NVLINK_BW as NVLINK_BW,
    H100_PEAK_FLOPS_BF16 as PEAK_FLOPS_BF16,
    H100_PEAK_OPS_INT8 as PEAK_OPS_INT8,
)
