"""Host mesh construction for the port: one device.

The reference builds ``jax`` device meshes (``make_host_mesh`` over the
host's devices, ``make_production_mesh`` for TPU pods).  The port serves
and trains on one card until ROADMAP queue A item 4 brings multi-device
meshes, so ``make_host_mesh`` returns the one-device mesh the reference
builds on a one-device host — axes ``("data", "model")``, shape (1, 1) —
as a :class:`HostMesh` whose context is a no-op.  ``dp_axes`` is the
reference's.
"""

from __future__ import annotations

import dataclasses
import math


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


def make_host_mesh(data: int = 1, model: int = 1) -> HostMesh:
    """The mesh over the devices the port uses (one): ``data`` and
    ``model`` are clamped to it, as the reference clamps them to the
    host's device count."""
    n = 1
    data = min(data, n)
    model = max(1, min(model, n // data))
    return HostMesh(shape=(data, model))


def dp_axes(mesh) -> tuple:
    """The data-parallel axes of a mesh ('pod' included when present)."""
    return tuple(a for a in ("pod", "data") if a in mesh.axis_names)
