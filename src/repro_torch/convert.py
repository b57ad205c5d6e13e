"""Carry parameters between the reference package and the port, as numpy.

The two packages share the parameter tree layout (nested dicts and lists,
``models/kwt.py``), so a tree crosses by turning every array leaf into a
numpy array on one side and into a tensor on the other.  Quantised leaves
cross too: anything that looks like a QTensor (``values``, ``exponent``,
``axis_exponents``, ``bits``, ``logical_shape`` — the reference's
dataclass with numpy fields, or the dict :func:`to_numpy_tree` writes)
becomes a ``repro_torch.core.quant.QTensor`` with the same stored bytes,
so a tree quantised by the reference deploys in the port as-is.

This module imports neither package of the reference nor jax; the caller
does ``jax.tree.map(np.asarray, params)`` on its side.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.core.quant import QTensor
from repro_torch.device import resolve_device

_QT_FIELDS = ("values", "exponent", "axis_exponents", "bits", "logical_shape")


def qtensor_from_numpy(values, exponent, axis_exponents=None, bits=8,
                       logical_shape=None, device=None) -> QTensor:
    """A stored-integer leaf from its numpy parts (no re-quantisation: the
    payload bytes are taken as they are).  ``device=None`` is the card."""
    device = resolve_device(device)
    axis = None if axis_exponents is None else \
        torch.from_numpy(np.array(axis_exponents)).to(device)
    shape = None if logical_shape is None else tuple(int(s) for s in logical_shape)
    return QTensor(values=torch.from_numpy(np.array(values)).to(device),
                   exponent=int(exponent), axis_exponents=axis,
                   bits=int(bits), logical_shape=shape)


def _qtensor_fields(leaf) -> dict | None:
    if isinstance(leaf, dict):
        return leaf if set(leaf) == set(_QT_FIELDS) else None
    if all(hasattr(leaf, f) for f in _QT_FIELDS):
        return {f: getattr(leaf, f) for f in _QT_FIELDS}
    return None


def from_numpy_tree(tree: Any, device=None) -> Any:
    """numpy tree (reference layout) -> the port's tree on ``device``
    (``None`` is the card, and raises where there is none)."""
    device = resolve_device(device)
    fields = _qtensor_fields(tree)
    if fields is not None:
        return qtensor_from_numpy(**fields, device=device)
    if isinstance(tree, dict):
        return {k: from_numpy_tree(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(from_numpy_tree(v, device) for v in tree)
    if isinstance(tree, (np.ndarray, np.generic)):
        return torch.from_numpy(np.array(tree)).to(device)
    return tree


def to_numpy_tree(tree: Any) -> Any:
    """The port's tree -> numpy arrays; a QTensor becomes a dict of its
    fields that :func:`from_numpy_tree` reads back."""
    if isinstance(tree, QTensor):
        axis = tree.axis_exponents
        return {"values": tree.values.cpu().numpy(),
                "exponent": tree.exponent,
                "axis_exponents": None if axis is None else axis.cpu().numpy(),
                "bits": tree.bits, "logical_shape": tree.logical_shape}
    if isinstance(tree, dict):
        return {k: to_numpy_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(to_numpy_tree(v) for v in tree)
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().numpy()
    return tree
