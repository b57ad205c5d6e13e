"""Fault-tolerant checkpointing: npz shard + manifest, atomic, async.

The reference's on-disk layout, so that a checkpoint written by either
package restores in the other::

  step_000100.tmp-<nonce>/         <- written first
    manifest.json                  <- step, leaf count, shapes, dtypes
    shard_0.npz                    <- leaf_<i> arrays
  step_000100/                     <- atomic rename on completion

A checkpoint is valid iff the rename completed, so a crash mid-save never
corrupts the restore path (restore picks the newest *complete* step).

Leaves are written in ``jax.tree.flatten`` order: dict keys sorted, and a
:class:`~repro_torch.core.quant.QTensor` flattened into its array fields
(``values``, then ``axis_exponents`` where there is one) at their stored
dtypes — int8, or nibble-packed uint8 — while its static fields
(exponent, bits, logical shape) come from the restore target, as they
ride the reference's pytree structure.  The manifest's ``treedef`` is
informational: neither package reads it back.
"""

from __future__ import annotations

import dataclasses
import json
import os
import shutil
import threading
import uuid

import numpy as np
import torch

from repro_torch.core.quant import QTensor
from repro_torch.core.tree import tree_leaves_sorted, tree_unflatten_sorted

_SENTINEL = "manifest.json"


def _array_leaves(tree) -> list:
    """The tree's arrays in the reference's flatten order."""
    out = []
    for leaf in tree_leaves_sorted(tree):
        if isinstance(leaf, QTensor):
            out.append(leaf.values)
            if leaf.axis_exponents is not None:
                out.append(leaf.axis_exponents)
        else:
            out.append(leaf)
    return out


def _host(leaf) -> np.ndarray:
    """A host copy that later writes to the tensor cannot reach."""
    if isinstance(leaf, torch.Tensor):
        return np.array(leaf.detach().cpu().numpy(), copy=True)
    return np.array(leaf, copy=True)


def save(ckpt_dir: str, step: int, tree, *, blocking: bool = True):
    """Serialise a tree.  Returns the writer thread when
    ``blocking=False`` (the leaves are copied to the host first)."""
    host_leaves = [_host(leaf) for leaf in _array_leaves(tree)]

    def _write():
        d_final = os.path.join(ckpt_dir, f"step_{step:08d}")
        d_tmp = d_final + f".tmp-{uuid.uuid4().hex[:8]}"
        os.makedirs(d_tmp, exist_ok=True)
        np.savez(os.path.join(d_tmp, "shard_0.npz"),
                 **{f"leaf_{i}": a for i, a in enumerate(host_leaves)})
        manifest = {
            "step": step,
            "n_leaves": len(host_leaves),
            "treedef": f"repro_torch tree of {len(host_leaves)} sorted leaves",
            "shapes": [list(a.shape) for a in host_leaves],
            "dtypes": [str(a.dtype) for a in host_leaves],
        }
        with open(os.path.join(d_tmp, _SENTINEL), "w") as f:
            json.dump(manifest, f)
        if os.path.exists(d_final):
            shutil.rmtree(d_final)
        os.rename(d_tmp, d_final)

    if blocking:
        _write()
        return None
    t = threading.Thread(target=_write, daemon=True)
    t.start()
    return t


def is_complete(ckpt_dir: str, step: int) -> bool:
    """True iff the step's directory is a fully materialised checkpoint
    (manifest parses, payload shard present)."""
    d = os.path.join(ckpt_dir, f"step_{step:08d}")
    try:
        with open(os.path.join(d, _SENTINEL)) as f:
            json.load(f)
    except (OSError, ValueError):
        return False
    return os.path.exists(os.path.join(d, "shard_0.npz"))


def latest_step(ckpt_dir: str) -> int | None:
    """Newest step with a *complete* checkpoint; in-flight ``.tmp-*``
    dirs, unparsable names and manifest- or payload-less directories are
    skipped, never an exception."""
    if not os.path.isdir(ckpt_dir):
        return None
    steps = []
    for name in os.listdir(ckpt_dir):
        if not name.startswith("step_") or ".tmp" in name:
            continue
        try:
            step = int(name.split("_")[1])
        except ValueError:          # step_garbage, step_ etc.
            continue
        if is_complete(ckpt_dir, step):
            steps.append(step)
    return max(steps) if steps else None


def restore(ckpt_dir: str, step: int, target_tree):
    """Load into the structure of ``target_tree``: every array leaf gets
    the target leaf's dtype and device, a QTensor its static fields."""
    d = os.path.join(ckpt_dir, f"step_{step:08d}")
    with np.load(os.path.join(d, "shard_0.npz")) as data:
        arrays = [data[f"leaf_{i}"] for i in range(len(data.files))]
    targets = _array_leaves(target_tree)
    if len(arrays) != len(targets):
        raise ValueError(f"checkpoint {d} holds {len(arrays)} leaves, the "
                         f"target tree {len(targets)}")
    it = iter(arrays)

    def load(ref: torch.Tensor) -> torch.Tensor:
        a = next(it)
        if tuple(a.shape) != tuple(ref.shape):
            raise ValueError(f"checkpoint leaf of shape {a.shape}, target "
                             f"{tuple(ref.shape)}")
        return torch.from_numpy(a).to(device=ref.device, dtype=ref.dtype)

    leaves = []
    for leaf in tree_leaves_sorted(target_tree):
        if isinstance(leaf, QTensor):
            values = load(leaf.values)
            axis = None if leaf.axis_exponents is None else \
                load(leaf.axis_exponents)
            leaves.append(dataclasses.replace(leaf, values=values,
                                              axis_exponents=axis))
        else:
            leaves.append(load(leaf))
    return tree_unflatten_sorted(target_tree, leaves)
