"""Collapse a trained QAT state into the deployable artifact.

``export(params, spec, qstate)`` freezes the learned weight exponent into
a ``QuantRecipe`` and quantises the float shadow weights through it —
exactly what ``runtime.compile_model(cfg, params, backend="lut",
recipe=...)`` does at plan time.  Because the QAT forward ran
``po2_fake_quant`` (the recipe's own cast) the whole way, the contract is
**bit-identity**: :func:`eval_forward` logits == the exported
non-executing ``lut`` engine's logits, ``torch.equal``.  Eager PyTorch
fuses nothing across the seam between the quantiser and the model, so
the reference's ``optimization_barrier`` has no counterpart here.

``save`` / ``load`` write and read the reference's artifact layout — a
``.npz`` of the leaves in ``jax.tree.leaves`` order (dict keys sorted, a
QTensor one leaf, stored as it is: int8 or nibble-packed uint8) beside a
``.json`` of the recipe and the leaves' metadata — so an artifact written
by either package loads in the other.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Any

import numpy as np
import torch

from repro_torch.convert import qtensor_from_numpy
from repro_torch.core import quant
from repro_torch.core.tree import tree_leaves_sorted, tree_unflatten_sorted
from repro_torch.device import resolve_device
from repro_torch.qat import fakequant
from repro_torch.qat.train import QATSpec
from repro_torch.runtime.recipe import QuantRecipe

Pytree = Any


@dataclasses.dataclass
class QATExport:
    """The train->deploy handoff: float shadow weights + the recipe that
    turns them into the deployed int8 form.

    Deploy with ``runtime.compile_model(cfg, ex.params, backend=...,
    recipe=ex.recipe)`` or with the packed tree ``ex.qparams`` as it is;
    ``ex.quantized_bytes`` is the artifact's footprint.
    """

    recipe: QuantRecipe
    params: Pytree                 # float shadow weights (engine input)
    qparams: Pytree                # QTensor tree (int8 deploy artifact)
    quantized_bytes: tuple         # (int bytes, residual float bytes)


def export(params: Pytree, spec: QATSpec, qstate: dict | None = None
           ) -> QATExport:
    """Freeze a QAT run: learned exponent -> recipe, shadow -> int8.  The
    learned exponent is read back to the host here, once."""
    recipe = spec.recipe
    if qstate is not None and spec.config.learn_exponent:
        recipe = recipe.with_(weight_exponent=int(qstate["weight_exponent"]))
    qtree = recipe.quantize(params)
    return QATExport(recipe=recipe, params=params, qparams=qtree,
                     quantized_bytes=quant.tree_quantized_bytes(qtree))


def eval_forward(cfg, spec: QATSpec, recipe: QuantRecipe | None = None):
    """The QAT *eval* path: ``forward(params, x)`` through the fake-quant
    weights under the backend's exec config, with no graph recorded — the
    program whose logits must be bit-identical to the exported engine's."""
    from repro_torch.launch import steps

    recipe = recipe or spec.recipe
    exec_cfg = spec.exec_cfg(cfg)
    mod = steps.model_module(cfg)

    @torch.no_grad()
    def forward(params, x):
        fq = fakequant.fake_quant_tree(params, recipe)
        return mod.forward(fq, x, exec_cfg)

    return forward


def save(path: str, ex: QATExport) -> None:
    """Write the deploy artifact: recipe JSON + packed int/float leaves.

    QTensor leaves are written in their STORED form — int8, or the
    nibble-packed uint8 bytes of the ``core.quant`` codec for ``bits<=4``
    recipes — so the .npz is byte for byte the ROM image a device would
    flash.  :func:`load` reverses it exactly.
    """
    arrays, meta = {}, []
    for i, leaf in enumerate(tree_leaves_sorted(ex.qparams)):
        if isinstance(leaf, quant.QTensor):
            arrays[f"leaf_{i}_values"] = leaf.values.cpu().numpy()
            meta.append({"kind": "qtensor", "exponent": int(leaf.exponent),
                         "bits": int(leaf.bits),
                         "shape": [int(s) for s in leaf.shape],
                         "per_channel": leaf.axis_exponents is not None})
            if leaf.axis_exponents is not None:
                arrays[f"leaf_{i}_axis_exponents"] = \
                    leaf.axis_exponents.cpu().numpy()
        else:
            arrays[f"leaf_{i}_values"] = leaf.detach().cpu().numpy()
            meta.append({"kind": "float"})
    np.savez(path + ".npz", **arrays)
    with open(path + ".json", "w") as f:
        json.dump({"recipe": ex.recipe.to_dict(), "leaves": meta,
                   "quantized_bytes": [int(b) for b in ex.quantized_bytes]},
                  f, indent=2)


def load(path: str, like: Pytree, device=None) -> tuple[QuantRecipe, Pytree]:
    """Read a saved artifact back into a packed QTensor tree on ``device``
    (``None``: the card).

    ``like`` supplies the tree STRUCTURE (e.g. ``kwt.init_params`` or the
    export-time ``qparams``); leaf payloads come from disk in their packed
    form and round-trip exactly — feed the result straight to
    ``runtime.compile_model(cfg, qparams, backend=...)``.
    """
    device = resolve_device(device)
    with open(path + ".json") as f:
        doc = json.load(f)
    recipe = QuantRecipe.from_dict(doc["recipe"])
    leaves = []
    with np.load(path + ".npz") as data:
        for i, m in enumerate(doc["leaves"]):
            values = data[f"leaf_{i}_values"]
            if m["kind"] == "qtensor":
                bits = m.get("bits", 8)
                leaves.append(qtensor_from_numpy(
                    values, m["exponent"],
                    axis_exponents=data[f"leaf_{i}_axis_exponents"]
                    if m["per_channel"] else None,
                    bits=bits,
                    logical_shape=m["shape"] if bits <= 4 else None,
                    device=device))
            else:
                leaves.append(torch.from_numpy(np.array(values)).to(device))
    return recipe, tree_unflatten_sorted(like, leaves)
