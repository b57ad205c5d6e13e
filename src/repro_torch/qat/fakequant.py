"""Straight-through-estimator fake-quant primitives (paper eq 9 in the loss).

Forward values come from :func:`repro_torch.runtime.recipe.po2_fake_quant`
— the SAME function ``QuantRecipe.quantize`` uses for PTQ — so a QAT
forward pass runs bit-identically the weights the deployed engine will run
(export-parity contract, ``repro_torch.qat.export``).  Backward is
*clipped* STE: the cotangent passes through unchanged where the eq-9 cast
did not saturate and is zeroed where it clipped (saturated weights can
only be recovered by the shrinking shadow value, not by gradient noise —
arXiv:2009.04465 §3).

The exponent may be a 0-dim float32 tensor on the device (the learned
exponent of ``repro_torch.qat.train``), so exponent learning never reads
a value back to the host inside a step.
"""

from __future__ import annotations

from typing import Any

import torch

from repro_torch.core.tree import tree_leaves, tree_map
from repro_torch.runtime.recipe import QuantRecipe

Pytree = Any


class FakeQuant(torch.autograd.Function):
    """Quantise-dequantise one weight leaf at ``2^exponent`` (eq 9).

    Forward: bit-identical to ``recipe.with_(weight_exponent=e)
    .apply({w})`` (shared ``po2_fake_quant`` math).  Backward: clipped STE
    on ``w``; ``exponent`` receives a zero gradient (it is calibrated, not
    descended — power-of-2 scales have no useful gradient)."""

    @staticmethod
    def forward(ctx, w, exponent, recipe):
        fq, unsat = recipe.fake_quant_leaf(w, exponent)
        ctx.save_for_backward(unsat)
        ctx.exponent_is_tensor = isinstance(exponent, torch.Tensor)
        if ctx.exponent_is_tensor:
            ctx.exponent_like = (exponent.shape, exponent.dtype, exponent.device)
        return fq

    @staticmethod
    def backward(ctx, g):
        (unsat,) = ctx.saved_tensors
        ge = None
        if ctx.exponent_is_tensor:
            shape, dtype, device = ctx.exponent_like
            ge = torch.zeros(shape, dtype=dtype, device=device)
        return torch.where(unsat, g, 0.0).to(g.dtype), ge, None


def fake_quant(w: torch.Tensor, exponent, recipe: QuantRecipe) -> torch.Tensor:
    """Eq-9 fake-quant of one leaf with the clipped STE (:class:`FakeQuant`)."""
    return FakeQuant.apply(w, exponent, recipe)


def _exponent(exponent, recipe: QuantRecipe, device) -> torch.Tensor:
    e = recipe.weight_exponent if exponent is None else exponent
    return torch.as_tensor(e, dtype=torch.float32, device=device)


def fake_quant_tree(params: Pytree, recipe: QuantRecipe,
                    exponent=None) -> Pytree:
    """STE fake-quant of a parameter tree.

    Leaf selection mirrors ``QuantRecipe.quantize`` exactly (norms/biases
    stay float, paper §IV: those leaves are returned as they are); forward
    values are bit-identical to ``recipe.apply(params)``.  ``exponent``
    (a number or a 0-dim tensor) overrides the recipe's static weight
    exponent — the QAT exponent-learning hook.
    """
    leaves = [leaf for leaf in tree_leaves(params) if recipe._quantizes(leaf)]
    if not leaves:
        return params
    e = _exponent(exponent, recipe, leaves[0].device)
    return tree_map(lambda leaf: fake_quant(leaf, e, recipe)
                    if recipe._quantizes(leaf) else leaf, params)


def fake_quant_input(x: torch.Tensor, recipe: QuantRecipe) -> torch.Tensor:
    """STE fake-quant of model *inputs* at the Table V input exponent
    (2^5 best row) — optional in QAT (the deployed engines feed float
    features, so matching them means leaving this off)."""
    input_recipe = recipe.with_(weight_exponent=recipe.input_exponent,
                                per_channel=False, skip_norm_scales=False)
    return fake_quant(x, _exponent(recipe.input_exponent, recipe, x.device),
                      input_recipe)


def calibrate_exponent(params: Pytree, recipe: QuantRecipe) -> torch.Tensor:
    """The analytic no-saturation weight exponent of the current shadow
    weights, as a 0-dim float32 tensor on their device: the largest y with
    ``floor(max|w| * 2^y)`` unsaturated across all quantised leaves (the
    device-side counterpart of ``quant.choose_exponent`` /
    ``QuantRecipe.calibrated``).  Clipped to [0, 14] so a transient
    all-zero leaf cannot blow the exponent up."""
    hi = 2 ** (recipe.bits - 1) - 1
    leaves = [leaf for leaf in tree_leaves(params) if recipe._quantizes(leaf)]
    if not leaves:
        return torch.tensor(float(recipe.weight_exponent), dtype=torch.float32)
    with torch.no_grad():
        maxabs = [leaf.detach().to(torch.float32).abs().max().clamp(min=1e-30)
                  for leaf in leaves]
        # a true division (a Python number over a tensor is a reciprocal
        # times the number in PyTorch, which rounds differently)
        exps = [torch.floor(torch.log2(torch.full_like(m, hi) / m))
                for m in maxabs]
        return torch.stack(exps).min().clamp(0.0, 14.0)
