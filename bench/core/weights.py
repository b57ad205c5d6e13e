"""Seeded float weights, drawn on the device in one call.

The tree is laid out as the program takes it (the model family's
``layout``, ``bench/models/<family>.py``: each leaf a ``(shape,
kind)`` with kind ``matrix``, ``stacked`` (a matrix per layer),
``vector`` or ``norm``), and every leaf is drawn by the recipe the
configuration file names under ``weights``: matrices ``normal(0, 1 / sqrt(fan_in))`` (``fan_in`` the
leaf's first axis, or its second where the leaf stacks layers), norm
scales ``normal(1, norm_std)``, every other vector ``normal(0,
vector_std)``.  One ``torch.randn`` on the device draws all of it; the
leaves are views of that buffer (vectors are copied out, so that a
program that keeps only them does not keep the buffer).  The same seed
gives the same tree, which is how the references see the weights the
program was handed.
"""

from __future__ import annotations

import math

import torch


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, path + (k,))
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _leaves(v, path + (i,))
    else:
        yield path, tree


def _rebuild(tree, values, path=()):
    if isinstance(tree, dict):
        return {k: _rebuild(v, values, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_rebuild(v, values, path + (i,)) for i, v in enumerate(tree)]
    return values[path]


def draw(lay: dict, recipe: dict, seed: int, device) -> dict:
    """The seeded float32 tree of the layout ``lay`` on ``device``."""
    leaves = list(_leaves(lay))
    total = sum(math.prod(shape) for _, (shape, _) in leaves)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    flat = torch.randn(total, generator=gen, device=device)
    values, at = {}, 0
    for path, (shape, kind) in leaves:
        n = math.prod(shape)
        t = flat[at:at + n].view(shape)
        at += n
        if kind == "matrix":
            t.mul_(1.0 / math.sqrt(shape[0]))
        elif kind == "stacked":
            t.mul_(1.0 / math.sqrt(shape[1]))
        elif kind == "norm":
            t = t.mul(recipe["norm_std"]).add_(recipe["norm_mean"])
        else:
            t = t.mul(recipe["vector_std"])
        values[path] = t
    return _rebuild(lay, values)
