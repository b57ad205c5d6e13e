"""Parameter trees: nested dicts / lists / tuples whose leaves are
tensors, :class:`~repro_torch.core.quant.QTensor`s or plain Python
values.  The counterpart of the few ``jax.tree`` calls the reference
makes; a QTensor is always one leaf."""

from __future__ import annotations

from typing import Any, Callable

Pytree = Any


def tree_map(fn: Callable, tree: Pytree) -> Pytree:
    """Apply ``fn`` to every leaf, keeping the container structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v) for v in tree)
    return fn(tree)


def tree_leaves(tree: Pytree) -> list:
    """Leaves in container order (dict insertion order)."""
    if isinstance(tree, dict):
        return [leaf for v in tree.values() for leaf in tree_leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [leaf for v in tree for leaf in tree_leaves(v)]
    return [tree]
