"""Parameter trees: nested dicts / lists / tuples whose leaves are
tensors, :class:`~repro_torch.core.quant.QTensor`s or plain Python
values.  The counterpart of the few ``jax.tree`` calls the reference
makes; a QTensor is always one leaf.

Two leaf orders exist.  :func:`tree_leaves` keeps container order (dict
insertion order), which is what the model code walks.  Files shared with
the reference — the QAT export ``.npz`` and the checkpoint shards — are
written in ``jax.tree.leaves`` order instead, which sorts dict keys:
:func:`tree_leaves_sorted` and :func:`tree_unflatten_sorted`.
"""

from __future__ import annotations

from typing import Any, Callable

Pytree = Any


def tree_map(fn: Callable, tree: Pytree, *rest: Pytree) -> Pytree:
    """Apply ``fn`` to every leaf (and the leaves at the same places of
    the ``rest`` trees, which share ``tree``'s structure), keeping the
    container structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    return fn(tree, *rest)


def tree_leaves(tree: Pytree) -> list:
    """Leaves in container order (dict insertion order)."""
    if isinstance(tree, dict):
        return [leaf for v in tree.values() for leaf in tree_leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [leaf for v in tree for leaf in tree_leaves(v)]
    return [tree]


def tree_leaves_sorted(tree: Pytree) -> list:
    """Leaves in the reference's order: dict keys sorted, sequences in
    order, ``None`` no leaf (``jax.tree.leaves`` with a QTensor as one
    leaf)."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves_sorted(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [leaf for v in tree for leaf in tree_leaves_sorted(v)]
    return [] if tree is None else [tree]


def tree_unflatten_sorted(like: Pytree, leaves) -> Pytree:
    """Inverse of :func:`tree_leaves_sorted`: ``like``'s structure (and
    its dict insertion order) with the leaves taken in sorted order."""
    it = iter(leaves)

    def build(node):
        if isinstance(node, dict):
            out = {k: build(node[k]) for k in sorted(node)}
            return {k: out[k] for k in node}
        if isinstance(node, (list, tuple)):
            return type(node)(build(v) for v in node)
        return None if node is None else next(it)

    out = build(like)
    if next(it, None) is not None:
        raise ValueError("more leaves than the tree has places")
    return out
