"""A step on a ``DeviceMesh``, in local view.

The reference partitions a jitted step by its argument shardings
(GSPMD).  The port runs the same eager step on every rank of the mesh,
each on its own part, as the reference's ``shard_map`` regions run:

* **Weights.**  The parameters and the optimizer state are ``DTensor`` s
  placed by their specs (``param_pspecs``, ``opt_state_specs``).  Before
  the forward every leaf is gathered whole on each rank
  (:func:`materialize`, ZeRO-3 style: GSPMD gathers a sharded operand
  before a product it cannot split), except the MoE expert stacks, which
  keep their ``"model"`` shard — each rank runs its own experts
  (``models.moe``'s expert-parallel branch) — and are gathered over
  ``"data"`` only.  The dense products run on the gathered weights: the
  ``"model"`` axis shards storage, the experts and, under Megatron-SP,
  the sequence; GSPMD's partitioned einsums are not reproduced.
* **Batch.**  Each rank takes its chunk of the batch's leading dim over
  the DP axes (``batch_pspec``); the model ranks of one data rank hold
  the same chunk.  When the batch does not divide (``dp_for`` is
  ``None``) every rank takes all of it.
* **Gradients.**  The step's gradient function runs on the gathered
  weights under ``ctx.mesh_context`` (the caller's, or the mesh's DP
  axes); its loss is the mean over the rank's shard, so loss and
  gradients are meaned over the DP ranks (:func:`grads_on_mesh`).  The
  result is whole (an expert stack: the rank's slice), as the
  compressed sync wants it.
* **Serving.**  A prefill or decode step (:func:`serve_on_mesh`) runs
  the same way: weights gathered, the batch and the decode state the
  rank's data shards, gathered over ``"model"`` (which shards their
  storage), the new state cut back to its placement.
* **Update.**  ``optim.adamw.update`` cuts each gradient to the rank's
  shard of its parameter and updates the shards; the global gradient
  norm and an int8 moment's scale are reduced over the mesh
  (:class:`MeshReduce`).

A kernel wrapper never sees a ``DTensor``: the model code runs on the
gathered weights and the rank's local activations, so the LUT softmax
and GELU run on local rows — their functions are row-local — and the
int8 matmul and attention on whole operands.  On a mesh of one rank no
collective runs and every op is the one-device step's.
"""

from __future__ import annotations

import contextlib

import torch

from repro_torch.core.tree import tree_leaves, tree_map
from repro_torch.dist import ctx, sharding


def mesh_of(tree):
    """The mesh ``tree`` is placed on (its first leaf's), else None: a
    tree is placed whole or not at all."""
    leaves = tree_leaves(tree)
    if leaves and sharding.is_dtensor(leaves[0]):
        return leaves[0].device_mesh
    return None


def _map_path(fn, tree, *others, path=()):
    """``fn(path, leaf, *other_leaves)`` over ``tree`` and same-structure
    ``others``."""
    if isinstance(tree, dict):
        return {k: _map_path(fn, v, *(o[k] for o in others),
                             path=path + (k,)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_path(fn, v, *(o[i] for o in others),
                                    path=path + (i,))
                          for i, v in enumerate(tree))
    return fn(path, tree, *others)


def _is_expert(path) -> bool:
    from repro_torch.models import moe
    return len(path) >= 2 and path[-2] == "moe" and \
        path[-1] in moe.EXPERT_STACKS


def _whole(x):
    if x.device_mesh.size() == 1:
        return x.to_local()
    return x.full_tensor()


def materialize(params):
    """The weights a rank's forward runs on: every ``DTensor`` leaf
    gathered whole, the MoE expert stacks gathered over all but
    ``"model"`` (``moe.gather_experts``)."""
    from repro_torch.models import moe

    def one(path, x):
        if not sharding.is_dtensor(x):
            return x
        return moe.gather_experts(x) if _is_expert(path) else _whole(x)
    return _map_path(one, params)


def _sliced(path, p) -> bool:
    """Whether the leaf at ``path`` of placed ``params`` is an expert
    stack, of which a rank's forward holds its ``"model"`` slice."""
    return sharding.is_dtensor(p) and _is_expert(path)


def compute_zeros(params):
    """Float32 zeros of the shapes :func:`materialize` gives (the
    compressed sync's error state on a mesh)."""
    from repro_torch.models import moe

    def one(path, x):
        shape = tuple(x.shape)
        if _sliced(path, x):
            shape = tuple(sharding.local_chunk(
                torch.empty(shape, device="meta"), x.device_mesh,
                moe.expert_placements(x)).shape)
        device = x.to_local().device if sharding.is_dtensor(x) else x.device
        return torch.zeros(shape, dtype=torch.float32, device=device)
    return _map_path(one, params)


def gather_slices(tree, params):
    """``tree`` in the shapes :func:`materialize` gives (gradients, the
    compressed sync's error state) with every expert slice gathered over
    ``"model"``: ``params``' full shapes, the same on every rank.  A
    collective: every rank of the mesh calls it.  Off a mesh ``tree`` is
    returned as it is."""
    from repro_torch.models import moe

    def one(path, x, p):
        if not _sliced(path, p):
            return x
        return _whole(sharding.from_local(
            x.contiguous(), p.device_mesh, moe.expert_placements(p),
            tuple(p.shape)))
    return _map_path(one, tree, params)


def cut_slices(tree, params):
    """The inverse of :func:`gather_slices`: each expert leaf of ``tree``
    (full) cut to this rank's ``"model"`` slice."""
    from repro_torch.models import moe

    def one(path, x, p):
        if not _sliced(path, p):
            return x
        return sharding.local_chunk(x, p.device_mesh,
                                    moe.expert_placements(p)).contiguous()
    return _map_path(one, tree, params)


def _dp_groups(mesh, dp):
    names = sharding.axis_names(mesh)
    return [mesh.get_group(names.index(a)) for a in dp or ()]


def dp_total(mesh, dp) -> int:
    """The number of ranks over the ``dp`` axes of ``mesh``."""
    n = 1
    for a in dp or ():
        n *= sharding.axis_size(mesh, a)
    return n


def data_shard(batch: dict, mesh, dp) -> dict:
    """This rank's chunk of every batch entry's leading dim over ``dp``;
    an entry placed already (a ``DTensor``) is its local shard."""
    places = sharding.placements(sharding.P(dp), mesh) if dp else None
    return {k: v.to_local() if sharding.is_dtensor(v)
            else v if places is None
            else sharding.local_chunk(v, mesh, places)
            for k, v in batch.items()}


def _mean_over(x: torch.Tensor, groups, n: int) -> torch.Tensor:
    import torch.distributed as dist
    x = x.detach().clone()
    for g in groups:
        dist.all_reduce(x, group=g)
    return x / torch.full((), float(n), dtype=x.dtype, device=x.device)


@contextlib.contextmanager
def step_context(mesh, batch_size: int):
    """``ctx.mesh_context`` of a step, yielding its DP axes: the caller's
    declaration where one is active, else the mesh's DP axes (``None``
    where the batch does not divide over them) and no sequence axis."""
    from repro_torch.launch import mesh as meshlib
    if ctx._STATE.active:
        yield ctx.dp_axes()
        return
    dp = meshlib.dp_axes(mesh)
    if batch_size % dp_total(mesh, dp):
        dp = None
    with ctx.mesh_context(dp):
        yield dp


def grads_on_mesh(grads_fn):
    """``grads_fn(params, *args, batch) -> (loss, grads, *rest)`` run on
    a mesh when ``params`` is placed on one: the weights gathered, the
    batch cut to the rank's data shard, the loss and the gradients
    meaned over the DP ranks.  Unplaced ``params`` pass straight
    through."""
    def run(params, *args):
        mesh = mesh_of(params)
        if mesh is None:
            return grads_fn(params, *args)
        *rest_args, batch = args
        size = next(iter(batch.values())).shape[0]
        with mesh, step_context(mesh, size) as dp:
            out = grads_fn(materialize(params), *rest_args,
                           data_shard(batch, mesh, dp))
        loss, grads, *rest = out
        loss, grads = dp_mean((loss, grads), mesh, dp)
        return (loss, grads, *rest)
    return run


def dp_mean(tree, mesh, dp):
    """Every tensor of ``tree`` (this rank's, whole) meaned over the
    ``dp`` ranks of ``mesh``: one all-reduce a leaf per DP axis.  A
    collective: every rank of the mesh calls it."""
    n = dp_total(mesh, dp)
    if n <= 1:
        return tree
    groups = _dp_groups(mesh, dp)
    return tree_map(lambda g: _mean_over(g, groups, n), tree)


def local_view(tree, dp):
    """A placed activation tree (a batch, a decode state) as this rank
    works on it: each ``DTensor`` leaf keeps its shards over the ``dp``
    axes (the rank's batch shard) and is gathered over every other mesh
    axis (a decode cache's heads over ``"model"``); other leaves as they
    are."""
    from torch.distributed.tensor import Replicate

    def one(x):
        if not sharding.is_dtensor(x):
            return x
        names = sharding.axis_names(x.device_mesh)
        places = tuple(pl if names[i] in (dp or ()) else Replicate()
                       for i, pl in enumerate(x.placements))
        if places != tuple(x.placements):
            x = x.redistribute(x.device_mesh, places)
        return x.to_local()
    return tree_map(one, tree)


def _cut_back(new, old, dp):
    """A leaf of :func:`local_view`'s result, cut back to ``old``'s
    placement (the inverse of :func:`local_view`; its ``dp`` shards are
    this rank's already)."""
    if not sharding.is_dtensor(old):
        return new
    mesh = old.device_mesh
    skip = tuple(a for a in sharding.axis_names(mesh) if a in (dp or ()))
    return sharding.from_local(
        sharding.local_chunk(new, mesh, old.placements, skip=skip)
        .contiguous(), mesh, old.placements, tuple(old.shape))


def serve_on_mesh(step):
    """``step(params, state, batch) -> (logits, state)`` (a prefill or a
    decode step) run on a mesh in local view when ``params`` is placed:
    the weights gathered (:func:`materialize`), the batch cut to the
    rank's data shard (:func:`data_shard`), the decode state's data
    shards gathered over the other axes (:func:`local_view`: the
    ``"model"`` axis shards storage, as for the weights); the new state
    is cut back to the old one's placement and the logits are the rank's
    rows.  Unplaced ``params`` pass straight through."""
    def run(params, state, batch):
        mesh = mesh_of(params)
        if mesh is None:
            return step(params, state, batch)
        size = next(iter(batch.values())).shape[0]
        with mesh, step_context(mesh, size) as dp:
            logits, new = step(materialize(params), local_view(state, dp),
                               data_shard(batch, mesh, dp))
        return logits, tree_map(lambda n, o: _cut_back(n, o, dp), new,
                                state)
    return run


# ---------------------------------------------------------------------------
# The sharded optimizer update
# ---------------------------------------------------------------------------

class MeshReduce:
    """The optimizer's two reductions across a placed tree's shards: the
    global norm (each shard counted once: by the rank at coordinate 0 of
    every mesh dim the leaf is replicated on) and an int8 moment's
    max-abs."""

    def __init__(self, mesh, places):
        from torch.distributed.tensor import Replicate
        coord = list(mesh.get_coordinate() or [0] * mesh.ndim)
        self.mesh = mesh
        self.counted = [all(c == 0 for c, pl in zip(coord, p)
                            if isinstance(pl, Replicate)) for p in places]

    def _all(self, x, op):
        import torch.distributed as dist
        for i in range(self.mesh.ndim):
            if self.mesh.size(i) > 1:
                dist.all_reduce(x, op=op, group=self.mesh.get_group(i))
        return x

    def norm(self, leaves) -> torch.Tensor:
        import torch.distributed as dist
        total = sum(torch.sum(torch.square(g.to(torch.float32)))
                    if keep else torch.zeros((), device=g.device)
                    for g, keep in zip(leaves, self.counted))
        return torch.sqrt(self._all(total, dist.ReduceOp.SUM))

    def maxabs(self, x) -> torch.Tensor:
        import torch.distributed as dist
        m = x.abs().max() if x.numel() else torch.zeros((), device=x.device)
        return self._all(m.to(torch.float32).clone(), dist.ReduceOp.MAX)


def _shard_grad(g, p):
    """``g`` (whole, an expert slice, or placed) cut to ``p``'s shard."""
    if sharding.is_dtensor(g):
        return g.to_local()
    mesh = p.device_mesh
    skip = ()
    if tuple(g.shape) != tuple(p.shape):       # an expert stack's slice
        skip = ("model",)
    return sharding.local_chunk(g, mesh, p.placements, skip=skip)


def update_on_mesh(update, grads, state, params, hp, *, scan_stacked):
    """``update`` (``optim.adamw.update``) on each rank's shards of placed
    ``params`` and ``state``; the new trees are placed as the old."""
    mesh = mesh_of(params)
    p_leaves = tree_leaves(params)
    g_local = [_shard_grad(g, p) for g, p in zip(tree_leaves(grads),
                                                  p_leaves)]
    it = iter(g_local)
    grads_l = tree_map(lambda _: next(it), params)
    reduce = None
    if mesh.size() > 1:
        reduce = MeshReduce(mesh, [p.placements for p in p_leaves])
    new_p, new_s, metrics = update(
        grads_l, sharding.local(state), sharding.local(params), hp,
        scan_stacked=scan_stacked, reduce=reduce)

    def back(new, old):
        if not sharding.is_dtensor(old):
            return new
        return sharding.from_local(new, old.device_mesh, old.placements,
                                   tuple(old.shape))
    return (tree_map(back, new_p, params), tree_map(back, new_s, state),
            metrics)
