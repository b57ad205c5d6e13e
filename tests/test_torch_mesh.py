"""The port's sharded execution (``repro_torch.dist.spmd``, the specs'
placements, the expert-parallel MoE, Megatron-SP, ``launch.train
--data/--model``) over four ``gloo`` CPU ranks as a (2, 2) mesh, against
the reference's one-device run on the same weights.

Every rank runs in a subprocess (the test process keeps its one-device
topology); one spawn computes every sharded result, rank 0 writes them
and every rank writes its MoE gradients.  Terms, measured on this host
and stated beside each check:

* granite-8b smoke, batch (8, 32): the mesh's loss within 1e-5 of the
  reference's one-device ``value_and_grad`` and its gradients within
  1e-5 (the reference's own sharded test allows 1e-4 and 1e-2; the
  port's gap is its one-device gap, the mesh's data mean adds ~1e-8);
* granite-moe smoke at ``capacity_factor=8.0`` (no drops, C8), experts
  split over the two model ranks: on every rank, loss within 1e-5 of the
  reference's local loss and every gradient leaf (the expert stacks'
  slices gathered whole) within 1e-5 of the reference's.  The smoke's 8
  experts pad to 16, so model rank 0 holds every routed expert; the same
  at 16 experts puts routed experts on both model ranks, and there the
  router's and the tokens' gradients are each the sum of both ranks'
  parts (the region's reduction over ``"model"``);
* Megatron-SP (``seq_axis="model"``) at a sequence of 31 over two model
  ranks (uneven chunks of 16 and 15): the residual stream is chunked, and
  loss and gradients are the reference's within 1e-5; the same with
  ``remat`` on and the backward run on a thread of its own (as autograd
  runs it on the card), where every layer's recompute chunks again;
* serving in local view (``spmd.serve_on_mesh``): granite-8b and
  granite-moe (capacity 8.0), weights and decode state placed by
  ``param_pspecs`` / ``decode_state_pspecs`` (the caches' KV heads over
  ``"model"``), a prefill of 8 x 12 and one decode step: each rank's
  logits (its data rows) and the decode state, cut back to its placement
  and gathered whole, within 1e-5 of the reference's one-device prefill
  and decode (measured 5.3e-6);
* placements of uneven dims equal ``distribute_tensor``'s shards and
  gather back exactly; the compressed sync rings over the data axis and
  equals the one-device sync bit for bit;
* ``launch.train`` on the four ranks: granite-8b crashed at step 3 on
  (2, 2) resumes on (4, 1) onto an uninterrupted one-device run's losses
  within 1e-5; granite-moe on ``--compressed-grads`` crashed at step 3
  and resumed on (2, 2) equals an uninterrupted (2, 2) run bit for bit,
  its error state (each model rank's expert slices) included;
* ``python -m torch.distributed.run`` starts the launcher on a (2, 2)
  mesh of its own ranks.
"""

import os
import re
import subprocess
import sys
import tempfile
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jregistry
from repro.models import transformer as JT
from repro_torch import convert
from repro_torch.configs import registry as tregistry
from repro_torch.launch import train as ttrain

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT_S = 300
DENSE, MOE = "granite-8b", "granite-moe-3b-a800m"
SP_SEQ = 31
SERVE_PROMPT, SERVE_MAX_LEN = 12, 16
SERVE_TOL = 1e-5

_WORKER = textwrap.dedent("""
    import sys
    import threading
    import torch
    import torch.distributed as dist
    from repro_torch.configs import registry
    from repro_torch.core.tree import tree_leaves_sorted
    from repro_torch.dist import compress, ctx, sharding, spmd
    from repro_torch.launch import mesh as mesh_mod, steps, train
    from repro_torch.models import transformer as T

    rank, n, out = sys.argv[1:4]
    rank, n = int(rank), int(n)
    # a file store in the run's own directory: no port to race for
    dist.init_process_group("gloo", init_method=f"file://{out}/store",
                            world_size=n, rank=rank)
    mesh = mesh_mod.make_host_mesh(2, 2)
    inputs = torch.load(out + "/in.pt")
    res = {}

    def grads(cfg, params, batch, seq_axis=None):
        # loss and every gradient leaf, the expert slices gathered whole
        fn = spmd.grads_on_mesh(lambda p, b: steps.value_and_grad(
            lambda q, bb: T.loss_fn(q, bb, cfg), p, b))
        placed = sharding.place(params, steps.param_pspecs(cfg), mesh)
        with mesh, ctx.mesh_context(("data",), seq_axis=seq_axis):
            loss, g = fn(placed, batch)
        return float(loss), tree_leaves_sorted(spmd.gather_slices(g, placed))

    dense = registry.get("granite-8b").smoke
    res["dense"] = grads(dense, inputs["dense"], inputs["batch"])

    moe = registry.get("granite-moe-3b-a800m").smoke.with_(
        capacity_factor=8.0)
    res["moe"] = grads(moe, inputs["moe"], inputs["batch"])
    res["moe16"] = grads(moe.with_(n_experts=16), inputs["moe16"],
                         inputs["batch"])

    # serving in local view: a prefill and one decode step on the placed
    # weights and decode state (the caches' heads over "model"); each
    # rank's logits are its data rows, the new state is cut back
    from repro_torch.configs.base import ShapeSpec

    def serve(cfg, params):
        prompt, token = inputs["prompt"], inputs["token"]
        placed = sharding.place(params, steps.param_pspecs(cfg), mesh)
        specs = steps.decode_state_pspecs(cfg, ("data",), 2)
        state = sharding.place(T.init_decode_state(
            cfg, prompt.shape[0], inputs["max_len"], device="cpu"),
            specs, mesh)
        shape = ShapeSpec("serve", prompt.shape[1], prompt.shape[0],
                          "prefill")
        out = {"data_rank": mesh.get_coordinate()[0]}
        for name, step, batch in (
                ("prefill", steps.make_prefill_step(cfg, shape),
                 {"tokens": prompt}),
                ("decode", steps.make_decode_step(cfg, shape),
                 {"token": token})):
            old = state
            logits, state = step(placed, state, batch)
            out[name] = {
                "logits": logits,
                "placed_as_before": all(
                    sharding.is_dtensor(n) and n.placements == o.placements
                    and n.shape == o.shape for n, o in zip(
                        tree_leaves_sorted(state["layers"]),
                        tree_leaves_sorted(old["layers"]))),
                "index": state["index"],
                "layers": tree_leaves_sorted(
                    sharding.full(state["layers"]))}
        return out
    res["serve"] = {"dense": serve(dense, inputs["dense"]),
                    "moe": serve(moe, inputs["moe"])}

    seen = []
    shard = ctx.shard_activations

    def spy(x):
        y = shard(x)
        seen.append((x.shape[1], y.shape[1],
                     threading.current_thread() is threading.main_thread()))
        return y
    ctx.shard_activations = spy
    res["sp"] = grads(dense, inputs["dense"], inputs["sp_batch"],
                      seq_axis="model") + (sorted(set(seen)),)

    # remat under Megatron-SP with the backward on a thread of its own, as
    # autograd runs it on the card: each layer's recompute runs there
    grad = torch.autograd.grad

    def threaded(*a, **k):
        got = []

        def body():
            try:
                got.append(grad(*a, **k))
            except BaseException as e:
                got.append(e)
        t = threading.Thread(target=body)
        t.start()
        t.join()
        if isinstance(got[0], BaseException):
            raise got[0]
        return got[0]
    seen.clear()
    torch.autograd.grad = threaded
    res["sp_remat"] = grads(dense.with_(remat=True), inputs["dense"],
                            inputs["sp_batch"], seq_axis="model") + (
        sorted(set(seen)),)
    torch.autograd.grad = grad
    ctx.shard_activations = shard

    odd = {"a": torch.arange(5 * 7, dtype=torch.float32).reshape(5, 7),
           "b": torch.arange(3, dtype=torch.float32),
           "c": torch.arange(2 * 5 * 3, dtype=torch.float32).reshape(2, 5, 3)}
    specs = {"a": sharding.P("data", "model"), "b": sharding.P("model"),
             "c": sharding.P(None, ("data", "model"), None)}
    placed = sharding.place(odd, specs, mesh)
    from torch.distributed.tensor import distribute_tensor
    same = all(torch.equal(placed[k].to_local(), distribute_tensor(
        odd[k], mesh, sharding.placements(specs[k], mesh)).to_local())
        for k in odd)
    back = sharding.full(placed)
    res["uneven"] = (same, all(torch.equal(back[k], odd[k]) for k in odd),
                     {k: list(placed[k].to_local().shape) for k in odd})

    from repro_torch.kernels import ops
    refused = []
    for fn, args in ((ops.lut_softmax, (placed["a"],)),
                     (ops.lut_gelu, (placed["a"],)),
                     (ops.int8_matmul_raw, (placed["a"].to(torch.int8),
                                            placed["a"].to(torch.int8)))):
        try:
            fn(*args)
            refused.append(False)
        except TypeError:
            refused.append(True)
    res["refused"] = refused

    err = compress.init_error_state(res["dense"][1])
    synced, new_err = compress.compressed_grad_sync(
        res["dense"][1], err, mesh, bits=4, per_channel=True)
    res["ring"] = (compress.ring_size(mesh), synced, new_err)

    # launch.train on these ranks: granite-8b crashed on (2, 2) and
    # resumed on (4, 1); granite-moe on the compressed sync, uninterrupted
    # and crashed + resumed on (2, 2), where each model rank's error state
    # holds its own expert slices
    def run(*argv):
        try:
            r = train.main(["--device", "cpu", "--smoke", "--steps", "6",
                            "--ckpt-every", "2", *argv])
        except RuntimeError as e:
            return str(e)
        err = None if r.err is None else tree_leaves_sorted(
            spmd.gather_slices(r.err, r.params))
        return {"losses": r.losses, "resumed_from": r.resumed_from,
                "mesh": list(spmd.mesh_of(r.params).shape), "err": err}
    dense_argv = ("--arch", "granite-8b", "--ckpt-dir", out + "/dense_ck")
    moe_argv = ("--arch", "granite-moe-3b-a800m", "--compressed-grads",
                "--data", "2", "--model", "2")
    res["train"] = {
        "dense_crash": run(*dense_argv, "--data", "2", "--model", "2",
                           "--fail-at-step", "3"),
        "dense_resume": run(*dense_argv, "--data", "4", "--model", "1"),
        "moe_full": run(*moe_argv),
        "moe_crash": run(*moe_argv, "--ckpt-dir", out + "/moe_ck",
                         "--fail-at-step", "3"),
        "moe_resume": run(*moe_argv, "--ckpt-dir", out + "/moe_ck")}
    torch.save(res if rank == 0 else {k: res[k] for k in ("moe", "moe16",
                                                           "serve")},
               out + f"/out_{rank}.pt")
    dist.destroy_process_group()
""")


def _env():
    return dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
                OMP_NUM_THREADS="1")


def _batch(cfg, seq, seed):
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(0, cfg.vocab_size, (8, seq), np.int32),
            "labels": rng.integers(0, cfg.vocab_size, (8, seq), np.int32)}


def _reference(name, batch, **over):
    jcfg = jregistry.get(name).smoke.with_(**over)
    params = JT.init_params(jcfg, jax.random.PRNGKey(0))
    loss, grads = jax.value_and_grad(JT.loss_fn)(
        params, jax.tree.map(jnp.asarray, batch), jcfg)
    npp = jax.tree.map(np.asarray, params)
    return npp, float(loss), [np.asarray(g, np.float32)
                              for g in jax.tree.leaves(grads)]


def _serve_reference(name, params, prompt, token, **over):
    """The reference's one-device prefill of ``prompt`` and one decode
    step of ``token``: per step, the logits and the decode state's
    leaves and index."""
    jcfg = jregistry.get(name).smoke.with_(**over)
    state = JT.init_decode_state(jcfg, prompt.shape[0], SERVE_MAX_LEN)
    params = jax.tree.map(jnp.asarray, params)
    out = {}
    for step, fn, arg in (("prefill", JT.prefill, prompt),
                          ("decode", JT.decode_step, token)):
        logits, state = fn(params, jnp.asarray(arg), jcfg, state)
        out[step] = {"logits": np.asarray(logits, np.float32),
                     "index": int(state["index"]),
                     "layers": [np.asarray(a, np.float32) for a in
                                jax.tree.leaves(state["layers"])]}
    return out


def _tbatch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


@pytest.fixture(scope="module")
def sharded():
    """The reference's one-device results and the mesh's results (4 gloo
    ranks)."""
    batch, sp_batch = _batch(tregistry.get(DENSE).smoke, 32, 1), \
        _batch(tregistry.get(DENSE).smoke, SP_SEQ, 2)
    dense = _reference(DENSE, batch)
    moe = _reference(MOE, batch, capacity_factor=8.0)
    moe16 = _reference(MOE, batch, capacity_factor=8.0, n_experts=16)
    sp = _reference(DENSE, sp_batch)
    prompt = batch["tokens"][:, :SERVE_PROMPT]
    token = batch["tokens"][:, SERVE_PROMPT]
    serve = {"dense": _serve_reference(DENSE, dense[0], prompt, token),
             "moe": _serve_reference(MOE, moe[0], prompt, token,
                                     capacity_factor=8.0)}
    with tempfile.TemporaryDirectory() as out:
        torch.save({"dense": convert.from_numpy_tree(dense[0], device="cpu"),
                    "moe": convert.from_numpy_tree(moe[0], device="cpu"),
                    "moe16": convert.from_numpy_tree(moe16[0], device="cpu"),
                    "batch": _tbatch(batch), "sp_batch": _tbatch(sp_batch),
                    "prompt": torch.from_numpy(prompt),
                    "token": torch.from_numpy(token),
                    "max_len": SERVE_MAX_LEN},
                   out + "/in.pt")
        procs = [subprocess.Popen(
            [sys.executable, "-c", _WORKER, str(r), "4", out],
            env=_env(), stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
            for r in range(4)]
        try:
            logs = [p.communicate(timeout=TIMEOUT_S)[0] for p in procs]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        assert all(p.returncode == 0 for p in procs), \
            b"\n".join(logs).decode(errors="replace")[-4000:]
        ranks = [torch.load(out + f"/out_{r}.pt") for r in range(4)]
    return {"dense": dense, "moe": moe, "moe16": moe16, "sp": sp,
            "serve": serve, "mesh": ranks[0], "ranks": ranks}


def _maxdiff(a_list, b_list):
    assert len(a_list) == len(b_list)
    return max(float(np.max(np.abs(np.asarray(a, np.float32)
                                   - b.float().numpy())))
               for a, b in zip(a_list, b_list))


def test_dense_mesh_matches_the_reference_one_device(sharded):
    _, ref_loss, ref_grads = sharded["dense"]
    loss, grads = sharded["mesh"]["dense"]
    assert abs(loss - ref_loss) <= 1e-5
    assert _maxdiff(ref_grads, grads) <= 1e-5


@pytest.mark.parametrize("rank", range(4))
@pytest.mark.parametrize("case", ["moe", "moe16"])
def test_expert_parallel_moe_matches_the_reference_dropfree(sharded, case,
                                                            rank):
    """Loss and gradients on each rank, leaf by leaf: the expert stacks'
    slices (each model rank's experts) gathered whole, the router and the
    tokens' path back through the region's sum over ``"model"``."""
    _, ref_loss, ref_grads = sharded[case]
    loss, grads = sharded["ranks"][rank][case]
    assert abs(loss - ref_loss) <= 1e-5
    assert [tuple(g.shape) for g in grads] == \
        [tuple(g.shape) for g in ref_grads]
    assert _maxdiff(ref_grads, grads) <= 1e-5


@pytest.mark.parametrize("case", ["sp", "sp_remat"])
def test_megatron_sp_chunks_the_sequence_and_matches(sharded, case):
    loss, grads, seen = sharded["mesh"][case]
    # the residual stream held 16 and 15 of the 31 positions on the two
    # model ranks (rank 0 reports its own chunk: 16)
    assert (SP_SEQ, 16, True) in seen
    if case == "sp_remat":
        # every checkpointed layer's recompute chunked again, on the
        # backward's own thread
        assert (SP_SEQ, 16, False) in seen
    _, ref_loss, ref_grads = sharded["sp"]
    assert abs(loss - ref_loss) <= 1e-5
    assert _maxdiff(ref_grads, grads) <= 1e-5


@pytest.mark.parametrize("rank", range(4))
@pytest.mark.parametrize("case", ["dense", "moe"])
def test_serving_on_the_mesh_matches_the_reference(sharded, case, rank):
    """``make_prefill_step`` then ``make_decode_step`` on weights and a
    decode state placed by ``param_pspecs`` / ``decode_state_pspecs``
    (batch over ``"data"``, the caches' KV heads over ``"model"``): each
    rank's logits equal the reference's one-device rows of its data
    shard, and the decode state, cut back to its placement after each
    step and gathered whole, equals the reference's, index included."""
    got = sharded["ranks"][rank]["serve"][case]
    ref = sharded["serve"][case]
    rows = slice(4 * got["data_rank"], 4 * got["data_rank"] + 4)
    for step in ("prefill", "decode"):
        g, r = got[step], ref[step]
        assert g["placed_as_before"]
        assert g["index"] == r["index"]
        assert tuple(g["logits"].shape) == r["logits"][rows].shape
        assert _maxdiff([r["logits"][rows]], [g["logits"]]) <= SERVE_TOL
        assert [tuple(a.shape) for a in g["layers"]] == \
            [a.shape for a in r["layers"]]
        assert _maxdiff(r["layers"], g["layers"]) <= SERVE_TOL


def test_uneven_shards_follow_dtensor_and_gather_back(sharded):
    same, back, shapes = sharded["mesh"]["uneven"]
    assert same and back
    # rank 0 at mesh coordinate (0, 0): 5 rows over data -> 3, 7 columns
    # over model -> 4; 3 over model -> 2; 5 over data x model -> 2
    assert shapes == {"a": [3, 4], "b": [2], "c": [2, 2, 3]}


def test_kernel_wrappers_refuse_a_dtensor(sharded):
    """A placed operand never takes a kernel's plain version unseen."""
    assert sharded["mesh"]["refused"] == [True, True, True]


def test_compressed_sync_rings_over_the_data_axis(sharded):
    from repro_torch.dist import compress
    from repro_torch.launch import mesh as tmesh
    _, grads = sharded["mesh"]["dense"]
    n, synced, new_err = sharded["mesh"]["ring"]
    assert n == 2
    want, want_err = compress.compressed_grad_sync(
        grads, compress.init_error_state(grads), tmesh.make_host_mesh(),
        bits=4, per_channel=True)
    assert all(torch.equal(a, b) for a, b in zip(synced, want))
    assert all(torch.equal(a, b) for a, b in zip(new_err, want_err))


def test_launch_train_resumes_onto_another_mesh(sharded):
    """Crash at step 3 on (2, 2) (checkpoints at 2), resume on (4, 1):
    the resumed losses are an uninterrupted one-device run's."""
    full = ttrain.main(["--device", "cpu", "--arch", DENSE, "--smoke",
                        "--steps", "6"])
    runs = sharded["mesh"]["train"]
    assert "[injected failure] node lost at step 3" in runs["dense_crash"]
    got = runs["dense_resume"]
    assert got["resumed_from"] == 2 and got["mesh"] == [4, 1]
    np.testing.assert_allclose(got["losses"], full.losses[2:], rtol=0,
                               atol=1e-5)


def test_launch_train_resumes_the_moe_error_state(sharded):
    """granite-moe on ``--compressed-grads`` over (2, 2): each model
    rank's error state holds its own expert slices; saved whole and cut
    again on restore, the resumed run equals the uninterrupted one bit
    for bit, losses and every error leaf."""
    runs = sharded["mesh"]["train"]
    full, resumed = runs["moe_full"], runs["moe_resume"]
    assert "[injected failure] node lost at step 3" in runs["moe_crash"]
    assert resumed["resumed_from"] == 2 and resumed["mesh"] == [2, 2]
    assert resumed["losses"] == full["losses"][2:]
    assert len(resumed["err"]) == len(full["err"])
    assert all(torch.equal(a, b) for a, b in zip(resumed["err"], full["err"]))
    # the experts' residuals differ across the model ranks' slices: the
    # check would see rank 0's slice copied onto rank 1's
    assert any(not torch.equal(a.chunk(2, dim=1)[0], a.chunk(2, dim=1)[1])
               for a in full["err"] if a.ndim == 4)


def test_torchrun_starts_the_launcher_on_a_mesh():
    """``python -m torch.distributed.run --nproc-per-node 4 -m
    repro_torch.launch.train --data 2 --model 2``: the launcher joins the
    ranks' group from their environment and trains."""
    # --standalone: the rendezvous store binds a free port of its own (a
    # port picked here and closed could be taken before it binds)
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc-per-node", "4", "-m",
           "repro_torch.launch.train", "--device", "cpu", "--arch", DENSE,
           "--smoke", "--steps", "2", "--seq-len", "16", "--data", "2",
           "--model", "2"]
    p = subprocess.run(cmd, env=_env(), capture_output=True, text=True,
                       timeout=TIMEOUT_S)
    assert p.returncode == 0, p.stderr[-4000:]
    # one line a step; a slow step under load adds a "[straggler] step N"
    # line, which is no step
    assert len(re.findall(r"^step +\d+ loss ", p.stdout, re.M)) == 2
    assert "training complete." in p.stdout
