"""The port's error-feedback compressed gradient sync
(``repro_torch.dist.compress``) against the reference's
``repro.dist.compress``, on ``device="cpu"``.

Terms: every comparison is exact (``torch.equal`` / ``array_equal``):

* ``quantize_leaf`` / ``dequantize_leaf`` on the same numpy leaves, per
  tensor and per channel, 8 and 4 bits, with the ±127 (±7) saturation of
  the peak and an all-zero leaf;
* the error-feedback identity ``Q(c) + e' = c`` over several steps, and
  ``compressed_grad_sync`` on a one-device mesh equal to the reference's;
* the ring over a ``gloo`` process group of 2 and 4 ranks (int8 and
  nibble-packed int4) equal to a numpy emulation of the ring in hop order
  (own shard, then r-1, r-2, ...), bit for bit;
* ``launch.train --compressed-grads``: a crash and a resume from the
  ``/err`` tree end where an uninterrupted run does.
"""

import functools
import os
import socket
import subprocess
import sys
import tempfile
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.dist import compress as jcompress
from repro_torch.core.tree import tree_leaves, tree_leaves_sorted
from repro_torch.dist import compress as tcompress
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import steps as tsteps
from repro_torch.launch import train as ttrain

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RING_TIMEOUT_S = 120


def _leaf(shape, seed, scale=0.3):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape) * scale).astype(np.float32)


LEAVES = {
    "odd": _leaf((31, 3), 0),
    "rank3": _leaf((8, 16, 4), 1),
    "vector": _leaf((7,), 2, 2.0),
    "zeros": np.zeros((5, 4), np.float32),
    # rows orders of magnitude apart (the per-channel motivation)
    "rows": np.stack([np.full((64,), 1e-3, np.float32),
                      _leaf((64,), 3, 1.0)]),
}


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("per_channel", [False, True])
@pytest.mark.parametrize("name", sorted(LEAVES))
def test_leaf_codec_bit_exact(name, per_channel, bits):
    g = LEAVES[name]
    jq, js = jcompress.quantize_leaf(jnp.asarray(g), per_channel, bits=bits)
    tq, ts = tcompress.quantize_leaf(torch.from_numpy(g), per_channel,
                                     bits=bits)
    assert tq.dtype == (torch.int8 if bits == 8 else torch.uint8)
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    jb = jcompress.dequantize_leaf(jq, js, bits=bits, shape=g.shape)
    tb = tcompress.dequantize_leaf(tq, ts, bits=bits, shape=g.shape)
    np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))
    hi = 2 ** (bits - 1) - 1
    vals = tcompress.quant.unpack_payload(tq, bits, g.shape).to(torch.int32)
    if g.any():
        # the peak of each scale's group saturates at exactly ±hi
        assert int(vals.abs().max()) == hi
    else:
        assert int(vals.abs().max()) == 0
        assert not tb.any()


def test_nibble_payload_needs_shape():
    q, s = tcompress.quantize_leaf(torch.ones(3), bits=4)
    with pytest.raises(ValueError, match="logical shape"):
        tcompress.dequantize_leaf(q, s, bits=4)


def _tree(seed):
    return {"w": _leaf((33, 17), seed), "b": _leaf((7,), seed + 1, 1.0),
            "blocks": {"c": _leaf((4, 5, 6), seed + 2, 0.01)}}


def _ref_leaf_sync(c, per_channel, bits):
    """The reference's sync of one leaf on a one-device mesh, op by op:
    ``(dequantize(quantize(c)), c - dequantize(quantize(c)))``."""
    jc = jnp.asarray(c.numpy())
    jq, js = jcompress.quantize_leaf(jc, per_channel, bits=bits)
    back = jcompress.dequantize_leaf(jq, js, bits=bits, shape=tuple(c.shape))
    return np.asarray(back), np.asarray(jc - back)


@pytest.mark.parametrize("bits,per_channel", [(8, False), (8, True),
                                              (4, False), (4, True)])
def test_error_feedback_and_one_device_sync(bits, per_channel):
    """Q(c) + e' == c exactly, step after step, each step's synced leaves
    and residuals equal to the reference's leaf codec run op by op, and
    the first step equal to the reference's ``compressed_grad_sync`` on a
    one-device mesh (run eagerly: under ``jax.jit`` XLA:CPU rounds the
    scale or the residual otherwise, one ulp on 2.5-46 % of a leaf)."""
    mesh = tmesh.make_host_mesh()
    terr = tcompress.init_error_state(_as_torch(_tree(10)))
    for e in tree_leaves(terr):
        assert e.dtype == torch.float32 and not e.any()
    for step in range(3):
        g = _tree(20 + step)
        tg = _as_torch(g)
        tsync, terr_new = tcompress.compressed_grad_sync(
            tg, terr, mesh, per_channel=per_channel, bits=bits)
        if step == 0 and (bits, per_channel) == (8, False):
            jsync, jerr = jcompress.compressed_grad_sync(
                jax.tree.map(jnp.asarray, g),
                jcompress.init_error_state(jax.tree.map(jnp.asarray, g)),
                jax.make_mesh((1,), ("data",)), per_channel=per_channel,
                bits=bits)
            for a, b in zip(tree_leaves_sorted(tsync)
                            + tree_leaves_sorted(terr_new),
                            tree_leaves(jsync) + tree_leaves(jerr)):
                np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        for tl, el, gl, e0 in zip(tree_leaves(tsync), tree_leaves(terr_new),
                                  tree_leaves(tg), tree_leaves(terr)):
            c = gl + e0
            assert torch.equal(tl + el, c)
            want, want_err = _ref_leaf_sync(c, per_channel, bits)
            np.testing.assert_array_equal(tl.numpy(), want)
            np.testing.assert_array_equal(el.numpy(), want_err)
        terr = terr_new


def _as_torch(tree):
    if isinstance(tree, dict):
        return {k: _as_torch(v) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree))


def test_sync_keeps_dtypes_and_refuses_a_wider_mesh():
    g = {"w": torch.ones(4, 3, dtype=torch.bfloat16)}
    s, e = tcompress.compressed_grad_sync(
        g, tcompress.init_error_state(g), tmesh.make_host_mesh())
    assert s["w"].dtype == torch.bfloat16 and e["w"].dtype == torch.float32
    assert tcompress.reduce_axis(tmesh.HostMesh()) == "data"
    assert tcompress.reduce_axis(
        tmesh.HostMesh(shape=(1, 1), axis_names=("pod", "data"))) == "pod"
    # a HostMesh is one device: a ring of two over one is refused (a
    # DeviceMesh's data axis rings, tests/test_torch_mesh.py)
    with pytest.raises(ValueError, match="HostMesh is one device"):
        tcompress.compressed_grad_sync(
            g, tcompress.init_error_state(g), tmesh.HostMesh(shape=(2, 1)))
    with pytest.raises(ValueError, match="error state"):
        tcompress.compressed_grad_sync(g, {}, tmesh.make_host_mesh())


# ---------------------------------------------------------------------------
# the ring over a gloo process group
# ---------------------------------------------------------------------------

_WORKER = textwrap.dedent("""
    import sys
    import numpy as np
    import torch
    import torch.distributed as dist
    from repro_torch.dist import compress
    from repro_torch.launch import mesh as mesh_mod

    rank, n, port, bits, per_channel, out = sys.argv[1:7]
    rank, n, bits = int(rank), int(n), int(bits)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=n, rank=rank)
    data = np.load(out + f"/in_{rank}.npz")
    grads = {k: torch.from_numpy(data["g_" + k]) for k in ("w", "b")}
    err = {k: torch.from_numpy(data["e_" + k]) for k in ("w", "b")}
    synced, new_err = compress.compressed_grad_sync(
        grads, err, mesh_mod.HostMesh(), per_channel=per_channel == "1",
        bits=bits, group=dist.group.WORLD)
    np.savez(out + f"/out_{rank}.npz",
             **{"s_" + k: synced[k].numpy() for k in synced},
             **{"e_" + k: new_err[k].numpy() for k in new_err})
    dist.destroy_process_group()
""")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _np_quantize(c, per_channel, bits):
    hi = np.float32(2 ** (bits - 1) - 1)
    a = np.abs(c)
    if per_channel and c.ndim >= 2:
        peak = a.max(axis=tuple(range(1, c.ndim)))
    else:
        peak = a.max()
    scale = np.maximum(peak, np.float32(1e-30)).astype(np.float32) / hi
    s = scale.reshape(scale.shape + (1,) * (c.ndim - scale.ndim))
    q = np.clip(np.round(c / s), -hi, hi).astype(np.float32)
    return q * s


def _np_ring(cs, per_channel, bits):
    """Each rank's mean: its own dequantised shard, then r-1, r-2, ...
    added in f32, divided by n."""
    n = len(cs)
    deq = [_np_quantize(c, per_channel, bits) for c in cs]
    outs = []
    for r in range(n):
        acc = deq[r]
        for h in range(1, n):
            acc = (acc + deq[(r - h) % n]).astype(np.float32)
        outs.append((acc / np.float32(n)).astype(np.float32))
    return outs, [c - d for c, d in zip(cs, deq)]


@pytest.mark.parametrize("n,bits,per_channel", [(2, 8, False), (4, 4, True)])
def test_gloo_ring_equals_numpy_emulation(n, bits, per_channel):
    with tempfile.TemporaryDirectory() as out:
        cs = []
        for r in range(n):
            g = {"w": _leaf((33, 17), 100 + r), "b": _leaf((7,), 200 + r)}
            e = {"w": _leaf((33, 17), 300 + r, 1e-3),
                 "b": _leaf((7,), 400 + r, 1e-3)}
            np.savez(f"{out}/in_{r}.npz", **{"g_" + k: g[k] for k in g},
                     **{"e_" + k: e[k] for k in e})
            cs.append({k: g[k] + e[k] for k in g})
        port = _free_port()
        env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
                   OMP_NUM_THREADS="1")
        procs = [subprocess.Popen(
            [sys.executable, "-c", _WORKER, str(r), str(n), str(port),
             str(bits), str(int(per_channel)), out],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
            for r in range(n)]
        try:
            logs = [p.communicate(timeout=RING_TIMEOUT_S)[0] for p in procs]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        assert all(p.returncode == 0 for p in procs), \
            b"\n".join(logs).decode(errors="replace")
        for k in ("w", "b"):
            want, want_err = _np_ring([c[k] for c in cs], per_channel, bits)
            for r in range(n):
                got = np.load(f"{out}/out_{r}.npz")
                np.testing.assert_array_equal(got["s_" + k], want[r])
                np.testing.assert_array_equal(got["e_" + k], want_err[r])


def test_numpy_emulation_matches_the_reference_codec():
    """The emulation's quantiser is the reference's (the ring test rests
    on it)."""
    for per_channel in (False, True):
        for bits in (8, 4):
            c = _leaf((33, 17), 5)
            q, s = jcompress.quantize_leaf(jnp.asarray(c), per_channel,
                                           bits=bits)
            back = jcompress.dequantize_leaf(q, s, bits=bits, shape=c.shape)
            np.testing.assert_array_equal(
                _np_quantize(c, per_channel, bits), np.asarray(back))


# ---------------------------------------------------------------------------
# the steps and the launcher
# ---------------------------------------------------------------------------

def test_synced_step_threads_the_error_state():
    from repro_torch.configs import registry
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.models import kwt
    from repro_torch.optim import adamw

    cfg = registry.get("kwt-tiny").config
    shape = ShapeSpec("t", 26, 8, "train")
    params = kwt.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    hp = tsteps.hparams_for(cfg)
    opt = adamw.init(params, hp)
    err = tcompress.init_error_state(params)
    step = tsteps.make_train_step(cfg, shape, hp, n_micro=1,
                                  sync_mesh=tmesh.make_host_mesh(),
                                  sync_bits=4, sync_per_channel=True)
    batch = {"mfcc": torch.from_numpy(_leaf((8, 16, 26), 7, 1.0)),
             "labels": torch.arange(8) % 2}
    p1, o1, e1, m = step(params, opt, err, batch)
    assert np.isfinite(float(m["loss"]))
    assert any(bool(e.any()) for e in tree_leaves(e1))
    # the update saw Q(g): the residual is what the wire dropped
    loss_fn = tsteps._loss(cfg)
    _, g = tsteps.accumulate(lambda p, b: loss_fn(p, b, cfg), params, batch, 1)
    for gg, ee in zip(tree_leaves(g), tree_leaves(e1)):
        q, s = tcompress.quantize_leaf(gg, True, bits=4)
        assert torch.equal(ee, gg - tcompress.dequantize_leaf(
            q, s, bits=4, shape=gg.shape))


def test_synced_step_donates_the_error_state():
    """The step writes the new residuals into the tensors it was given and
    returns them: the update runs beside one error state, not two."""
    from repro_torch.configs import registry
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.models import kwt
    from repro_torch.optim import adamw

    cfg = registry.get("kwt-tiny").config
    shape = ShapeSpec("t", 26, 8, "train")
    params = kwt.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    hp = tsteps.hparams_for(cfg)
    err = tcompress.init_error_state(params)
    ptrs = [e.data_ptr() for e in tree_leaves(err)]
    step = tsteps.make_train_step(cfg, shape, hp, n_micro=1,
                                  sync_mesh=tmesh.make_host_mesh())
    batch = {"mfcc": torch.from_numpy(_leaf((8, 16, 26), 7, 1.0)),
             "labels": torch.arange(8) % 2}
    loss_fn = tsteps._loss(cfg)
    _, g = tsteps.accumulate(lambda p, b: loss_fn(p, b, cfg), params, batch, 1)
    _, want = tcompress.compressed_grad_sync(
        g, tcompress.init_error_state(params), tmesh.make_host_mesh())
    _, _, e1, _ = step(params, adamw.init(params, hp), err, batch)
    assert [e.data_ptr() for e in tree_leaves(e1)] == ptrs
    for a, b in zip(tree_leaves(e1), tree_leaves(want)):
        assert torch.equal(a, b)


def _train(argv):
    return ttrain.main(["--arch", "kwt-tiny", "--device", "cpu",
                        "--global-batch", "8"] + argv)


@pytest.mark.parametrize("extra", [[], ["--grad-bits", "4",
                                        "--per-channel-scales"]])
def test_launcher_crash_and_resume_from_err(extra):
    flags = ["--compressed-grads", "--steps", "6"] + extra
    full = _train(flags)
    assert full.err is not None
    with tempfile.TemporaryDirectory() as d:
        ck = ["--ckpt-dir", d, "--ckpt-every", "2"]
        with pytest.raises(RuntimeError, match="injected failure"):
            _train(flags + ck + ["--fail-at-step", "5"])
        assert os.path.isdir(os.path.join(d, "err"))
        resumed = _train(flags + ck)
    assert resumed.resumed_from == 4
    for a, b in zip(tree_leaves(full.params), tree_leaves(resumed.params)):
        assert torch.equal(a, b)
    for a, b in zip(tree_leaves(full.err), tree_leaves(resumed.err)):
        assert torch.equal(a, b)
    assert full.losses[-2:] == resumed.losses
