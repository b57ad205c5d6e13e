"""The port's dry run (``repro_torch.launch.dryrun``) and program pricing
(``launch.steps.lower_program`` / ``cost_programs``) against the
reference's, on the CPU.

* ``model_flops`` equal to the reference's on all 32 assigned cells;
* the ``cost_programs`` component names and multipliers equal, in order,
  on all 32 cells: the reference's on ``AbstractMesh((16, 16))``, the
  port's on its fake (16, 16) production mesh (in a subprocess: the fake
  world takes the process's one process group);
* on a one-device mesh at smoke size, every family and step kind: the
  argument bytes are the arguments' tensor bytes, the alias bytes the
  donated arguments', no collective, and the matmul FLOPs (``mm`` /
  ``bmm`` / ``addmm``) of the combined components equal the whole
  step's — exactly, but for two documented quirks of the reference's
  decomposition, held to their exact size: a prefill's ``outside``
  prices the head on every position where the step runs it on the last
  one (dense, moe, rwkv, hybrid), and whisper's prefill and decode have
  no ``outside`` (the head on the last position goes unpriced);
* the dry run's cut memory walks (the method each cell takes by itself)
  against the whole step's walk at smoke size: ``two_point_layers``
  (rwkv and hymba, train and prefill) equal to it, field by field, where
  activations set the peak; where the weights' gradients do, its temps
  are not exact and it errs low (rwkv6-3b at 4 layers, a train step of
  2 x 16 tokens: 2.955 % of the whole peak below it), held there within
  ``CUT_LOW`` of the whole peak, the other fields exact.  ``PERF.md``
  holds the four single-pod cells that take it against their whole walks
  at full width (within 2.1 MB, also low);
  ``three_microbatches`` never below it, and above it by at most the
  float32 losses of the microbatches after the third
  (``dryrun._LOSS_BYTES`` each; measured 0 or 20 bytes);
* on a fake (2, 2) mesh at smoke size (dense and moe): the argument
  bytes are rank 0's shards'; the recorded all-gather and all-reduce
  bytes equal a reckoning from
  ``param_pspecs`` and ``dist.spmd``'s design — every sharded leaf
  gathered whole once (DTensor gathers the last mesh dim first, each
  all-gather's result the leaf over the dims not gathered yet), the
  expert stacks over ``"data"`` only, the gradients' DP mean, the loss's
  mean, the update's global norm, and the expert-parallel region's sums;
* the port's combined FLOPs against the reference's compiled
  ``cost_analysis()["flops"]`` at smoke size on one device, the decode
  cell of every family: the port's ATen charges are unfused, XLA's are
  after fusion.  Measured ratios 0.932 (whisper) to 1.018 (hymba);
  held within ``FLOPS_RATIO`` [0.92, 1.03];
* ``launch.dryrun.main(["--list"])``, and ``python -m
  repro_torch.launch.dryrun`` on one full-width cell (internlm2-1.8b
  decode_32k, single pod) in a subprocess, and the record's schema.
"""

import json
import os
import subprocess
import sys
import tempfile
import textwrap

import jax
import pytest

from repro.configs import registry as jregistry
from repro.configs.base import ShapeSpec as JShape
from repro.launch import dryrun as jdryrun
from repro.launch import mesh as jmesh
from repro.launch import steps as jsteps
from repro_torch.configs import registry as tregistry
from repro_torch.configs.base import ShapeSpec
from repro_torch.core.tree import tree_leaves
from repro_torch.launch import dryrun as tdryrun
from repro_torch.launch import steps as tsteps
from repro_torch.launch.mesh import HostMesh
from repro_torch.perf import cost as tcost

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT_S = 300
FLOPS_RATIO = (0.92, 1.03)
FAMILIES = {"dense": "internlm2-1.8b", "moe": "granite-moe-3b-a800m",
            "rwkv": "rwkv6-3b", "hybrid": "hymba-1.5b",
            "encdec": "whisper-large-v3"}
SHAPES = {"train": ShapeSpec("train_4k", 32, 8, "train"),
          "prefill": ShapeSpec("prefill_32k", 64, 2, "prefill"),
          "decode": ShapeSpec("decode_32k", 64, 4, "decode")}
MATMULS = ("mm", "bmm", "addmm")
# how far below the whole walk's peak a two-point cut may come where the
# weights' gradients set the peak (measured 2.955 % on CUT's last case)
CUT_LOW = 0.03


def _env():
    return dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
                OMP_NUM_THREADS="1")


def _run(code_or_args, *argv):
    args = [sys.executable] + (
        ["-c", code_or_args] if isinstance(code_or_args, str)
        else list(code_or_args)) + list(argv)
    p = subprocess.run(args, env=_env(), capture_output=True, text=True,
                       timeout=TIMEOUT_S, cwd=ROOT)
    assert p.returncode == 0, (p.stdout[-2000:], p.stderr[-4000:])
    return p.stdout


def _cells():
    for arch in jregistry.ASSIGNED:
        entry = jregistry.get(arch)
        for shape in entry.shapes:
            if shape.name not in entry.skips:
                yield arch, shape


# ---------------------------------------------------------------------------
# (i), (ii): every cell against the reference, the port on its fake mesh
# ---------------------------------------------------------------------------

_PRODUCTION = textwrap.dedent("""
    import json, sys
    from repro_torch.configs import registry
    from repro_torch.launch import dryrun, mesh, steps
    mesh.init_fake_world()
    m = mesh.make_production_mesh()
    out = {}
    for arch in registry.ASSIGNED:
        entry = registry.get(arch)
        for shape in entry.shapes:
            if shape.name in entry.skips:
                continue
            out[arch + "|" + shape.name] = {
                "comps": [[c.name, c.multiplier] for c in
                          steps.cost_programs(entry.config, shape, m)],
                "model_flops": dryrun.model_flops(entry.config, shape)}
    with open(sys.argv[1], "w") as f:
        json.dump(out, f)
""")


@pytest.fixture(scope="module")
def production():
    with tempfile.TemporaryDirectory() as d:
        _run(_PRODUCTION, d + "/out.json")
        with open(d + "/out.json") as f:
            return json.load(f)


def test_every_cell_prices_as_the_reference(production):
    mesh = jax.sharding.AbstractMesh((16, 16), ("data", "model"))
    cells = list(_cells())
    assert len(cells) == 32 == len(production)
    for arch, shape in cells:
        got = production[arch + "|" + shape.name]
        cfg = jregistry.get(arch).config
        assert got["model_flops"] == jdryrun.model_flops(cfg, shape), arch
        want = [[c.name, c.multiplier]
                for c in jsteps.cost_programs(cfg, shape, mesh)]
        assert got["comps"] == want, (arch, shape.name)


# ---------------------------------------------------------------------------
# (iii): smoke identities on a one-device mesh
# ---------------------------------------------------------------------------

def _matmul_flops(lowered) -> float:
    return sum(tcost.op_flops(r) for r in lowered.records
               if r.name in MATMULS)


def _tensor_bytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in tree_leaves(tree)
               if hasattr(t, "numel"))


@pytest.mark.parametrize("kind", list(SHAPES))
@pytest.mark.parametrize("family", list(FAMILIES))
def test_components_price_the_whole_step(family, kind):
    cfg = tregistry.get(FAMILIES[family]).smoke
    shape = SHAPES[kind]
    host = HostMesh()
    prog = tsteps.build_step_program(cfg, shape, host)
    whole = tsteps.lower_program(prog, host)
    mem = whole.memory_analysis()
    assert mem.argument_size_in_bytes == _tensor_bytes(prog.args)
    assert mem.alias_size_in_bytes == sum(_tensor_bytes(prog.args[i])
                                          for i in prog.donate)
    assert mem.temp_size_in_bytes > 0
    assert whole.collectives() == {}
    combined = 0.0
    for cp in tsteps.cost_programs(cfg, shape, host):
        lowered = tsteps.lower_program(cp, host)
        assert lowered.collectives() == {}
        combined += cp.multiplier * _matmul_flops(lowered)
    head = 2.0 * shape.global_batch * cfg.d_model * cfg.padded_vocab
    quirk = 0.0
    if kind == "prefill" and family != "encdec":
        quirk = head * (shape.seq_len - 1)       # outside: every position
    elif kind != "train" and family == "encdec":
        quirk = -head                            # no outside at all
    assert combined == _matmul_flops(whole) + quirk


CUT = [  # arch, layers, shape, method, exact
    ("granite-8b", 5, ShapeSpec("train_4k", 16, 16, "train"),
     "three_microbatches", True),
    ("deepseek-moe-16b", 2, ShapeSpec("train_4k", 16, 16, "train"),
     "three_microbatches", True),
    ("nemotron-4-340b", 2, ShapeSpec("train_4k", 16, 16, "train"),
     "three_microbatches", True),
    ("rwkv6-3b", 4, ShapeSpec("train_4k", 64, 8, "train"),
     "two_point_layers", True),
    ("rwkv6-3b", 4, ShapeSpec("prefill_32k", 256, 2, "prefill"),
     "two_point_layers", True),
    ("hymba-1.5b", 4, ShapeSpec("train_4k", 64, 8, "train"),
     "two_point_layers", True),
    ("hymba-1.5b", 4, ShapeSpec("prefill_32k", 256, 2, "prefill"),
     "two_point_layers", True),
    # a short, narrow batch: the weights' gradients set the peak
    ("rwkv6-3b", 4, ShapeSpec("train_4k", 16, 2, "train"),
     "two_point_layers", False),
]


@pytest.mark.parametrize("arch,layers,shape,method,exact", CUT,
                         ids=[f"{c[0]}-{c[3]}" + ("" if c[4] else "-inexact")
                              for c in CUT])
def test_cut_memory_walks_hold_to_the_whole_walk(arch, layers, shape,
                                                 method, exact):
    """The dry run's cut memory walks at smoke size: the layer two-point
    one equals the whole walk field by field where activations set the
    peak, and where the weights' gradients do its arguments, outputs and
    aliases do and its peak lies at most ``CUT_LOW`` below; the
    three-microbatch one never below it and above it by at most the
    later microbatches' float32 losses."""
    cfg = tregistry.get(arch).smoke.with_(n_layers=layers)
    host = HostMesh()
    whole, m1 = tdryrun.memory(cfg, shape, host, "whole")
    cut, m2 = tdryrun.memory(cfg, shape, host)
    assert (m1, m2) == ("whole", method)
    if method != "three_microbatches":
        if exact:
            assert cut == whole
            return
        for key in ("argument_bytes", "output_bytes", "alias_bytes"):
            assert cut[key] == whole[key]
        low = whole["peak_bytes_est"] - cut["peak_bytes_est"]
        assert 0 < low <= CUT_LOW * whole["peak_bytes_est"]
        return
    n = tsteps.microbatches(cfg, shape, host)
    assert n > 4
    for key in ("argument_bytes", "output_bytes", "alias_bytes"):
        assert cut[key] == whole[key]
    slack = cut["peak_bytes_est"] - whole["peak_bytes_est"]
    assert 0 <= slack <= tdryrun._LOSS_BYTES * (n - 3)


# ---------------------------------------------------------------------------
# (iv): collectives on a fake (2, 2) mesh against the design's reckoning
# ---------------------------------------------------------------------------

_MESH22 = textwrap.dedent("""
    import json, sys
    from repro_torch.configs import registry
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.core.tree import tree_leaves, tree_map
    from repro_torch.dist import sharding
    from repro_torch.launch import mesh, steps
    mesh.init_fake_world(4)
    m = mesh.make_host_mesh(2, 2)
    out = {}
    for arch in sys.argv[2:]:
        cfg = registry.get(arch).smoke
        prog = steps.build_step_program(
            cfg, ShapeSpec("train", 16, 8, "train"), m)
        lowered = steps.lower_program(prog, m)
        # rank 0's shards, each its own tensor (on a device it is)
        shards = [t.clone() for a, sh in zip(prog.args, prog.shardings)
                  for t in tree_leaves(sharding.local(sharding.place(
                      a, tree_map(lambda ns: ns.spec, sh), m)))]
        out[arch] = {"collectives": lowered.collectives(),
                     "arguments": lowered.memory_analysis()
                     .argument_size_in_bytes,
                     "shards": sum(t.numel() * t.element_size()
                                   for t in shards)}
    with open(sys.argv[1], "w") as f:
        json.dump(out, f)
""")
MESH22 = {"data": 2, "model": 2}


def _names(part):
    return part if isinstance(part, tuple) else (part,)


def _gathered(numel, itemsize, spec, expert):
    """All-gather result bytes of one leaf's gather under the design."""
    dims = [a for a in MESH22 if any(a in _names(p) for p in spec)]
    n = numel * itemsize
    if expert and "model" in dims:            # the rank keeps its experts
        dims.remove("model")
        n //= MESH22["model"]
    total = 0
    while dims:                                # last mesh dim first
        dims.pop()
        rest = 1
        for a in dims:
            rest *= MESH22[a]
        total += n // rest
    return total


def _reckoning(arch):
    cfg = tregistry.get(arch).smoke
    params = tsteps.params_shape(cfg)
    specs = tsteps.param_pspecs(cfg)
    gather = reduce = 0
    for (path, leaf), spec in zip(tdryrun._flat_with_path(params),
                                  tree_leaves(specs)):
        expert = len(path) >= 2 and path[-2] == "moe" and \
            path[-1] in ("w_gate", "w_up", "w_down")
        gather += _gathered(leaf.numel(), leaf.element_size(), tuple(spec),
                            expert)
        # the gradient's DP mean: whole, an expert stack's model slice
        reduce += leaf.numel() * 4 // (MESH22["model"] if expert else 1)
    reduce += 4 + 4 * len(MESH22)     # the loss's mean, the global norm
    if cfg.family == "moe":
        # each layer's expert-parallel region over "model": the experts'
        # sum forward, and backward the tokens' and the router's grads
        tokens = 8 // MESH22["data"] * 16
        reduce += cfg.n_layers * 4 * (2 * tokens * cfg.d_model
                                      + cfg.d_model * cfg.n_experts)
    return {"all-gather": gather, "all-reduce": reduce}


def test_mesh_step_collectives_follow_the_design():
    archs = ("granite-8b", "granite-moe-3b-a800m")
    with tempfile.TemporaryDirectory() as d:
        _run(_MESH22, d + "/out.json", *archs)
        with open(d + "/out.json") as f:
            got = json.load(f)
    for arch in archs:
        assert got[arch]["collectives"] == _reckoning(arch), arch
        # the arguments are rank 0's shards, not the tensors cut from
        assert got[arch]["arguments"] == got[arch]["shards"], arch


# ---------------------------------------------------------------------------
# (v): the port's FLOPs against XLA's at smoke size
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("family", list(FAMILIES))
def test_combined_flops_near_the_reference_compiled(family):
    arch = FAMILIES[family]
    shape = SHAPES["decode"]
    jm = jmesh.make_host_mesh(1, 1)
    jshape = JShape(shape.name, shape.seq_len, shape.global_batch, shape.kind)
    want = jdryrun.combine([
        (cp.name, cp.multiplier,
         jdryrun.cost_of(jsteps.lower_program(cp, jm).compile()))
        for cp in jsteps.cost_programs(jregistry.get(arch).smoke, jshape, jm)])
    host = HostMesh()
    got = tdryrun.combine([
        (cp.name, cp.multiplier,
         tdryrun.cost_of(tsteps.lower_program(cp, host)))
        for cp in tsteps.cost_programs(tregistry.get(arch).smoke, shape,
                                       host)])
    assert [c["name"] for c in got["components"]] == \
        [c["name"] for c in want["components"]]
    ratio = got["flops"] / want["flops"]
    assert FLOPS_RATIO[0] <= ratio <= FLOPS_RATIO[1], ratio


# ---------------------------------------------------------------------------
# (vi): the CLI
# ---------------------------------------------------------------------------

def test_cli_lists_and_runs_a_full_width_cell(capsys):
    tdryrun.main(["--mesh", "single", "--list"])       # no fake world
    listed = capsys.readouterr().out.splitlines()
    assert len(listed) == 40
    assert sum("(skip)" in line for line in listed) == 8
    with tempfile.TemporaryDirectory() as d:
        out = _run(["-m", "repro_torch.launch.dryrun", "--arch",
                    "internlm2-1.8b", "--shape", "decode_32k", "--mesh",
                    "single", "--force", "--results-dir", d])
        assert "dry-run complete." in out
        with open(os.path.join(
                d, "internlm2-1.8b__decode_32k__single.json")) as f:
            rec = json.load(f)
    assert set(rec) == {"arch", "shape", "mesh", "n_chips", "device_model",
                        "rank", "memory", "memory_method", "fits_hbm",
                        "fits_hbm_no_donation", "cost", "model_flops", "model_to_hlo", "roofline",
                        "lower_s"}
    assert rec["n_chips"] == 256 and rec["device_model"] == "h100-sxm"
    assert rec["memory_method"] == "whole" and rec["rank"] == 0
    mem = rec["memory"]
    assert set(mem) == {"argument_bytes", "output_bytes", "temp_bytes",
                        "alias_bytes", "peak_bytes_est", "peak_no_donation"}
    assert mem["peak_bytes_est"] == (mem["argument_bytes"]
                                     + mem["output_bytes"]
                                     + mem["temp_bytes"]
                                     - mem["alias_bytes"])
    assert mem["peak_no_donation"] == mem["peak_bytes_est"] \
        + mem["alias_bytes"]
    assert rec["fits_hbm"] == (mem["peak_bytes_est"] <= 80e9)
    assert rec["fits_hbm_no_donation"] == (mem["peak_no_donation"] <= 80e9)
    assert [c["name"] for c in rec["cost"]["components"]] == \
        ["block_step", "outside"]
    assert set(rec["roofline"]) == {"compute_s", "memory_s",
                                    "collective_s", "dominant"}
    assert rec["cost"]["collective_bytes"] > 0     # the weights' gather
    assert rec["model_flops"] == jdryrun.model_flops(
        jregistry.get("internlm2-1.8b").config,
        JShape("decode_32k", 32768, 128, "decode"))
