"""The port's partition specs (``repro_torch.dist.sharding.P`` trees)
against the reference's ``PartitionSpec`` trees, leaf for leaf, on every
config in ``configs/`` — the full configs and their smoke reductions —
and ``launch.steps.build_step_program`` on the four LM shapes of
``configs/base.py`` against the reference's programs.

The specs are pure functions of a config: equality is exact (the same
entries per tensor dim, in the reference's ``jax.tree.leaves`` order).
Programs are built on a (2, 2) mesh — an ``AbstractMesh`` there, a
``HostMesh`` of that shape here — so that ``dp_for`` replicates
long_500k's batch of one and the KV-cache specs see a TP size of 2.
"""

import jax
import pytest
from jax.sharding import AbstractMesh
from jax.sharding import PartitionSpec as JP

from repro.configs import registry as jregistry
from repro.configs.base import LM_SHAPES as J_SHAPES
from repro.launch import steps as jsteps
from repro.models import encdec as JE
from repro.models import kwt as JK
from repro.models import layers as JL
from repro.models import moe as JM
from repro.models import rwkv as JR
from repro.models import ssm as JS
from repro.models import transformer as JT
from repro.optim import adamw as jadamw
from repro_torch.configs import registry as tregistry
from repro_torch.configs.base import LM_SHAPES as T_SHAPES
from repro_torch.core.tree import tree_leaves_sorted
from repro_torch.dist.sharding import P, placements
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import steps as tsteps
from repro_torch.models import encdec as TE
from repro_torch.models import kwt as TK
from repro_torch.models import layers as TL
from repro_torch.models import moe as TM
from repro_torch.models import rwkv as TR
from repro_torch.models import ssm as TS
from repro_torch.models import transformer as TT
from repro_torch.optim import adamw as tadamw

ARCHS = sorted(tregistry.ARCHS)
DPS = [("data",), None, ("pod", "data")]

# (reference module, port module, function, families, takes dp / tp)
SPEC_FNS = [
    (JL, TL, "norm_specs", None, ""),
    (JL, TL, "attention_specs", None, ""),
    (JL, TL, "mlp_specs", None, ""),
    (JL, TL, "kv_cache_specs", ("dense", "moe", "hybrid", "encdec"), "dp,tp"),
    (JK, TK, "param_specs", ("kwt",), ""),
    (JM, TM, "moe_specs", ("moe",), ""),
    (JR, TR, "time_mix_specs", ("rwkv",), ""),
    (JR, TR, "channel_mix_specs", ("rwkv",), ""),
    (JR, TR, "block_specs", ("rwkv",), ""),
    (JR, TR, "state_specs", ("rwkv",), "dp"),
    (JS, TS, "mamba_specs", ("hybrid",), ""),
    (JS, TS, "mamba_state_specs", ("hybrid",), "dp"),
    (JS, TS, "block_specs", ("hybrid",), ""),
    (JT, TT, "block_specs", ("dense", "moe", "rwkv", "hybrid"), ""),
    (JT, TT, "param_specs", ("dense", "moe", "rwkv", "hybrid"), ""),
    (JT, TT, "decode_state_specs", ("dense", "moe", "rwkv", "hybrid"),
     "dp,tp"),
    (JE, TE, "cross_attention_specs", ("encdec",), ""),
    (JE, TE, "enc_block_specs", ("encdec",), ""),
    (JE, TE, "dec_block_specs", ("encdec",), ""),
    (JE, TE, "param_specs", ("encdec",), ""),
    (JE, TE, "decode_state_specs", ("encdec",), "dp,tp"),
]


def _flat(jtree):
    return [tuple(s) for s in jax.tree.leaves(
        jtree, is_leaf=lambda x: isinstance(x, JP))]


def _port_flat(ttree):
    leaves = tree_leaves_sorted(ttree)
    assert all(isinstance(s, P) for s in leaves)
    return [tuple(s) for s in leaves]


def _same(jtree, ttree):
    want, got = _flat(jtree), _port_flat(ttree)
    assert got == want
    return len(got)


def _cfgs(name, variant):
    return (getattr(jregistry.get(name), variant),
            getattr(tregistry.get(name), variant))


@pytest.mark.parametrize("variant", ["config", "smoke"])
@pytest.mark.parametrize("name", ARCHS)
def test_every_spec_function_matches_the_reference(name, variant):
    jcfg, tcfg = _cfgs(name, variant)
    checked = 0
    for jmod, tmod, fn, families, extra in SPEC_FNS:
        if families is not None and jcfg.family not in families:
            continue
        calls = [()]
        if extra == "dp":
            calls = [(dp,) for dp in DPS]
        elif extra == "dp,tp":
            calls = [(dp, tp) for dp in DPS for tp in (1, 2, 16)]
        for args in calls:
            checked += _same(getattr(jmod, fn)(jcfg, *args),
                             getattr(tmod, fn)(tcfg, *args))
    assert checked > 0


@pytest.mark.parametrize("variant", ["config", "smoke"])
@pytest.mark.parametrize("name", ARCHS)
def test_step_pspecs_and_optimizer_specs_match(name, variant):
    jcfg, tcfg = _cfgs(name, variant)
    _same(jsteps.param_pspecs(jcfg), tsteps.param_pspecs(tcfg))
    for int8 in (False, True):
        _same(jadamw.opt_state_specs(jsteps.param_pspecs(jcfg),
                                     jadamw.HParams(int8_moments=int8)),
              tadamw.opt_state_specs(tsteps.param_pspecs(tcfg),
                                     tadamw.HParams(int8_moments=int8)))
    if jcfg.family == "kwt":
        return
    for dp in DPS:
        _same(jsteps.decode_state_pspecs(jcfg, dp, 2),
              tsteps.decode_state_pspecs(tcfg, dp, 2))
        for js, ts in zip(J_SHAPES, T_SHAPES):
            _same(jsteps.batch_pspec(jcfg, js, dp),
                  tsteps.batch_pspec(tcfg, ts, dp))
    for js, ts in zip(J_SHAPES, T_SHAPES):
        assert tsteps.seq_axis_for(tcfg, ts) == jsteps.seq_axis_for(jcfg, js)


LM_ARCHS = [n for n in ARCHS if not n.startswith("kwt")]


@pytest.mark.parametrize("name", LM_ARCHS)
def test_build_step_program_matches_the_reference(name):
    jcfg, tcfg = _cfgs(name, "config")
    jmesh = AbstractMesh((2, 2), ("data", "model"))
    tm = tmesh.HostMesh(shape=(2, 2))
    for js, ts in zip(J_SHAPES, T_SHAPES):
        want = jsteps.build_step_program(jcfg, js, jmesh)
        got = tsteps.build_step_program(tcfg, ts, tm)
        assert (got.name, got.donate, got.seq_axis, got.dp,
                got.multiplier) == (want.name, want.donate, want.seq_axis,
                                    want.dp, want.multiplier)
        assert tsteps.dp_for(ts, tm) == jsteps.dp_for(js, jmesh)
        if ts.kind == "train":
            assert tsteps.microbatches(tcfg, ts, tm) == \
                jsteps.microbatches(jcfg, js, jmesh)
        assert len(got.shardings) == len(want.shardings) == len(got.args)
        for jsh, tsh in zip(want.shardings, got.shardings):
            _same(jax.tree.map(lambda ns: ns.spec, jsh),
                  [ns.spec for ns in tree_leaves_sorted(tsh)])
        # the args are meta tensors of the reference's shapes (a decode
        # state's index is an int here, a scalar there)
        jargs = [tuple(a.shape) for a in jax.tree.leaves(want.args)]
        targs = [tuple(getattr(a, "shape", ()))
                 for a in tree_leaves_sorted(got.args)]
        assert targs == jargs


def test_placements_of_a_spec():
    from torch.distributed.tensor import Replicate, Shard
    m = tmesh.HostMesh(shape=(2, 2))
    assert placements(P("data", "model"), m) == (Shard(0), Shard(1))
    assert placements(P(None, "data"), m) == (Shard(1), Replicate())
    assert placements(P(("data", "model"), None), m) == (Shard(0), Shard(0))
    # a name the mesh lacks is dropped (the reference's ctx._present)
    assert placements(P("pod", "model"), m) == (Replicate(), Shard(1))
    assert placements(P(), m) == (Replicate(), Replicate())
    assert P(("data",), None) == P("data", None) == ("data", None)
    assert P(None) != P()
