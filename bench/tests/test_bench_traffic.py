"""Every traffic kind rehearsed on the CPU at a tiny size through the
harness's functions (the command needs a card), and the frozen copies of
the program's generators."""

import math

import numpy as np
import pytest
import torch

from bench.core import weights
from bench.tests import tiny


@pytest.mark.parametrize("cell", sorted(tiny.CASES))
@pytest.mark.parametrize("trace", [False, True])
def test_rehearsal(spec, cell, trace):
    res = tiny.run(spec, cell, trace=trace)
    assert res["correct"], res["checks"]
    assert res["attempted"] >= 1 and res["failed"] == 0
    assert list(res)[-1] == "checks"
    want = spec.per_layer(cell) if trace else spec.end_to_end(cell)
    got = set(res["metrics"])
    if trace:
        # readers of the device trace find nothing on the CPU
        want = [m for m in want if m["source"] != "device_trace"]
        assert "breakdown" in res and "busy_s" in res["device"]
    assert {m["name"] for m in want} == got
    for m in res["metrics"].values():
        assert math.isfinite(m["value"])


def test_audio_is_the_programs_generator_bit_for_bit():
    from repro_torch.data import pipeline

    from bench.traffic import audio
    for seed, sid, hops in ((1, 0, 400), (2**31 + 9, 17, 1000), (5, 3, 37)):
        a, ev = audio.keyword_event_stream(seed, sid, n_hops=hops)
        b, ev2 = pipeline.keyword_event_stream(seed, sid, n_hops=hops)
        assert a.dtype == b.dtype and np.array_equal(a, b) and ev == ev2


@pytest.mark.parametrize("arch", ["kwt-1", "internlm2-1.8b"])
def test_weight_layout_is_the_programs(spec, arch):
    """The harness lays the tree out as the program's ``init_params`` does,
    leaf for leaf, at full size (shapes only, on the meta device)."""
    from repro_torch.models import kwt, transformer

    from bench.core import program
    cfg_json = spec.config(arch)
    cfg = program.model_config(cfg_json)
    mod = kwt if cfg.family == "kwt" else transformer
    theirs = mod.init_params(cfg, torch.Generator(), device="meta")
    ours = spec.model_family(cfg_json["model"]["family"]).layout(
        cfg_json["model"])

    def shapes(t):
        if isinstance(t, dict):
            return {k: shapes(v) for k, v in t.items()}
        if isinstance(t, list):
            return [shapes(v) for v in t]
        return tuple(t.shape) if isinstance(t, torch.Tensor) else tuple(t[0])
    assert shapes(ours) == shapes(theirs)


def test_weight_recipe(spec):
    """One seed, one tree; the recipe chip_smoke.py's seeded weights
    follow (matrices 1/sqrt(fan-in), norm scales about 1, vectors 0.1),
    drawn on the device instead of by numpy."""
    from bench.tests.tiny import LM
    model = {"family": "dense", "vocab_size": 256, **LM}
    model["n_layers"] = 4
    lay = spec.model_family("dense").layout(model)
    recipe = {"norm_mean": 1.0, "norm_std": 0.1, "vector_std": 0.1}
    a = weights.draw(lay, recipe, 11, "cpu")
    b = weights.draw(lay, recipe, 11, "cpu")
    c = weights.draw(lay, recipe, 12, "cpu")
    assert torch.equal(a["lm_head"], b["lm_head"])
    assert not torch.equal(a["lm_head"], c["lm_head"])
    wq = a["blocks"]["attn"]["wq"]
    assert abs(float(wq.std()) - 1 / math.sqrt(64)) < 0.01
    assert abs(float(a["blocks"]["ln1"]["scale"].mean()) - 1.0) < 0.02
    assert abs(float(a["embed"].std()) - 1 / math.sqrt(256)) < 0.005


def test_no_two_calls_send_the_same_input(spec):
    """Every call of a run sends inputs of its own (a view of the pool, no
    copy), and the checked calls include the run's last."""
    from bench.core import sample
    res_ctx = tiny.context(spec, "kwt1.bulk")
    bulk = spec.traffic("bulk_forward").Cell(res_ctx)
    bulk.pool = torch.zeros(64, 40, 98)
    bulk.p = {**bulk.p, "batch": 8}
    bulk.offsets = np.random.default_rng(1).permutation(64 - 8 + 1)
    starts = [bulk.batch(j).data_ptr() for j in range(57)]
    assert len(set(starts)) == 57
    assert bulk.batch(3).data_ptr() == bulk.pool[bulk.offsets[3]].data_ptr()
    lm = spec.traffic("lm_score").Cell(tiny.context(spec,
                                                    "internlm2.score_8k"))
    lm.pool = torch.arange(5)[:, None, None].expand(5, 1, 3)
    assert [int(lm.tokens(j)[0, 0]) for j in range(4)] == [0, 1, 2, 3]
    assert int(lm.tokens(-1)[0, 0]) == 4
    for seed in (1, 2**31 + 77):
        picks = sample.pick_calls(40, 3, seed)
        assert len(picks) == 3 and picks[-1] == 39
    assert sample.pick_calls(1, 2, 5) == [0]
