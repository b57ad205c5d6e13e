"""The plain references against the port at small sizes on the CPU (the
``lut`` plan: the ``cuda`` plan's numbers in plain PyTorch).  This file
may import both; the references themselves import nothing of the port."""

import dataclasses

import numpy as np
import pytest
import torch

from bench.ref import numerics as nx
from bench.tests import tiny


def test_tables_are_the_papers():
    from repro_torch.core import lut
    bank = lut.make_lut_bank()
    t = nx.tables_np()
    for name in ("exp_f32", "exp_q24", "inv_q24", "gelu_f32"):
        assert np.array_equal(t[name], getattr(bank, name)), name
    from repro_torch.core import approx
    assert np.array_equal(t["sig_f32"], approx._sigmoid_table())


@pytest.mark.parametrize("n", [27, 99, 128, 200, 1024])
def test_softmax_q24(n):
    from repro_torch.core import approx
    x = torch.randn(64, n, generator=torch.Generator().manual_seed(n)) * 3
    assert torch.equal(nx.softmax_q24(x),
                       approx.softmax_lut(x, fixed=True))


def test_gelu_silu_exp():
    from repro_torch.core import approx
    x = torch.linspace(-12, 12, 100_001)
    assert torch.equal(nx.gelu_lut(x), approx.gelu_lut(x))
    assert torch.equal(nx.silu_lut(x), approx.silu(x, mode="lut"))
    z = torch.linspace(-1, 11, 10_001)
    from repro_torch.core import lut
    tab = lut.bank_tensors("cpu")["exp_f32"]
    assert torch.equal(nx.exp_lut(z), tab[approx._exp_index_f32(
        z.clamp(0.0, 10.0))])


@pytest.mark.parametrize("per_channel,shape", [(False, (40, 64)),
                                               (True, (3, 64, 96)),
                                               (True, (5, 32))])
def test_ptq_is_the_recipe(per_channel, shape):
    from repro_torch.core import quant
    from repro_torch.runtime import QuantRecipe
    w = torch.randn(shape, generator=torch.Generator().manual_seed(1)) * 0.2
    w[..., 3] *= 40                             # a channel that saturates
    for bits in (8, 4):
        r = QuantRecipe(per_channel=per_channel, bits=bits)
        want = quant.dequantize_tree(r.quantize({"w": w}))["w"]
        assert torch.equal(nx.ptq(w, 6, bits, per_channel)[2], want)


def test_kwt_reference_is_the_port(spec):
    from bench.core import program, weights
    from bench.ref import kwt as ref
    ctx = tiny.context(spec, "kwt1.bulk")
    tree = weights.draw(ctx.family.layout(ctx.model), ctx.config["weights"], 3,
                        "cpu")
    eng = program.compile_engine(ctx.config, ctx.model_config(), tree,
                                 ctx.device, ctx.plan)
    x = torch.randn(16, 40, 98, generator=torch.Generator().manual_seed(2))
    w = ref.prepare(tree, ctx.model, ctx.config["quant"])
    want = ref.forward(w, x * 0.5, ctx.model, 5)
    assert torch.equal(eng.forward(x * 0.5), want)


def test_dense_reference_is_the_port(spec):
    from bench.core import program, weights
    from bench.ref import dense as ref
    from bench.traffic import lm_score
    ctx = tiny.context(spec, "internlm2.score_1k")
    tree = weights.draw(ctx.family.layout(ctx.model), ctx.config["weights"], 3,
                        "cpu")
    eng = program.compile_engine(ctx.config, ctx.model_config(), tree,
                                 ctx.device, ctx.plan)
    tok = torch.randint(0, 256, (2, 300),
                        generator=torch.Generator().manual_seed(4))
    got = lm_score.next_token_logprobs(eng.forward(tok), tok)
    w = ref.prepare(tree, ctx.config["quant"])
    assert torch.equal(got, ref.logprobs(w, tok, ctx.model, 5))


def test_stream_reference_follows_the_port(spec):
    """Every score of every lane at every step of the rehearsal, within
    the cell's limits of the port's (its frontend takes its products a
    frame at a time, so an eq-9 cast can land a step apart)."""
    ctx = tiny.context(spec, "kwt1.streams",
                       param_overrides={"check_steps": 10 ** 6})
    from bench.core import runner
    import time
    res = runner.run(ctx, 3.0, False, time.perf_counter())
    assert [c["name"] for c in res["checks"]] == [
        "score_gap_rel", "score_gap_rel_median", "event_mismatch", "tf32"]
    assert res["correct"], res["checks"]


def test_detector_events_are_the_port_s():
    """The reference's detector fires where the port's does, on the same
    scores, through joins, warm-up, hysteresis and the refractory
    period."""
    from repro_torch.stream import detector as det
    from bench.ref import kwt_stream
    cfg = det.DetectorConfig(smooth_hops=2, on_threshold=0.6,
                             off_threshold=0.4, refractory_hops=3)
    lanes, steps, t, k = 6, 60, 12, 4
    rng = np.random.default_rng(3)
    probs = rng.uniform(0.0, 1.0, (steps, lanes)).astype(np.float32)
    ids = np.zeros((steps, lanes), np.int64)
    joins = [(7, 0), (7, 3), (20, 1), (33, 0), (33, 5), (50, 2)]
    for j, lane in joins:
        ids[j:, lane] += 1
    state = det.detector_init(cfg, lanes, device="cpu")
    count = np.zeros(lanes, np.int64)
    scores, fired = [], []
    for j in range(steps):
        for jj, lane in joins:
            if jj == j:
                state = det.detector_reset_lane(state, lane)
                count[lane] = 0
        count = np.minimum(count + k, t)
        p = torch.zeros(lanes, 2)
        p[:, 1] = torch.from_numpy(probs[j])
        state, ev = det.detector_step(state, p, cfg,
                                      warm=torch.from_numpy(count >= t))
        scores.append(ev["score"].numpy())
        fired.append(ev["fired"].numpy())
    fired = np.stack(fired)
    assert fired.sum() > 5
    want = kwt_stream.detector_events(np.stack(scores), ids,
                                      dataclasses.asdict(cfg), t, k)
    assert np.array_equal(want, fired)
