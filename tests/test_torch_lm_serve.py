"""LM serving in the port: the per-lane decode state, continuous batching
(``cell.scheduler.LMScheduler``, the ports of the reference's
``tests/test_cell.py`` scheduler tests), the scheduler against the
reference's on the same weights and requests, the ``launch.serve`` CLI
and the engine's LM spans — on the CPU, the ``cuda`` plan through its
kernels' plain versions.

Bit-identity is the contract throughout: a per-lane index at uniform
depth reproduces the int index, the schedule is invisible to the tokens
of a request, a mid-flight join leaves a resident lane's tokens as they
were, and on the ``lut`` plan (bit-equal logits, tests/test_torch_lm_model)
the port's scheduler emits the reference scheduler's tokens.
"""

import json
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import cell as jcell
from repro import runtime as jrt
from repro.configs import registry as jregistry
from repro.models import transformer as JT
from repro_torch import cell as cellmod
from repro_torch import convert
from repro_torch import runtime as trt
from repro_torch import telemetry
from repro_torch.configs import registry as tregistry
from repro_torch.launch import serve
from repro_torch.models import transformer as TT

torch.set_num_threads(1)


def _setup(name, seed=0):
    """The same random weights in both packages (every leaf random, as in
    tests/test_torch_lm_model.py)."""
    jcfg, tcfg = jregistry.get(name).smoke, tregistry.get(name).smoke
    shapes = jax.eval_shape(lambda k: JT.init_params(jcfg, k),
                            jax.random.PRNGKey(0))
    rng = np.random.default_rng(seed)

    def leaf(path, s):
        names = [getattr(k, "key", "") for k in path]
        per = s.shape[1:] if names[0] == "blocks" else s.shape
        if "scale" in names:
            return rng.normal(1.0, 0.1, s.shape).astype(np.float32)
        scale = 1.0 / np.sqrt(per[0]) if len(per) > 1 else 0.1
        return rng.normal(0, scale, s.shape).astype(np.float32)

    npp = jax.tree_util.tree_map_with_path(leaf, shapes)
    return jcfg, tcfg, jax.tree.map(jnp.asarray, npp), \
        convert.from_numpy_tree(npp, "cpu")


@pytest.fixture(scope="module")
def setup():
    return _setup("internlm2-1.8b")


@pytest.fixture(scope="module")
def lm_engine(setup):
    _, tcfg, _, tp = setup
    return trt.compile_model(tcfg, tp, backend="float", device="cpu")


@pytest.fixture(scope="module")
def cuda_engine(setup):
    _, tcfg, _, tp = setup
    return trt.compile_model(tcfg, tp, backend="cuda", device="cpu",
                             plain_kernels=True)


def _metrics():
    return telemetry.make_cell_metrics(telemetry.Registry())


def _clone(state):
    return {"layers": {k: v.clone() for k, v in state["layers"].items()},
            "index": state["index"]}


# ---------------------------------------------------------------------------
# per-lane decode state (models.transformer)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("plan", ["float", "cuda"])
def test_vector_index_decode_matches_scalar(plan, lm_engine, cuda_engine):
    """A per-lane [B] index at uniform depth reproduces the int-index
    decode — the mechanism under continuous batching."""
    eng = lm_engine if plan == "float" else cuda_engine
    B = 2
    toks = np.random.default_rng(1).integers(0, eng.cfg.vocab_size, (B, 6))
    logits, s = eng.prefill(toks.astype(np.int32), eng.init_decode_state(B, 12))
    s_vec = _clone(s)
    s_vec["index"] = torch.full((B,), s["index"], dtype=torch.long)
    cur = cur_v = logits.argmax(-1)
    for _ in range(4):
        la, s = eng.decode_step(cur, s)
        lb, s_vec = eng.decode_step(cur_v, s_vec)
        assert torch.equal(la, lb)
        cur, cur_v = la.argmax(-1), lb.argmax(-1)
    assert s_vec["index"].tolist() == [s["index"]] * B
    assert torch.equal(s["layers"]["k"], s_vec["layers"]["k"])


def test_merge_decode_state_selects_per_lane(lm_engine):
    eng = lm_engine
    old = eng.init_decode_state(2, 8)
    new = eng.init_decode_state(2, 8)
    old["index"] = torch.tensor([3, 5])
    new["index"] = torch.tensor([0, 0])
    new["layers"] = {k: v + 1 for k, v in new["layers"].items()}
    merged = TT.merge_decode_state(old, new, torch.tensor([False, True]))
    assert merged["index"].tolist() == [3, 0]
    k = merged["layers"]["k"]                    # [n_layers, B, ...]
    assert float(k[:, 0].abs().sum()) == 0.0
    assert float(k[:, 1].abs().sum()) > 0.0


def test_merge_takes_an_int_index_on_either_side(lm_engine):
    old, new = lm_engine.init_decode_state(3, 4), \
        lm_engine.init_decode_state(3, 4)
    old["index"], new["index"] = 2, 1
    merged = TT.merge_decode_state(old, new, np.array([True, False, True]))
    assert merged["index"].tolist() == [1, 2, 1]


# ---------------------------------------------------------------------------
# LMScheduler: continuous batching
# ---------------------------------------------------------------------------

def _requests(cfg, n=5, seed=0):
    rng = np.random.RandomState(seed)
    return [(i, rng.randint(0, cfg.vocab_size, size=rng.randint(2, 12)),
             int(rng.randint(3, 10))) for i in range(n)]


@pytest.mark.parametrize("plan", ["float", "cuda"])
def test_scheduler_order_invariant(plan, lm_engine, cuda_engine):
    """With a fixed prefill pad width the schedule is invisible: any
    submission order gives the same tokens per request."""
    eng = lm_engine if plan == "float" else cuda_engine
    reqs = _requests(eng.cfg)

    def run(order):
        s = cellmod.LMScheduler(eng, slots=2, max_len=64, prefill_len=16)
        for j in order:
            rid, p, g = reqs[j]
            s.submit(rid, p, g)
        return s.run()

    a, b = run([0, 1, 2, 3, 4]), run([4, 3, 2, 1, 0])
    assert set(a) == set(b) == {0, 1, 2, 3, 4}
    for rid in a:
        assert a[rid] == b[rid]
        assert len(a[rid]) == reqs[rid][2]


def test_scheduler_preserves_residents_on_join(lm_engine):
    """A mid-flight join must not perturb a resident lane's decode: the
    same tokens as an undisturbed run."""
    reqs = _requests(lm_engine.cfg)
    solo = cellmod.LMScheduler(lm_engine, slots=2, max_len=64,
                               prefill_len=16)
    solo.submit(0, reqs[0][1], reqs[0][2])
    want = solo.run()[0]

    s = cellmod.LMScheduler(lm_engine, slots=2, max_len=64, prefill_len=16)
    s.submit(0, reqs[0][1], reqs[0][2])
    out, n = {}, 0
    while not s.idle():
        if n == 2:                       # joiner lands mid-decode
            s.submit(1, reqs[1][1], reqs[1][2])
        for ev in s.step():
            out.setdefault(ev.rid, []).append(ev.token)
        n += 1
    assert out[0] == want
    assert len(out[1]) == reqs[1][2]


def test_scheduler_eos_evicts_early(lm_engine):
    s = cellmod.LMScheduler(lm_engine, slots=2, max_len=64, prefill_len=16)
    s.submit(0, [1, 2, 3], 40)
    evs = []
    while not s.idle():
        evs += s.step()
    # rerun with the first emitted token as EOS: must stop at one token
    eos = evs[0].token
    s2 = cellmod.LMScheduler(lm_engine, slots=2, max_len=64, prefill_len=16,
                             eos_id=eos)
    s2.submit(0, [1, 2, 3], 40)
    out = []
    while not s2.idle():
        out += s2.step()
    assert len(out) == 1 and out[0].done and out[0].reason == "eos"


def test_scheduler_metrics_ledger(lm_engine):
    met = _metrics()
    s = cellmod.LMScheduler(lm_engine, slots=2, max_len=64, prefill_len=16,
                            metrics=met)
    reqs = _requests(lm_engine.cfg, n=3)
    for rid, p, g in reqs:
        s.submit(rid, p, g)
    out = s.run()
    assert met.joins.value == 3 and met.evictions.value == 3
    assert met.tokens.value == sum(len(v) for v in out.values())
    assert met.prefill_tokens.value == sum(len(p) for _, p, _ in reqs)
    assert met.decode_ms.summary()["n"] > 0
    assert met.prefill_ms.summary()["n"] > 0
    assert met.occupancy.value == 0.0


def test_scheduler_rejects_recurrent_families():
    """rwkv/hybrid fold pad tokens irreversibly into recurrence state."""
    fake = types.SimpleNamespace(
        exec_cfg=types.SimpleNamespace(family="rwkv"))
    with pytest.raises(NotImplementedError, match="dense/moe"):
        cellmod.LMScheduler(fake, slots=2, max_len=8)


def test_scheduler_rejects_oversized_request(lm_engine):
    s = cellmod.LMScheduler(lm_engine, slots=2, max_len=16)
    with pytest.raises(ValueError, match="max_len=16"):
        s.submit(0, list(range(10)), 8)          # 9 + 8 > 16
    with pytest.raises(ValueError):
        s.submit(1, [], 2)


def test_scheduler_rejects_a_short_prefill_width(lm_engine):
    s = cellmod.LMScheduler(lm_engine, slots=2, max_len=32, prefill_len=4)
    s.submit(0, list(range(9)), 2)
    with pytest.raises(ValueError, match="prefill_len=4"):
        s.step()


def test_free_lanes_stay_in_bounds_past_max_len(lm_engine):
    """A lane left free while another decodes for more than ``max_len``
    steps stays parked inside its cache (the reference leans on JAX's
    scatter dropping writes past the end)."""
    s = cellmod.LMScheduler(lm_engine, slots=3, max_len=12, prefill_len=4)
    for rid in range(6):                          # one lane busy at a time
        s.submit(rid, [1, 2], 10)
        out = s.run()
        assert len(out[rid]) == 10
    assert s.state["index"].max() < 12


@pytest.mark.parametrize("plan", ["lut", "cuda"])
def test_scheduler_emits_the_reference_schedulers_tokens(plan, setup):
    """Same weights, same requests, same slots and pad width: the port's
    scheduler and the reference's emit the same tokens per request (the
    plans' logits are bit-equal, tests/test_torch_lm_model.py)."""
    jcfg, tcfg, jp, tp = setup
    jeng = jrt.compile_model(jcfg, jp, backend={"cuda": "pallas"}.get(plan,
                                                                      plan))
    teng = trt.compile_model(tcfg, tp, backend=plan, device="cpu",
                             plain_kernels=plan == "cuda")
    reqs = _requests(tcfg, n=4, seed=3)
    js = jcell.LMScheduler(jeng, slots=2, max_len=32, prefill_len=16)
    ts = cellmod.LMScheduler(teng, slots=2, max_len=32, prefill_len=16)
    for rid, p, g in reqs:
        js.submit(rid, p, g)
        ts.submit(rid, p, g)
    assert ts.run() == js.run()


def test_hot_swap_between_steps_keeps_lanes(setup):
    """The scheduler reads the live engine each step: a swap to the same
    weights leaves the tokens as they were."""
    _, tcfg, _, tp = setup
    a = trt.compile_model(tcfg, tp, backend="float", device="cpu")
    b = trt.compile_model(tcfg, tp, backend="float", device="cpu")
    reqs = _requests(tcfg, n=2)
    want = cellmod.LMScheduler(a, slots=2, max_len=32, prefill_len=16)
    for rid, p, g in reqs:
        want.submit(rid, p, g)
    want = want.run()
    handle = trt.EngineHandle(a)
    s = cellmod.LMScheduler(handle, slots=2, max_len=32, prefill_len=16)
    for rid, p, g in reqs:
        s.submit(rid, p, g)
    out = {}
    for n in range(100):
        if s.idle():
            break
        if n == 3:
            handle.swap(b)
        for ev in s.step():
            out.setdefault(ev.rid, []).append(ev.token)
    assert handle.generation == 1 and out == want


# ---------------------------------------------------------------------------
# the cell and the launcher
# ---------------------------------------------------------------------------

def test_cell_lm_scheduler_feeds_the_cell_metrics(lm_engine):
    reg = telemetry.Registry()
    cell = cellmod.ServeCell(lm_engine, slots=2, registry=reg)
    with cell:
        sched = cell.lm_scheduler(max_len=32, prefill_len=8)
        assert isinstance(sched, cellmod.LMScheduler)
        for rid, p, g in _requests(lm_engine.cfg, n=3):
            sched.submit(rid, p, g)
        out = sched.run()
    tokens = sum(len(v) for v in out.values())
    assert reg.counter("cell_tokens_total", "").value == tokens
    assert reg.histogram("cell_decode_latency_ms", "").summary()["n"] > 0


def test_serve_cli_on_the_cpu_with_the_cuda_backend(capsys):
    out = serve.main(["--arch", "internlm2-1.8b", "--smoke", "--device",
                      "cpu", "--backend", "cuda", "--requests", "4",
                      "--max-len", "32"])
    reqs = serve.make_requests(tregistry.get("internlm2-1.8b").smoke, 4, 32,
                               0)
    assert sorted(out) == [0, 1, 2, 3]
    assert all(len(out[r["id"]]) == r["gen"] for r in reqs)
    log = capsys.readouterr().out
    assert "event=serve_done" in log and "tok_s=" in log
    assert "kernels=cuda (their plain versions on the cpu)" in log


def test_serve_cli_requests_equal_the_reference_mix():
    cfg = jregistry.get("internlm2-1.8b").smoke
    rng = np.random.RandomState(5)
    want = [{"id": i, "prompt": rng.randint(0, cfg.vocab_size,
                                            size=rng.randint(4, 64 // 4)),
             "gen": int(rng.randint(4, 64 // 2))} for i in range(6)]
    got = serve.make_requests(cfg, 6, 64, 5)
    assert [(g["id"], g["gen"]) for g in got] == \
        [(w["id"], w["gen"]) for w in want]
    assert all(np.array_equal(g["prompt"], w["prompt"])
               for g, w in zip(got, want))


def test_serve_cli_needs_the_card_without_device():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="CUDA"):
        serve.main(["--arch", "internlm2-1.8b", "--smoke", "--requests", "1",
                    "--max-len", "16"])


def test_serve_cli_writes_a_valid_trace(tmp_path):
    out_path = str(tmp_path / "trace.json")
    serve.main(["--arch", "internlm2-1.8b", "--smoke", "--device", "cpu",
                "--backend", "lut", "--requests", "3", "--max-len", "32",
                "--telemetry-out", out_path])
    from repro_torch.telemetry import check
    report = check.check_artifacts(out_path, require_metrics=True)
    with open(out_path) as fh:
        names = {e["name"] for e in json.load(fh)["traceEvents"]
                 if e.get("ph") == "X"}
    assert {"prefill", "decode_step", "encode"} <= names
    assert report["events"] > 0


def test_lm_spans_are_the_reference_spans(lm_engine):
    tr = telemetry.enable()
    try:
        st = lm_engine.init_decode_state(1, 8)
        _, st = lm_engine.prefill(np.array([[1, 2, 3]], np.int32), st)
        lm_engine.decode_step(np.array([4], np.int32), st)
    finally:
        telemetry.disable()
    names = [e["name"] for e in tr.events if e.get("ph") == "X"]
    assert names.count("prefill") == 1 and names.count("decode_step") == 1
    assert names.count("encode") == 2
