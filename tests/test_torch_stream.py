"""repro_torch.stream against itself and against repro.stream, on the CPU.

Within the port the reference's own contracts hold exactly: streaming
frames equal offline frames and do not depend on the chunking; streaming
logits equal the offline forward on the same window, in every plan
(``float``, ``lut_float``, ``lut`` and ``lut`` + ``flash_lut``), at
chunks of 1, 3 and 26 hops.  (The reference misses this by one float32
ulp on XLA:CPU in two of its own tests; the port's float products are one
product per frame, ``core.rowwise``, so no reduction depends on the
chunk.)  Ring and detector state and events equal the reference's on
shared inputs.

Against the reference, stated tolerances with the errors measured behind
them (this file's inputs):

* filterbank and DCT matrices: equal (the same numpy code).
* MFCC frames: ``FRAME_ATOL`` 2e-5 — ``torch.fft.rfft`` (pocketfft) and
  XLA's FFT round differently.  Measured worst 7.6e-6 on frames whose
  values reach 42.
* streaming logits, port against reference: the forward tolerances of
  ``tests/test_torch_runtime.py`` (``float`` 1e-4, KWT-Tiny LUT plans
  2^-5, KWT-1 at 2 layers 0.25 with at most 2 of 8 lanes further than
  1e-4).  Measured: ``float`` 3.6e-7 / 1.1e-6, ``lut`` 0.0 on both
  models, ``lut`` + ``flash_lut`` 0.0 (KWT-Tiny) and 0.046 on one lane
  of 8 (KWT-1: an activation LSB flipped by the frames' FFT rounding).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import runtime as jrt
from repro.configs import registry as jregistry
from repro.models import kwt as jkwt
from repro.stream import detector as jdet
from repro.stream import engine as jse
from repro.stream import features as jF
from repro.stream import ring as jring
from repro_torch import convert
from repro_torch import runtime as trt
from repro_torch.configs import registry as tregistry
from repro_torch.stream import detector as tdet
from repro_torch.stream import engine as tse
from repro_torch.stream import features as tF
from repro_torch.stream import ring as tring

torch.set_num_threads(1)

FRAME_ATOL = 2e-5
FLOAT_ATOL = 1e-4
TINY_LUT_ATOL = 2.0 ** -5
KWT1_LUT_ATOL = 0.25
KWT1_MAX_MOVED_LANES = 2
HOP = tF.FrontendConfig().hop_len
PLANS = {"float": ("float", None), "lut_float": ("lut_float", None),
         "lut": ("lut", None), "lut_flash": ("lut", "flash_lut")}


def _audio(batch, hops, seed=1, scale=0.1):
    rng = np.random.default_rng(seed)
    return (scale * rng.normal(size=(batch, hops * HOP))).astype(np.float32)


def _np_params(jcfg, seed=0):
    shapes = jax.eval_shape(lambda key: jkwt.init_params(jcfg, key),
                            jax.random.PRNGKey(0))
    rng = np.random.default_rng(seed)

    def leaf(s):
        scale = 1.0 / np.sqrt(s.shape[0]) if len(s.shape) > 1 else 0.1
        return rng.normal(0, scale, s.shape).astype(np.float32)

    tree = jax.tree.map(leaf, shapes)
    for bp in tree["blocks"]:
        for ln in ("ln1", "ln2"):
            bp[ln]["scale"] = (1.0 + bp[ln]["scale"]).astype(np.float32)
    return tree


_CACHE = {}


def _setup(name):
    """(jcfg, tcfg, reference params, numpy params, port params)."""
    if name not in _CACHE:
        je, te = jregistry.get(name), tregistry.get(name)
        jcfg, tcfg = (je.config, te.config) if name == "kwt-tiny" else \
            (je.smoke, te.smoke)
        npp = _np_params(jcfg)
        _CACHE[name] = (jcfg, tcfg, jax.tree.map(jnp.asarray, npp),
                        convert.from_numpy_tree(npp, "cpu"))
    return _CACHE[name]


def _engine(name, plan):
    _, tcfg, _, tp = _setup(name)
    backend, attn = PLANS[plan]
    return trt.compile_model(tcfg, tp, backend=backend, attention=attn,
                             device="cpu")


def _fcfg(cfg):
    return tF.FrontendConfig(n_mfcc=cfg.input_dim[0])


def _run(eng, fcfg, audio, chunk_hops, state=None):
    state = state if state is not None else tse.init_stream_state(
        eng.exec_cfg, fcfg, audio.shape[0], device="cpu")
    k = chunk_hops * HOP
    logits = None
    for i in range(0, audio.shape[1], k):
        state, logits = eng.stream_step(state, audio[:, i:i + k], fcfg)
    return state, logits


# ---------------------------------------------------------------------------
# frontend
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n_mfcc", [16, 40])
def test_filterbank_and_dct_equal_reference(n_mfcc):
    jc, tc = jF.FrontendConfig(n_mfcc=n_mfcc), tF.FrontendConfig(n_mfcc=n_mfcc)
    assert np.array_equal(tF.mel_filterbank(tc), jF.mel_filterbank(jc))
    assert np.array_equal(tF.dct_matrix(tc.n_mels, n_mfcc),
                          jF.dct_matrix(jc.n_mels, n_mfcc))
    assert dataclasses.asdict(tc) == dataclasses.asdict(jc)
    assert (tc.context_len, tc.receptive_field(26)) == \
        (jc.context_len, jc.receptive_field(26))


@pytest.mark.parametrize("n_mfcc", [16, 40])
@pytest.mark.parametrize("scale", [0.1, 1.0])
def test_frames_close_to_reference(n_mfcc, scale):
    jc, tc = jF.FrontendConfig(n_mfcc=n_mfcc), tF.FrontendConfig(n_mfcc=n_mfcc)
    audio = _audio(4, 40, seed=2, scale=scale)
    want = np.asarray(jax.jit(lambda a: jF.mfcc(a, jc))(jnp.asarray(audio)))
    got = tF.mfcc(torch.from_numpy(audio), tc)
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    assert np.abs(got.numpy() - want).max() <= FRAME_ATOL
    # one utterance, 1-D in
    assert torch.equal(tF.mfcc(torch.from_numpy(audio[0]), tc), got[:1])


@pytest.mark.parametrize("batch", [1, 3])
@pytest.mark.parametrize("chunk_hops", [1, 5])
def test_frontend_streaming_matches_offline_bitwise(batch, chunk_hops):
    fcfg = tF.FrontendConfig()
    hops = 20
    audio = torch.from_numpy(_audio(batch, hops, seed=3))
    off = tF.mfcc(audio, fcfg)
    state = tF.frontend_init(fcfg, batch, device="cpu")
    outs = []
    for i in range(0, hops, chunk_hops):
        state, fr = tF.frontend_push(
            state, audio[:, i * HOP:(i + chunk_hops) * HOP], fcfg)
        outs.append(fr)
    assert torch.equal(torch.cat(outs, 1).transpose(1, 2), off)


def test_frontend_chunking_invariance_bitwise():
    fcfg = tF.FrontendConfig()
    hops = 12
    audio = torch.from_numpy(_audio(1, hops, seed=4))
    frames = {}
    for k in (1, 2, 4, 12):
        state = tF.frontend_init(fcfg, 1, device="cpu")
        out = []
        for i in range(0, hops, k):
            state, fr = tF.frontend_push(state, audio[:, i * HOP:(i + k) * HOP],
                                         fcfg)
            out.append(fr)
        frames[k] = torch.cat(out, 1)
    for k in (2, 4, 12):
        assert torch.equal(frames[k], frames[1])


def test_frontend_rejects_partial_hops():
    fcfg = tF.FrontendConfig()
    state = tF.frontend_init(fcfg, 1, device="cpu")
    with pytest.raises(ValueError, match="hop_len"):
        tF.frontend_push(state, torch.zeros(1, HOP + 1), fcfg)
    with pytest.raises(ValueError, match="whole hops"):
        tF.mfcc(torch.zeros(1, HOP + 1), fcfg)


# ---------------------------------------------------------------------------
# ring buffer: the same states as the reference's on shared inputs
# ---------------------------------------------------------------------------

def _same_ring(t, j):
    assert np.array_equal(t["buf"].numpy(), np.asarray(j["buf"]))
    assert int(t["pos"]) == int(j["pos"])
    assert np.array_equal(t["count"].numpy(), np.asarray(j["count"]))
    assert t["pos"].dtype == t["count"].dtype == torch.int32


def test_ring_wraparound_and_resets_equal_reference():
    rng = np.random.default_rng(0)
    frames = rng.normal(size=(3, 40, 2)).astype(np.float32)
    t, j = tring.ring_init(3, 5, (2,), device="cpu"), jring.ring_init(3, 5, (2,))
    _same_ring(t, j)
    i = 0
    for step, k in enumerate((3, 1, 5, 2, 4, 5, 1, 3)):
        t = tring.ring_push(t, torch.from_numpy(frames[:, i:i + k]))
        j = jring.ring_push(j, jnp.asarray(frames[:, i:i + k]))
        i += k
        if step == 3:
            t, j = tring.ring_reset_lane(t, 1), jring.ring_reset_lane(j, 1)
        _same_ring(t, j)
        assert np.array_equal(tring.ring_window(t).numpy(),
                              np.asarray(jring.ring_window(j)))
        assert np.array_equal(tring.ring_warm(t).numpy(),
                              np.asarray(jring.ring_warm(j)))
    # the last 5 pushed frames, oldest first
    assert torch.equal(tring.ring_window(t)[0],
                       torch.from_numpy(frames[0, i - 5:i]))


def test_ring_push_is_pure_and_warms_per_lane():
    st = tring.ring_init(2, 4, (), device="cpu")
    before = {k: v.clone() for k, v in st.items()}
    for i in range(3):
        st2 = tring.ring_push(st, torch.ones((2, 1)))
        assert all(torch.equal(st[k], before[k]) for k in st)
        st = st2
        assert not bool(tring.ring_warm(st).any())
        before = {k: v.clone() for k, v in st.items()}
    st = tring.ring_push(st, torch.ones((2, 1)))
    assert bool(tring.ring_warm(st).all())
    st = tring.ring_reset_lane(st, torch.tensor([0]))
    assert tring.ring_warm(st).tolist() == [False, True]


def test_ring_push_wider_than_ring_rejected():
    st = tring.ring_init(1, 4, (), device="cpu")
    with pytest.raises(ValueError, match="overruns"):
        tring.ring_push(st, torch.ones((1, 5)))


# ---------------------------------------------------------------------------
# detector: the reference's hysteresis / refractory / warm-gating / reset
# cases, driven through both packages
# ---------------------------------------------------------------------------

DCFG = dict(keyword_class=1, smooth_hops=1, on_threshold=0.75,
            off_threshold=0.5, refractory_hops=4)


def _drive(seq, warm=True, **over):
    """Feed one posterior sequence through both detectors (``warm``: one
    flag, or one per hop); every state and event must be equal; returns
    the port's fire pattern."""
    kw = {**DCFG, **over}
    tc, jc = tdet.DetectorConfig(**kw), jdet.DetectorConfig(**kw)
    ts, js = tdet.detector_init(tc, 1, device="cpu"), jdet.detector_init(jc, 1)
    fires = []
    for i, p in enumerate(seq):
        probs = np.asarray([[1.0 - p, p]], np.float32)
        w = warm[i] if isinstance(warm, list) else warm
        ts, te = tdet.detector_step(ts, torch.from_numpy(probs), tc,
                                    warm=torch.tensor([w]))
        js, je = jdet.detector_step(js, jnp.asarray(probs), jc,
                                    warm=jnp.asarray([w]))
        _same_detector(ts, js)
        for key in ("fired", "score", "hop"):
            assert np.array_equal(te[key].numpy(), np.asarray(je[key])), key
        fires.append(bool(te["fired"][0]))
    return fires


def _same_detector(t, j):
    _same_ring(t["hist"], j["hist"])
    for key in ("active", "cooldown", "warm_hops", "hop"):
        assert np.array_equal(t[key].numpy(), np.asarray(j[key])), key


def test_detector_fires_once_per_excursion():
    assert _drive([0.1, 0.9, 0.9, 0.9, 0.9, 0.1]) == \
        [False, True, False, False, False, False]


def test_detector_no_refire_without_release():
    assert _drive([0.9, 0.6, 0.6, 0.9, 0.9]) == \
        [True, False, False, False, False]


def test_detector_refractory_blocks_fast_refire():
    fires = _drive([0.9, 0.1, 0.9, 0.9, 0.9, 0.9])
    assert fires == [True, False, False, False, True, False]


def test_detector_release_then_refire_after_refractory():
    assert _drive([0.9, 0.1, 0.1, 0.1, 0.1, 0.9, 0.1, 0.9]) == \
        [True, False, False, False, False, True, False, False]


def test_detector_warm_gating_and_warmup_history():
    assert _drive([0.9, 0.9], warm=False) == [False, False]
    # posteriors of still-padded windows age out before a fire
    fires = _drive([0.9] * 8, warm=[False] * 5 + [True] * 3, smooth_hops=3,
                   refractory_hops=2)
    assert fires == [False] * 7 + [True]


def test_detector_smoothing_suppresses_single_hop_spike():
    over = dict(smooth_hops=4, refractory_hops=2)
    assert not any(_drive([0.1, 0.95, 0.1, 0.1, 0.1], **over))
    assert sum(_drive([0.9] * 6, **over)) == 1


def test_detector_reset_lane_rearms_like_reference():
    tc, jc = tdet.DetectorConfig(**DCFG), jdet.DetectorConfig(**DCFG)
    ts, js = tdet.detector_init(tc, 2, device="cpu"), jdet.detector_init(jc, 2)
    hot = np.asarray([[0.1, 0.9]] * 2, np.float32)
    for step in range(3):
        ts, te = tdet.detector_step(ts, torch.from_numpy(hot), tc)
        js, je = jdet.detector_step(js, jnp.asarray(hot), jc)
        if step == 0:
            assert bool(te["fired"].all())
            ts = tdet.detector_reset_lane(ts, 0)
            js = jdet.detector_reset_lane(js, 0)
        elif step == 1:
            assert te["fired"].tolist() == [True, False]
        _same_detector(ts, js)
        assert np.array_equal(te["fired"].numpy(), np.asarray(je["fired"]))
    fcfg = tF.FrontendConfig()
    assert tdet.event_time_s(ts["hop"], fcfg) == \
        jdet.event_time_s(js["hop"], jF.FrontendConfig()) == 0.03


# ---------------------------------------------------------------------------
# engine: streaming logits equal the offline forward, bit for bit
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["kwt-tiny", "kwt-1"])
@pytest.mark.parametrize("plan", list(PLANS))
@pytest.mark.parametrize("chunk_hops", [1, 3, 26])
def test_stream_bit_identical_to_offline(name, plan, chunk_hops):
    eng = _engine(name, plan)
    cfg = eng.exec_cfg
    fcfg, t = _fcfg(cfg), cfg.input_dim[1]
    hops = t + 7 - (t + 7) % chunk_hops           # whole chunks, > window
    audio = _audio(2, hops, seed=5)
    state, logits = _run(eng, fcfg, audio, chunk_hops)
    assert bool(tse.warm(state).all())
    off = tF.mfcc(torch.from_numpy(audio), fcfg)[..., hops - t:]
    assert torch.equal(tse.window_mfcc(state), off)
    assert torch.equal(logits, eng.forward(tse.window_mfcc(state)))
    assert torch.equal(logits, eng.forward(off))


@pytest.mark.parametrize("plan", ["float", "lut_flash"])
def test_keep_features_false_gives_the_same_logits(plan):
    eng = _engine("kwt-tiny", plan)
    cfg = eng.exec_cfg
    fcfg, t = _fcfg(cfg), cfg.input_dim[1]
    hops = t + 4
    audio = _audio(2, hops, seed=11)
    lean = tse.init_stream_state(cfg, fcfg, 2, keep_features=False,
                                 device="cpu")
    assert "feat" not in lean
    lean, got = _run(eng, fcfg, audio, 1, lean)
    _, want = _run(eng, fcfg, audio, 1)
    assert torch.equal(got, want)
    lean = tse.reset_lane(lean, 0)                # the lean reset path
    assert tse.warm(lean).tolist() == [False, True]


@pytest.mark.parametrize("plan", ["float", "lut"])
def test_reset_lane_rewarms_and_matches_fresh_stream(plan):
    eng = _engine("kwt-tiny", plan)
    cfg = eng.exec_cfg
    fcfg, t = _fcfg(cfg), cfg.input_dim[1]
    state, _ = _run(eng, fcfg, _audio(2, t + 3, seed=8), 1)
    state = tse.reset_lane(state, 0)
    assert tse.warm(state).tolist() == [False, True]
    cont = np.concatenate([_audio(1, t, seed=9), _audio(1, t, seed=10)], 0)
    state, logits = _run(eng, fcfg, cont, 1, state)
    assert bool(tse.warm(state).all())
    _, fresh = _run(eng, fcfg, cont[:1], 1)
    assert torch.equal(logits[:1], fresh)
    assert torch.equal(logits[0], eng.forward(tF.mfcc(
        torch.from_numpy(cont), fcfg))[0])


def test_stream_step_frames_equals_stream_step():
    eng = _engine("kwt-tiny", "lut")
    cfg = eng.exec_cfg
    fcfg = _fcfg(cfg)
    audio = torch.from_numpy(_audio(2, 30, seed=12))
    a = b = tse.init_stream_state(cfg, fcfg, 2, device="cpu")
    with torch.inference_mode():
        for i in range(0, 30, 2):
            chunk = audio[:, i * HOP:(i + 2) * HOP]
            _, frames = tF.frontend_push(a["frontend"], chunk, fcfg)
            a, la = tse.stream_step(eng.params, a, chunk, cfg, fcfg)
            b, lb = tse.stream_step_frames(eng.params, b, frames, cfg)
            assert torch.equal(la, lb)
            assert torch.equal(a["embed"]["buf"], b["embed"]["buf"])
    assert torch.equal(b["frontend"]["tail"],
                       torch.zeros_like(b["frontend"]["tail"]))


def test_stream_state_restart_exactness():
    """A copy of the state dict, taken mid-stream (the checkpoint path),
    resumes the stream bit-exactly: the state is all in the tensors."""
    eng = _engine("kwt-tiny", "float")
    cfg = eng.exec_cfg
    fcfg, t = _fcfg(cfg), cfg.input_dim[1]
    audio = _audio(1, 2 * t, seed=7)
    half = t * HOP
    state, _ = _run(eng, fcfg, audio[:, :half], 1)
    restored = {k: {kk: torch.from_numpy(vv.numpy().copy())
                    for kk, vv in v.items()} for k, v in state.items()}
    _, la = _run(eng, fcfg, audio[:, half:], 1, state)
    _, lb = _run(eng, fcfg, audio[:, half:], 1, restored)
    assert torch.equal(la, lb)


@pytest.mark.parametrize("name", ["kwt-tiny", "kwt-1"])
@pytest.mark.parametrize("plan", list(PLANS))
def test_stream_logits_close_to_reference(name, plan):
    jcfg, _, jp, _ = _setup(name)
    backend, attn = PLANS[plan]
    jeng = jrt.compile_model(jcfg, jp, backend=backend, attention=attn)
    eng = _engine(name, plan)
    fcfg, jfcfg = _fcfg(jcfg), jF.FrontendConfig(n_mfcc=jcfg.input_dim[0])
    hops = jcfg.input_dim[1] + 5
    audio = _audio(8, hops, seed=1)
    jstate = jse.init_stream_state(jcfg, jfcfg, 8)
    for i in range(hops):
        jstate, want = jeng.stream_step(
            jstate, jnp.asarray(audio[:, i * HOP:(i + 1) * HOP]), jfcfg)
    state, got = _run(eng, fcfg, audio, 1)
    assert np.array_equal(tse.warm(state).numpy(), np.asarray(jse.warm(jstate)))
    diff = np.abs(got.numpy() - np.asarray(want))
    if plan == "float":
        assert diff.max() <= FLOAT_ATOL, diff.max()
    elif name == "kwt-tiny":
        assert diff.max() <= TINY_LUT_ATOL, diff.max()
    else:
        assert diff.max() <= KWT1_LUT_ATOL, diff.max()
        assert int((diff.max(-1) > 1e-4).sum()) <= KWT1_MAX_MOVED_LANES
    assert np.abs(tse.posteriors(got).numpy()
                  - np.asarray(jse.posteriors(want))).max() <= 2 * diff.max() + 1e-6


def test_stream_state_needs_the_card_unless_told():
    cfg = _setup("kwt-tiny")[1]
    fcfg = _fcfg(cfg)
    if torch.cuda.is_available():
        state = tse.init_stream_state(cfg, fcfg, 2)
        assert state["embed"]["buf"].device.type == "cuda"
    else:
        for make in (lambda: tse.init_stream_state(cfg, fcfg, 2),
                     lambda: tF.frontend_init(fcfg, 2),
                     lambda: tring.ring_init(2, 4, ()),
                     lambda: tdet.detector_init(tdet.DetectorConfig(), 2)):
            with pytest.raises(RuntimeError, match="CUDA"):
                make()
    state = tse.init_stream_state(cfg, fcfg, 2, device="cpu")
    assert state["embed"]["buf"].shape == (2, cfg.input_dim[1], cfg.d_model)
    assert state["feat"]["buf"].shape == (2, *cfg.input_dim[::-1])
    assert tse.window_frames(cfg) == cfg.input_dim[1]
