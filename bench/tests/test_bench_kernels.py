"""The work functions against hand counts and against the bound times
that PERF.md's kernel table prints at its rows (PR 30's restated bounds:
bytes in and out over 3.35 TB/s, operations over their peak)."""

import pytest

from bench.core import peaks
from bench.core.spec import Spec
from bench.tests.conftest import ROOT

SPEC = Spec(ROOT)


def bound_ms(item):
    ops, nbytes, peak = item
    return 1e3 * max(nbytes / peaks.HBM_BYTES_PER_S, ops / peak)


@pytest.mark.parametrize("family,args,want_ms", [
    ("lut_softmax", ("rows", 405504, 99), 0.09587),
    ("lut_softmax", ("rows", 6336, 99), 0.00150),
    ("lut_gelu", ("elements", 405504 * 256), 0.24790),
    ("lut_gelu", ("elements", 6336 * 256), 0.00387),
    ("int8_matmul", ("product", 405504, 64, 256, 4, False), 0.15494),
    ("int8_matmul", ("product", 6336, 64, 256, 4, False), 0.00243),
    ("lut_attention", ("attention", 2, 16, 8, 1024, 1024, 128, True),
     0.05214),
    ("lut_attention", ("attention", 4, 20, 20, 1500, 1500, 64, False),
     0.27944),
])
def test_bound_against_the_kernel_table(family, args, want_ms):
    fam = SPEC.kernel_family(family)
    got = bound_ms(getattr(fam, args[0])(*args[1:]))
    assert got == pytest.approx(want_ms, rel=5e-4, abs=6e-6)


def test_hand_counts():
    mm = SPEC.kernel_family("int8_matmul")
    ops, nbytes, peak = mm.product(2, 3, 5, 4, True)
    assert ops == 60 and nbytes == 4 * 6 + 15 + 5 + 4 * 10
    assert peak == peaks.INT8_OPS
    att = SPEC.kernel_family("lut_attention")
    ops, nbytes, _ = att.attention(1, 2, 1, 3, 3, 4, True)
    assert ops == 2 * 2 * 2 * (1 + 2 + 3) * 4
    assert nbytes == 4 * 4 * (2 * 2 * 3 + 2 * 1 * 3)
    ops, _, _ = att.attention(1, 1, 1, 2, 4, 1, True)   # right-aligned
    assert ops == 2 * 2 * (3 + 4)


def test_cell_work_is_the_model_s():
    kwt_cfg, lm_cfg = SPEC.config("kwt-1"), SPEC.config("internlm2-1.8b")
    kwt = SPEC.model_family("kwt").kernel_work(kwt_cfg, {"batch": 4096})
    lm = SPEC.model_family("dense").kernel_work(
        lm_cfg, {"batch": 1, "seq_len": 8192})
    mm = SPEC.kernel_family("int8_matmul")
    items = mm.work(kwt["int8_matmul"])
    assert len(items) == 1 + 6 * 12 + 1
    assert items[5][0] == 2 * 405504 * 64 * 256       # w1 of layer 0
    (head,) = mm.work(lm["int8_matmul"])
    assert head[0] == 2 * 8192 * 2048 * 92544
    assert head[1] == 2 * 8192 * 2048 + 2048 * 92544 + 92544 \
        + 4 * 8192 * 92544
    sm = SPEC.kernel_family("lut_softmax").work(kwt["lut_softmax"])
    assert len(sm) == 12 and bound_ms(sm[0]) == pytest.approx(0.09587,
                                                              rel=5e-4)
    ge = SPEC.kernel_family("lut_gelu").work(kwt["lut_gelu"])
    assert len(ge) == 12 and bound_ms(ge[0]) == pytest.approx(0.24790,
                                                              rel=5e-4)
    assert "lut_softmax" not in lm and "lut_attention" not in kwt
    att = SPEC.kernel_family("lut_attention").work(lm["lut_attention"])
    assert len(att) == 24
    assert att[0][0] == 2 * 2 * 16 * (8192 * 8193 // 2) * 128
    # a stream step embeds only its new frames
    step = SPEC.model_family("kwt").kernel_work(
        kwt_cfg, {"batch": 2048, "new_frames": 4})["int8_matmul"][0]
    assert step[:3] == (2048 * 4, 40, 64)


def test_model_flops():
    for name in SPEC.configs:
        assert SPEC.config(name)["mfu_peak_flops"] == peaks.BF16_FLOPS
    kwt_f = SPEC.model_family("kwt").flops
    kwt = SPEC.config("kwt-1")["model"]
    per_layer = 99 * (2 * 64 * 64 * 4 + 2 * 2 * 64 * 256) \
        + 2 * 2 * 99 * 99 * 64
    want = 12 * per_layer + 2 * 98 * 40 * 64 + 2 * 64 * 35
    assert kwt_f(kwt, {"batch": 1}) == want
    assert abs(want / 1e6 - 147.4) < 0.5
    assert kwt_f(kwt, {"batch": 3, "new_frames": 4}) \
        == 3 * (want - 2 * 94 * 40 * 64)
    lm_f = SPEC.model_family("dense").flops
    lm = SPEC.config("internlm2-1.8b")["model"]
    per_tok = 2 * 2048 * (2048 + 2 * 1024) + 2 * 2048 * 2048 \
        + 6 * 2048 * 8192
    want = 24 * (8192 * per_tok + 4 * 16 * 128 * 8192 * 8193 // 2) \
        + 8192 * 2 * 2048 * 92544
    assert lm_f(lm, {"batch": 1, "seq_len": 8192}) == want
    assert lm_f(lm, {"batch": 8, "seq_len": 1024}) \
        == 8 * lm_f(lm, {"batch": 1, "seq_len": 1024})
