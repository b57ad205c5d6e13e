"""The flash-LUT attention family (``kernels/lut_attention.py``,
``csrc/lut_attention.cu`` and ``csrc/lut_attention_wide.cu``): the
attention of ``attention="flash_lut"`` plans.  2 B H pairs D operations
for each of QK^T and P.V, pairs those the mask lets through; float32
products at a third of the TF32 rate (the kernels take them as three TF32
products; the LM plans' attention is float32); bytes: Q, K, V read
once, the output written once."""

from bench.core import peaks

KERNELS = r"\battn_(wide_)?kernel<"


def attention(b: int, h: int, kv: int, lq: int, lk: int, d: int,
              causal: bool):
    """(ops, bytes, peak) of one call, queries right-aligned to the keys."""
    if causal:
        off = lk - lq
        pairs = sum(max(0, min(lk, i + off + 1)) for i in range(lq))
    else:
        pairs = lq * lk
    ops = 2 * 2 * b * h * pairs * d
    nbytes = 4 * d * (2 * b * h * lq + 2 * b * kv * lk)
    return ops, nbytes, peaks.F32_3XTF32_FLOPS


def work(items: list) -> list:
    """(ops, bytes, peak) of each ``(B, H, KV, Lq, Lk, D, causal)`` that a
    model family's ``kernel_work`` lists."""
    return [attention(*it) for it in items]
