"""The LUT softmax family (``kernels/lut_softmax.py``,
``csrc/lut_softmax.cu``): the Q8.24 row softmax of every attention row
that the plain attention path (``attention="xla"``) takes.  Bound by its
bytes: each float32 score read once, each probability written once."""

KERNELS = r"\bsoftmax_(fixed|float|slab)_kernel\b"


def rows(r: int, n: int):
    """(ops, bytes, peak) of ``r`` rows of ``n`` lanes."""
    return 0, 2 * 4 * r * n, 1.0


def work(items: list) -> list:
    """(ops, bytes, peak) of each ``(rows, lanes)`` that a model family's
    ``kernel_work`` lists."""
    return [rows(*it) for it in items]
