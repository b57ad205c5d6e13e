"""The LUT GELU family (``kernels/lut_gelu.py``, ``csrc/lut_gelu.cu``):
the 32-entry GELU of every MLP.  Bound by its bytes: each float32 input
read once, each output written once."""

KERNELS = r"\bgelu_kernel<"


def elements(n: int, value_bytes: int = 4):
    return 0, 2 * value_bytes * n, 1.0


def work(items: list) -> list:
    """(ops, bytes, peak) of each ``(elements,)`` that a model family's
    ``kernel_work`` lists."""
    return [elements(*it) for it in items]
