"""The int8 matmul family (``kernels/int8_matmul.py``,
``csrc/int8_matmul.cu``): every linear the configuration integer-executes,
as a model family's ``kernel_work`` lists them
(``bench/models/<family>.py``).  An eq-9 cast input of ``x_bytes`` a value, an int8 weight (and one byte of exponent a column
where the recipe is per channel), a float32 output; 2 MKN int8 ops."""

from bench.core import peaks

KERNELS = r"\bint8_matmul_(kernel|kloop)\b"


def product(m: int, k: int, n: int, x_bytes: int, per_channel: bool):
    """(ops, bytes, peak) of one [M, K] x [K, N] product."""
    nbytes = x_bytes * m * k + k * n + (n if per_channel else 0) + 4 * m * n
    return 2 * m * k * n, nbytes, peaks.INT8_OPS


def work(items: list) -> list:
    """(ops, bytes, peak) of each ``(M, K, N, x_bytes, per_channel)`` that
    a model family's ``kernel_work`` lists."""
    return [product(*it) for it in items]
