"""Scale-factor calibration (paper §IV, Table V).

The paper chooses 2^y by sweeping candidate exponents for weights and inputs
and measuring end-task accuracy on the GSC dataset.  This module reproduces
that loop generically: given a model apply-fn, a parameter tree, and a
calibration batch iterator, sweep (weight_exp, input_exp) pairs and report
accuracy per pair — the Table V generator.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Iterable

import torch

from repro_torch.core import quant


@dataclasses.dataclass
class SweepResult:
    weight_exponent: int
    input_exponent: int
    accuracy: float
    quantized_bytes: int


def quantize_inputs(x: torch.Tensor, input_exponent: int) -> torch.Tensor:
    """Quantise-dequantise the input at 2^y (static input quantisation)."""
    q = quant.quantize_po2(x, input_exponent, bits=8)
    return q.dequantize()


def sweep_scale_factors(
    apply_fn: Callable[..., torch.Tensor],
    params,
    batches: Iterable[tuple[torch.Tensor, torch.Tensor]],
    weight_exponents: tuple[int, ...] = (3, 4, 5, 6),
    input_exponents: tuple[int, ...] = (3, 4, 5, 6),
    pairs: list[tuple[int, int]] | None = None,
    rounding: str = "nearest",
    bits: int = 8,
) -> list[SweepResult]:
    """Reproduce Table V: accuracy per (weight 2^y, input 2^y) pair.

    ``apply_fn(params, x) -> logits``, run under ``torch.no_grad``.
    Batches are (x, labels) tensors on the params' device.  The paper
    sweeps (8,8), (16,16), (32,32), (64,32), (64,64); pass those via
    ``pairs`` as exponents [(3,3),(4,4),(5,5),(6,5),(6,6)].
    ``rounding="floor"`` sweeps with the bit-exact eq-9 cast; ``bits``
    selects the stored width (``SweepResult.quantized_bytes`` then reports
    the TRUE packed bytes — nibble-packed at 4 bits).
    """
    if pairs is None:
        pairs = [(w, i) for w in weight_exponents for i in input_exponents]
    batches = list(batches)
    results = []
    for wexp, iexp in pairs:
        qparams = quant.quantize_tree(params, weight_exponent=wexp,
                                      rounding=rounding, bits=bits)
        fparams = quant.dequantize_tree(qparams)
        qbytes, _ = quant.tree_quantized_bytes(qparams)
        correct = total = 0
        with torch.no_grad():
            for x, y in batches:
                logits = apply_fn(fparams, quantize_inputs(x, iexp))
                pred = torch.argmax(logits, dim=-1)
                correct += int((pred == y).sum())
                total += int(y.numel())
        results.append(SweepResult(wexp, iexp, correct / max(total, 1), qbytes))
    return results


def best_pair(results: list[SweepResult]) -> SweepResult:
    return max(results, key=lambda r: r.accuracy)
