"""Float products whose result for one row does not depend on the others.

A BLAS or an FFT library picks its algorithm, and with it the order of a
row's sums, by the shape of the whole call.  A stream featurises and
embeds a few frames per hop where offline processing takes all of them
at once, so a frame's result could depend on how many frames shared its
call.  Two realisations make them independent:

* :func:`rowwise_matmul` on the CPU: one ``[1, K] @ [K, N]`` product per
  row (a batched matmul over the rows), so every row meets the same call
  whatever shares its batch;
* :func:`by_row_blocks` on the card: calls of one fixed shape, the rows
  cut into blocks of ``CARD_ROWS`` and the last block padded with zero
  rows, so every row goes through the same kernel with the same reduction
  schedule wherever it sits.  The MFCC frontend runs its ``rfft`` and its
  mel and DCT products so (``stream.features``), and streaming frames
  equal offline frames to the bit on either device
  (``tests/test_torch_stream.py``; ``chip_smoke.py`` on the card).

On the card :func:`rowwise_matmul` alone is the ordinary product: a float
patch embedding there (a plan that does not integer-execute) promises no
bit equality between streamed and offline rows, and a QAT step does not
pay for blocks it does not need.  The ``cuda`` plans embed through the
integer matmul, which is exact.
"""

from __future__ import annotations

from typing import Callable

import torch

CARD_ROWS = 64      # rows per call on the card: one hop of 64 lanes


def by_row_blocks(x: torch.Tensor, fn: Callable, rows: int = CARD_ROWS
                  ) -> torch.Tensor:
    """``fn`` applied to ``x`` [M, K] in calls of exactly ``rows`` rows
    (zero rows pad the last one; their results are dropped)."""
    m = x.shape[0]
    pad = -m % rows
    if pad:
        x = torch.cat([x, x.new_zeros((pad,) + tuple(x.shape[1:]))])
    if x.shape[0] == rows:
        out = fn(x)
    else:
        out = torch.cat([fn(b) for b in x.split(rows)])
    return out[:m] if pad else out


def rowwise_matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` for x [..., K] and w [K, N]; on the CPU as one
    [1, K] @ [K, N] product per row (module docstring), on the card the
    ordinary product."""
    if x.device.type != "cpu":
        return torch.matmul(x, w)
    lead, k = x.shape[:-1], x.shape[-1]
    rows = x.reshape(-1, 1, k)
    out = torch.bmm(rows, w.expand(rows.shape[0], *w.shape))
    return out.reshape(*lead, w.shape[-1])
