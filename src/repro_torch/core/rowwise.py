"""A float product whose result for one row does not depend on the others."""

from __future__ import annotations

import torch


def rowwise_matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` for x [..., K] and w [K, N]; on the CPU as one
    [1, K] @ [K, N] product per row (a batched matmul over the rows).

    A BLAS picks its algorithm, and with it the order of the K-sum, by the
    shape of the whole product: on the CPU a product of one or two rows
    sums in another order than the same row inside a larger one.  A
    stream featurises and embeds a few frames per hop where offline
    processing takes all of them at once; with one product per row every
    row meets the same call whatever shares its batch, so the two agree
    to the bit (``tests/test_torch_stream.py``).  On the card the product
    is the ordinary one: cuFFT ahead of it in the frontend may vary with
    the batch shape anyway, so the card promises no such equality for
    float rows (``chip_smoke.py`` measures the frames' distance instead).
    """
    if x.device.type != "cpu":
        return torch.matmul(x, w)
    lead, k = x.shape[:-1], x.shape[-1]
    rows = x.reshape(-1, 1, k)
    out = torch.bmm(rows, w.expand(rows.shape[0], *w.shape))
    return out.reshape(*lead, w.shape[-1])
