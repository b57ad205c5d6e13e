"""Which answers of a run the reference checks."""

from __future__ import annotations

import numpy as np


def pick_calls(n_calls: int, n: int, seed: int) -> list:
    """Up to ``n`` of a run's ``n_calls`` timed calls (the window's and the
    traced window's), drawn from the seed: the last call, and the rest
    uniformly from all the others."""
    if n_calls <= 0:
        return []
    rng = np.random.default_rng([int(seed), 7])
    last = n_calls - 1
    rest = rng.choice(last, size=min(n - 1, last), replace=False)
    return sorted({last, *(int(j) for j in rest)})


def gap_checks(ctx, name: str, gaps) -> list:
    """The widest of the answers' gaps (``<name>``) and their mean
    (``<name>_mean``), each beside the workload file's limit."""
    return [{"name": key, "value": value, "limit": ctx.limit(key)}
            for key, value in ((name, float(gaps.max())),
                               (f"{name}_mean",
                                float(gaps.double().mean())))]
