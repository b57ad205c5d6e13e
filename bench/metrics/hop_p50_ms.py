"""``hop_p50_ms.<cell group>``: the median of the same ``hop`` calls whose
95th percentile is ``hop_p95_ms`` (the untraced window)."""

import numpy as np


def read(name, run):
    lat = run.cell.latencies_ms[:run.calls]
    return float(np.median(lat)) if lat else None
