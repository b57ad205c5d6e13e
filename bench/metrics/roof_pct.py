"""``roof_pct.<family>.<cell group>``: the least time the family's work at
the cell's shapes could take, over the device time of the family's
kernels in the traced window.

The least time of one product is the larger of its bytes (each input read
once, each output written once) over the HBM bandwidth and its
operations over the peak of their precision.  The shapes of a call's
work come from the model family (``kernel_work`` of
``bench/models/<family>.py``), which lists what the model needs, not what
a kernel does; their cost from the kernel family's file
(``bench/kernels/<family>.py``).  No launch of the family in the window:
no reading.
"""

from bench.core import peaks


def read(name, run):
    family = name.split(".")[1]
    fam = run.spec.kernel_family(family)
    device_s = run.trace.kernel_seconds(fam.KERNELS) if run.trace else 0.0
    if device_s <= 0.0:
        return None
    model = run.spec.model_family(run.model["family"])
    shapes = model.kernel_work(run.config, run.cell.work()).get(family, [])
    least = sum(max(b / peaks.HBM_BYTES_PER_S, ops / peak)
                for ops, b, peak in fam.work(shapes))
    if least <= 0.0:
        return None
    return 100.0 * least * run.traced_calls / device_s
