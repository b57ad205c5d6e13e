"""``mfu_pct.<cell group>``: the model FLOPs the timed window's calls
needed, over the window, as a share of the peak the configuration file
names (``mfu_peak_flops``: the H100's dense bf16 peak, one yardstick that
no change of precision moves).

A call's FLOPs are the model family's (``flops`` of
``bench/models/<family>.py``, of the traffic kind's ``work()``): 2 per
multiply-add of every projection, score and P.V product the
configuration's shapes need, causal pairs only where the model is causal;
the frontend's FFT and the norms are not counted.
"""


def read(name, run):
    family = run.spec.model_family(run.model["family"])
    flops = family.flops(run.model, run.cell.work()) * run.calls
    return 100.0 * flops / run.window_s / run.config["mfu_peak_flops"]
