"""``idle_pct.<cell group>``: the share of the traced window in which no
kernel, copy or set ran on the device (``torch.profiler``)."""


def read(name, run):
    tr = run.trace
    if tr is None or not tr.device:
        return None
    return 100.0 * (1.0 - tr.busy_s() / tr.window_s)
