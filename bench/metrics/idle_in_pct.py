"""``idle_in_pct.<span>.<cell group>``: the share of the spans window in
which no kernel, copy or set ran on the device while the host was inside
the program's span ``<span>`` (``client``: inside no program span, the
harness's own work), from ``bench/core/spans.py``.  Over the spans that
no other span holds, and ``client``, the family sums to the window's idle
share.  No device activity, or no such span: no reading."""

from bench.core import spans


def read(name, run):
    return spans.window(run).idle_in_pct(name.split(".")[1])
