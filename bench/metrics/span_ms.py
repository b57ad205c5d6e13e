"""``span_ms.<span>.<cell group>``: host milliseconds a call spent inside
the program's span ``<span>``, summed from the program's own tracer
(``Tracer.durations_us``) over the spans window (``bench/core/spans.py``).
No such span: no reading."""

from bench.core import spans


def read(name, run):
    return spans.window(run).span_ms(name.split(".")[1])
