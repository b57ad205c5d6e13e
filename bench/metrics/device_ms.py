"""``device_ms.<span>.<cell group>``: device milliseconds a call of the
kernels, copies and sets launched while the program's span ``<span>`` was
open on the host (``client``: while none was), in the spans window
(``bench/core/spans.py``).  No device activity, or no such span: no
reading."""

from bench.core import spans


def read(name, run):
    return spans.window(run).device_ms(name.split(".")[1])
