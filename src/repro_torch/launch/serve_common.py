"""Shared serving telemetry plumbing of the serve launchers.

The observability boilerplate a server needs — a ``--telemetry-out``
flag, a per-run metrics :class:`~repro_torch.telemetry.Registry`, and the
end-of-run artifact writes — lives here once, for ``stream_serve.py`` and
the LM server that comes with the LM families.

``session(out_path)`` yields ``(tracer, registry)``:

* ``out_path=None`` — tracing stays disabled (the zero-cost fast path in
  every instrumented call site) and the registry is export-less scratch.
* ``out_path="trace.json"`` — spans record for the whole run; on exit the
  Chrome trace lands at ``trace.json`` with the Prometheus text + JSON
  metric exports as siblings (``trace.prom`` / ``trace.metrics.json``) —
  the layout ``python -m repro_torch.telemetry`` validates.

The flush is crash-faithful: it runs on EVERY exit path — normal return,
exception, SIGINT (KeyboardInterrupt unwinds through the ``finally``) —
with SIGINT deferred for its duration so a second Ctrl-C cannot kill the
process mid-write, and each artifact saved independently so a failing
trace write still leaves the metric exports (and vice versa).  Aborted
runs are marked: the ``telemetry_saved`` log line carries
``aborted=<ExceptionType>`` so a soak harness reading partial artifacts
knows the run did not complete (tests/test_torch_cell.py).
"""

from __future__ import annotations

import contextlib
import os
import signal
import threading

from repro_torch import telemetry


def add_telemetry_args(ap) -> None:
    ap.add_argument("--telemetry-out", default=None, metavar="TRACE_JSON",
                    help="enable span tracing and write the Chrome trace "
                         "here, with .prom / .metrics.json metric exports "
                         "as siblings")


@contextlib.contextmanager
def _sigint_deferred():
    """Hold SIGINT for the duration of the artifact flush (main thread
    only — elsewhere signals don't deliver to us anyway)."""
    if threading.current_thread() is not threading.main_thread():
        yield
        return
    pending = []
    prev = signal.signal(signal.SIGINT,
                         lambda sig, frame: pending.append(sig))
    try:
        yield
    finally:
        signal.signal(signal.SIGINT, prev)
        if pending and callable(prev):
            prev(signal.SIGINT, None)


def _flush(tracer, registry, out_path: str, aborted: str | None) -> list:
    """Write trace + metric artifacts; each save isolated so one failure
    cannot eat the others.  Returns the save errors (tests inspect)."""
    errors = []
    with _sigint_deferred():
        telemetry.disable()
        try:
            tracer.save(out_path)
        except Exception as e:          # noqa: BLE001 - keep flushing
            errors.append(("trace", e))
        prom = js = None
        try:
            prom, js = registry.save(os.path.splitext(out_path)[0])
        except Exception as e:          # noqa: BLE001
            errors.append(("metrics", e))
        telemetry.log("telemetry_saved", trace=out_path,
                      events=len(tracer.events), prom=str(prom),
                      metrics=str(js), aborted=aborted or "",
                      save_errors=len(errors))
    return errors


@contextlib.contextmanager
def session(out_path: str | None):
    registry = telemetry.Registry()
    tracer = telemetry.enable() if out_path else None
    aborted = None
    try:
        yield tracer, registry
    except BaseException as e:          # mark, flush, re-raise
        aborted = type(e).__name__
        raise
    finally:
        if out_path:
            _flush(tracer, registry, out_path, aborted)
