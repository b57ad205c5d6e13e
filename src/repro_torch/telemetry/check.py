"""Validators for telemetry artifacts + the ``python -m repro_torch.telemetry`` CLI.

Checks a Chrome trace-event JSON file (and, when present, the sibling
``.prom`` / ``.metrics.json`` exports the serve loops write next to it)
against the format contracts:

* Chrome trace-event: top-level object with a ``traceEvents`` list;
  every event has ``name``/``ph``/``ts``/``pid``/``tid``; ``ph: "X"``
  (complete) events additionally carry a non-negative ``dur``.
  (The subset of the trace-event spec that chrome://tracing and
  Perfetto require to load the file.)
* Prometheus text exposition: every non-comment line is
  ``name{labels} value``; every ``# TYPE`` is a known metric type; no
  sample appears before its TYPE line.

Used by tests/test_torch_telemetry.py, ``chip_smoke.py`` and by hand:

    python -m repro_torch.launch.stream_serve --hops 20 --telemetry-out trace.json
    python -m repro_torch.telemetry trace.json
"""

from __future__ import annotations

import json
import os
import re
import sys

_EVENT_REQUIRED = ("name", "ph", "ts", "pid", "tid")
_PROM_TYPES = {"counter", "gauge", "summary", "histogram", "untyped"}
_PROM_SAMPLE = re.compile(
    r"^[a-zA-Z_:][a-zA-Z0-9_:]*(\{[^}]*\})?\s+-?[0-9.eE+\-]+(\s+\d+)?$")
_PROM_META = re.compile(r"^# (HELP|TYPE) [a-zA-Z_:][a-zA-Z0-9_:]*( .*)?$")


class TelemetryFormatError(ValueError):
    pass


def validate_chrome_trace(path_or_obj) -> int:
    """Validate a Chrome trace-event JSON file (or loaded object).

    Returns the number of events; raises :class:`TelemetryFormatError`
    with the first violation otherwise.
    """
    if isinstance(path_or_obj, (str, os.PathLike)):
        with open(path_or_obj) as f:
            obj = json.load(f)
    else:
        obj = path_or_obj
    if not isinstance(obj, dict) or "traceEvents" not in obj:
        raise TelemetryFormatError(
            "trace must be a JSON object with a 'traceEvents' list")
    events = obj["traceEvents"]
    if not isinstance(events, list):
        raise TelemetryFormatError("'traceEvents' must be a list")
    for i, ev in enumerate(events):
        if not isinstance(ev, dict):
            raise TelemetryFormatError(f"event {i} is not an object")
        for key in _EVENT_REQUIRED:
            if key not in ev:
                raise TelemetryFormatError(f"event {i} missing {key!r}")
        if not isinstance(ev["name"], str) or not isinstance(ev["ph"], str):
            raise TelemetryFormatError(f"event {i}: name/ph must be strings")
        if not isinstance(ev["ts"], (int, float)):
            raise TelemetryFormatError(f"event {i}: ts must be a number")
        if ev["ph"] == "X":
            dur = ev.get("dur")
            if not isinstance(dur, (int, float)) or dur < 0:
                raise TelemetryFormatError(
                    f"event {i}: complete (ph=X) event needs dur >= 0")
    return len(events)


def validate_prometheus(text: str) -> int:
    """Validate Prometheus text exposition; returns the sample count."""
    typed: set[str] = set()
    samples = 0
    for ln, line in enumerate(text.splitlines(), 1):
        if not line.strip():
            continue
        if line.startswith("#"):
            if not _PROM_META.match(line):
                raise TelemetryFormatError(f"line {ln}: bad comment {line!r}")
            parts = line.split()
            if parts[1] == "TYPE":
                if parts[3] not in _PROM_TYPES:
                    raise TelemetryFormatError(
                        f"line {ln}: unknown metric type {parts[3]!r}")
                typed.add(parts[2])
            continue
        if not _PROM_SAMPLE.match(line):
            raise TelemetryFormatError(f"line {ln}: bad sample {line!r}")
        name = re.split(r"[{\s]", line, 1)[0]
        base = re.sub(r"_(sum|count|bucket|total)$", "", name)
        if name not in typed and base not in typed \
                and name.rstrip("_total") not in typed:
            raise TelemetryFormatError(
                f"line {ln}: sample {name!r} has no preceding # TYPE")
        samples += 1
    return samples


def check_artifacts(trace_path: str, *, require_metrics: bool = False) -> dict:
    """Validate a trace file and (when present) its sibling metric exports
    (``<base>.prom``, ``<base>.metrics.json``).  Returns a summary dict."""
    n_events = validate_chrome_trace(trace_path)
    out = {"trace": trace_path, "events": n_events}
    base = os.path.splitext(trace_path)[0]
    prom = base + ".prom"
    if os.path.exists(prom):
        with open(prom) as f:
            out["prom_samples"] = validate_prometheus(f.read())
    elif require_metrics:
        raise TelemetryFormatError(f"missing Prometheus export {prom}")
    mjson = base + ".metrics.json"
    if os.path.exists(mjson):
        with open(mjson) as f:
            out["metrics"] = len(json.load(f))
    elif require_metrics:
        raise TelemetryFormatError(f"missing metrics JSON {mjson}")
    return out


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    require = "--require-metrics" in argv
    paths = [a for a in argv if not a.startswith("--")]
    if not paths:
        print("usage: python -m repro_torch.telemetry [--require-metrics] "
              "trace.json [...]", file=sys.stderr)
        return 2
    for path in paths:
        try:
            summary = check_artifacts(path, require_metrics=require)
        except (TelemetryFormatError, OSError, json.JSONDecodeError) as e:
            print(f"FAIL {path}: {e}", file=sys.stderr)
            return 1
        print("OK " + " ".join(f"{k}={v}" for k, v in summary.items()))
    return 0


if __name__ == "__main__":
    sys.exit(main())
