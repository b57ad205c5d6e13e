"""Counters, gauges and ring-reservoir histograms + Prometheus/JSON export.

The serving-side half of ``repro_torch.telemetry`` (the host analogue of
paxml's ``base_metrics``): one :class:`Registry` of named metrics shared
by the serve loops (per-hop latency, lane occupancy, queue depth, refill
rate, per-stream RTF, detector event counts) and the benchmark harnesses
that will report through it.

:func:`latency_summary` is the ONE latency-row schema: both BENCH_*.json
rows and live ``Histogram.summary()`` exports use its field names
(``n`` / ``mean_<unit>`` / ``p50_<unit>`` / ``p95_<unit>`` /
``p99_<unit>``), so a dashboard reading serve metrics and a script
reading bench JSON parse the same keys.

Histograms keep a fixed-capacity ring reservoir (latest N observations)
— bounded memory under millions of hops, with quantiles over the recent
window, which is what a serving cell wants anyway.
"""

from __future__ import annotations

import json
import re
import threading
import time

import numpy as np

_NAME_RE = re.compile(r"[^a-zA-Z0-9_:]")


def _prom_name(name: str) -> str:
    name = _NAME_RE.sub("_", name)
    if name and name[0].isdigit():
        name = "_" + name
    return name


def _fmt_labels(labels: dict | None) -> str:
    if not labels:
        return ""
    inner = ",".join(f'{_prom_name(k)}="{v}"'
                     for k, v in sorted(labels.items()))
    return "{" + inner + "}"


def latency_summary(samples, *, unit: str = "us", count: int | None = None,
                    total: float | None = None) -> dict:
    """The shared latency-row schema (bench JSON rows == serve metrics).

    ``samples`` is any sequence of per-call latencies in ``unit``;
    ``count``/``total`` override n / sum when the samples are a reservoir
    of a longer-running stream.

    Empty input is a real serving state (a cold cell exporting metrics
    before first traffic): the summary reports ``n=0`` with zeroed
    stats rather than raising from numpy quantiles over an empty ring.
    """
    a = np.asarray(list(samples), np.float64)
    if a.size == 0:
        return {"n": int(count or 0), f"mean_{unit}": 0.0,
                f"p50_{unit}": 0.0, f"p95_{unit}": 0.0, f"p99_{unit}": 0.0}
    p50, p95, p99 = np.percentile(a, [50, 95, 99])
    return {"n": int(count if count is not None else a.size),
            f"mean_{unit}": round(float(np.mean(a)), 4),
            f"p50_{unit}": round(float(p50), 4),
            f"p95_{unit}": round(float(p95), 4),
            f"p99_{unit}": round(float(p99), 4)}


class Counter:
    """Monotonic counter (Prometheus ``counter``)."""

    __slots__ = ("name", "help", "labels", "value")

    def __init__(self, name, help="", labels=None):
        self.name, self.help, self.labels = name, help, labels
        self.value = 0.0

    def inc(self, n=1.0):
        self.value += n

    def to_prometheus(self) -> str:
        n = _prom_name(self.name)
        return (f"# HELP {n} {self.help}\n# TYPE {n} counter\n"
                f"{n}{_fmt_labels(self.labels)} {self.value:g}\n")

    def to_json(self) -> dict:
        return {"type": "counter", "value": self.value,
                **({"labels": self.labels} if self.labels else {})}


class Gauge:
    """Point-in-time value (Prometheus ``gauge``)."""

    __slots__ = ("name", "help", "labels", "value")

    def __init__(self, name, help="", labels=None):
        self.name, self.help, self.labels = name, help, labels
        self.value = 0.0

    def set(self, v):
        self.value = float(v)

    def to_prometheus(self) -> str:
        n = _prom_name(self.name)
        return (f"# HELP {n} {self.help}\n# TYPE {n} gauge\n"
                f"{n}{_fmt_labels(self.labels)} {self.value:g}\n")

    def to_json(self) -> dict:
        return {"type": "gauge", "value": self.value,
                **({"labels": self.labels} if self.labels else {})}


class Histogram:
    """Ring-reservoir histogram: quantiles over the latest ``capacity``
    observations, exported as a Prometheus ``summary`` (p50/p95/p99).

    ``unit`` names the measurement unit in the JSON summary keys
    (``mean_ms`` etc — the :func:`latency_summary` schema).
    """

    __slots__ = ("name", "help", "labels", "unit", "_buf", "_n", "_sum",
                 "_lock")

    def __init__(self, name, help="", labels=None, capacity=1024, unit="ms"):
        self.name, self.help, self.labels = name, help, labels
        self.unit = unit
        self._buf = np.empty((capacity,), np.float64)
        self._n = 0
        self._sum = 0.0
        self._lock = threading.Lock()

    def observe(self, v):
        v = float(v)
        with self._lock:
            self._buf[self._n % self._buf.size] = v
            self._n += 1
            self._sum += v

    @property
    def count(self) -> int:
        return self._n

    def values(self) -> np.ndarray:
        """The retained reservoir (latest ``capacity`` observations)."""
        with self._lock:
            return self._buf[:min(self._n, self._buf.size)].copy()

    def quantile(self, q: float) -> float:
        v = self.values()
        return float(np.percentile(v, 100.0 * q)) if v.size else 0.0

    def summary(self) -> dict:
        v = self.values()
        return latency_summary(v, unit=self.unit, count=self._n)

    def to_prometheus(self) -> str:
        n = _prom_name(self.name)
        base = "" if not self.labels else _fmt_labels(self.labels)[1:-1]
        lines = [f"# HELP {n} {self.help}", f"# TYPE {n} summary"]
        for q in (0.5, 0.95, 0.99):
            labels = f'{{{base + "," if base else ""}quantile="{q:g}"}}'
            lines.append(f"{n}{labels} {self.quantile(q):g}")
        suffix = _fmt_labels(self.labels)
        lines.append(f"{n}_sum{suffix} {self._sum:g}")
        lines.append(f"{n}_count{suffix} {self._n}")
        return "\n".join(lines) + "\n"

    def to_json(self) -> dict:
        return {"type": "histogram", "summary": self.summary(),
                **({"labels": self.labels} if self.labels else {})}


class Registry:
    """Named metrics with one Prometheus-text + one JSON exporter.

    Get-or-create semantics: asking twice for the same (name, labels)
    returns the same instance, so call sites don't thread metric handles
    around.
    """

    def __init__(self):
        self._metrics: dict = {}
        self._lock = threading.Lock()

    def _get(self, cls, name, help, labels, **kw):
        key = (name, tuple(sorted((labels or {}).items())))
        with self._lock:
            m = self._metrics.get(key)
            if m is None:
                m = self._metrics[key] = cls(name, help, labels, **kw)
            elif not isinstance(m, cls):
                raise TypeError(f"metric {name!r} already registered as "
                                f"{type(m).__name__}")
            return m

    def counter(self, name, help="", labels=None) -> Counter:
        return self._get(Counter, name, help, labels)

    def gauge(self, name, help="", labels=None) -> Gauge:
        return self._get(Gauge, name, help, labels)

    def histogram(self, name, help="", labels=None, capacity=1024,
                  unit="ms") -> Histogram:
        return self._get(Histogram, name, help, labels,
                         capacity=capacity, unit=unit)

    def metrics(self) -> list:
        with self._lock:
            return list(self._metrics.values())

    def to_prometheus(self) -> str:
        return "".join(m.to_prometheus() for m in self.metrics())

    def to_json(self) -> dict:
        out = {}
        for m in self.metrics():
            entry = m.to_json()
            if m.name in out:       # same name, different labels
                prev = out[m.name]
                stack = prev if isinstance(prev, list) else [prev]
                stack.append(entry)
                entry = stack
            out[m.name] = entry
        return out

    def save(self, prefix: str) -> tuple[str, str]:
        """Write ``<prefix>.prom`` (Prometheus text exposition) and
        ``<prefix>.metrics.json``; returns both paths."""
        prom, js = prefix + ".prom", prefix + ".metrics.json"
        with open(prom, "w") as f:
            f.write(self.to_prometheus())
        with open(js, "w") as f:
            json.dump(self.to_json(), f, indent=2)
        return prom, js


_DEFAULT = Registry()


def default_registry() -> Registry:
    return _DEFAULT


def log(event: str, **fields) -> str:
    """One structured log line: ``event=<name> ts=<unix> k=v ...``.

    The serve loops' replacement for ad-hoc prints — machine-parseable
    key=value pairs, floats at 4 significant digits, strings with spaces
    quoted.  Returns the line (tests parse it) after printing.
    """
    def fmt(v):
        if isinstance(v, float):
            return f"{v:.4g}"
        if isinstance(v, str) and (" " in v or "=" in v):
            return json.dumps(v)
        return str(v)

    parts = [f"event={event}", f"ts={time.time():.3f}"]
    parts += [f"{k}={fmt(v)}" for k, v in fields.items()]
    line = " ".join(parts)
    print(line, flush=True)
    return line
