"""One run of one cell: set-up, the timed window, the traced window, the
per-layer readers, then the check against the plain reference.

A traffic kind (``bench/traffic/<kind>.py``) gives a ``Cell`` with

* ``setup()``      build the program and the traffic, warm every shape;
* ``step()``       one timed call, its answers kept for the check;
* ``end_to_end(window_s)``  the kind's end-to-end metrics of the window;
* ``count_call()`` one more call, under the ATen op counter;
* ``work()``       the shapes of one call, for the FLOP and byte counts;
* ``release()``    drop the program's state;
* ``check()``      the reference's comparison: ``[{name, value, limit}]``;

and the attribute ``calls`` (timed calls so far); a kind whose readers
take per-call latencies keeps them in ``latencies_ms``.
"""

from __future__ import annotations

import dataclasses
import gc
import math
import time
from typing import Any, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from bench.core import precision, program, weights
from bench.core.spec import Spec
from bench.core.trace import Trace

TRACE_SECONDS = 3.0      # the profiled window, at least two calls


@dataclasses.dataclass
class Context:
    """What a traffic kind is built from."""

    spec: Spec
    workload: dict
    config: dict
    seed: int
    device: torch.device
    plan: dict
    param_overrides: dict = dataclasses.field(default_factory=dict)

    @property
    def model(self) -> dict:
        return self.config["model"]

    @property
    def family(self):
        """The model family's file (``bench/models/<family>.py``)."""
        return self.spec.model_family(self.model["family"])

    @property
    def params(self) -> dict:
        return {**self.workload["params"], **self.param_overrides}

    def model_config(self):
        return program.model_config(self.config)

    def weights(self) -> dict:
        """The seed's float tree, drawn on the device (the same for the
        program and the reference)."""
        return weights.draw(self.family.layout(self.model),
                            self.config["weights"], self.seed, self.device)

    def engine(self):
        """The program under the plan, from the seed's weights."""
        return program.compile_engine(self.config, self.model_config(),
                                      self.weights(), self.device, self.plan)

    def limit(self, name: str) -> float:
        return float(self.workload["limits"][name])


def context(spec: Spec, cell: str, seed: int, device, plan=None,
            model_overrides=None, **overrides) -> Context:
    """The cell's context; ``model_overrides`` change the configuration's
    model fields (the CPU rehearsals' tiny sizes)."""
    wl = spec.workload(cell)
    config = spec.config(wl["config"])
    config["model"] = {**config["model"], **(model_overrides or {})}
    plan = {**config["plan"], **(plan or {})}
    return Context(spec, wl, config, seed, torch.device(device), plan,
                   **overrides)


@dataclasses.dataclass
class RunInfo:
    """What the per-layer readers read."""

    spec: Spec
    cell: Any
    model: dict
    config: dict
    workload: dict
    calls: int
    window_s: float
    traced_calls: int = 0
    trace: Optional[Trace] = None
    aten_ops: Optional[int] = None


class CountOps(TorchDispatchMode):
    """Counts the ATen ops dispatched (a kernel launched through ``ctypes``
    is not one)."""

    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.n += 1
        return func(*args, **(kwargs or {}))


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run(ctx: Context, seconds: float, trace: bool, t_start: float,
        cell_class=None, log=None, after_setup=None) -> dict:
    """The run's result (the contract's keys, and ``checks``); ``log``
    takes a line on where set-up went; ``after_setup()`` is called once
    set-up is done (a control's switch)."""
    dev = ctx.device
    kind = ctx.spec.traffic(ctx.workload["kind"])
    cell = (cell_class or kind.Cell)(ctx)
    t_cell = time.perf_counter()
    cell.setup()
    _sync(dev)
    setup_s = time.perf_counter() - t_start
    if after_setup is not None:
        after_setup()
    tf32 = precision.tf32_allowed()
    if log is not None:
        log(f"set-up {setup_s:.3f} s: {t_cell - t_start:.3f} s to the "
            f"cell (imports, the card), {setup_s - t_cell + t_start:.3f} s "
            "in it (weights, plan, kernel build, traffic, warm-up)")

    # the harness's own garbage (the answers it keeps) is not collected
    # inside the window: a collection there lands on whichever call it
    # interrupts, a tail no program change could move
    gc.collect()
    gc.freeze()
    gc.disable()
    t0 = time.perf_counter()
    try:
        while time.perf_counter() - t0 < seconds:
            cell.step()
        t_close = time.perf_counter()
        _sync(dev)
        window_s = time.perf_counter() - t0
    finally:
        gc.enable()
        gc.unfreeze()
    if log is not None:
        log(f"window {window_s:.3f} s, {cell.calls} calls; "
            f"{t0 + window_s - t_close:.3f} s of it waiting, once the "
            "last call was sent, for the work in flight")
    info = RunInfo(ctx.spec, cell, ctx.model, ctx.config, ctx.workload,
                   cell.calls, window_s)
    e2e = {**cell.end_to_end(window_s), "setup_s": setup_s}

    device = {"platform": "gpu" if dev.type == "cuda" else dev.type,
              "kind": torch.cuda.get_device_name(dev)
              if dev.type == "cuda" else "cpu",
              "count": ctx.workload["chips"]}
    breakdown = None
    if trace:
        _profile(cell, info, dev)
        with CountOps() as counter:
            cell.count_call()
        _sync(dev)
        info.aten_ops = counter.n
        device.update(busy_s=info.trace.busy_s(),
                      window_s=info.trace.window_s)
        breakdown = {"device_ops": info.trace.top_ops(),
                     "idle_gaps": info.trace.idle_gaps()}
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    device["memory_peak_bytes"] = int(peak)
    e2e["peak_mem_gb"] = peak / 1e9

    if trace:
        metrics = {}
        for m in ctx.spec.per_layer(ctx.workload["name"]):
            value = ctx.spec.reader(m["name"]).read(m["name"], info)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        metrics = {m["name"]: {"value": e2e[m["name"]], "unit": m["unit"]}
                   for m in ctx.spec.end_to_end(ctx.workload["name"])}

    tf32 = tf32 or precision.tf32_allowed()
    cell.release()
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    precision.allow_tf32(False)
    checks = cell.check()
    if ctx.config.get("tf32") is False:
        checks.append({"name": "tf32", "value": float(tf32), "limit": 0.0})
    correct = all(math.isfinite(c["value"]) and c["value"] <= c["limit"]
                  for c in checks)
    out = {"correct": correct, "attempted": cell.calls, "failed": 0,
           "metrics": metrics, "device": device}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["checks"] = checks
    return out


def _profile(cell, info: RunInfo, dev: torch.device) -> None:
    """A short window under ``torch.profiler``: at least two calls and
    ``TRACE_SECONDS``."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if dev.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    before = cell.calls
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        while cell.calls - before < 2 or \
                time.perf_counter() - t0 < TRACE_SECONDS:
            cell.step()
        _sync(dev)
        window = time.perf_counter() - t0
    info.traced_calls = cell.calls - before
    info.trace = Trace.read(prof, window)
