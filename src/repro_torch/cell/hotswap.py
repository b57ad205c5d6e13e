"""Checkpoint-watching hot-swap: new weights without dropping a lane.

The eval-side checkpoint loop (retrieve latest step / wait for a new
step / load for step) pointed at a directory where training (or QAT
export) publishes packed artifacts through ``checkpoint.manager`` —
atomic tmp+rename, so the watcher only ever sees complete steps.

A swap is a four-stage transaction (``hot_swap``):

1. **load**  — ``manager.restore`` reads the step's pytree (typically a
   packed QTensor tree straight from ``qat.export``) against a
   structure template and ``runtime.compile_model`` plans it under the
   SAME backend, attention realisation and device as the serving engine.
2. **warm**  — the probe batch runs through the new engine's forward,
   first-touching its kernels and buffers off the serving path.
3. **verify** — the parity gate against a dequantise-first reference
   plan of the SAME artifact: on the same backend, except on ``cuda``,
   which integer-executes by construction and cannot be planned
   dequantise-first; there the reference plan is ``lut`` on the same
   device, whose softmax/GELU numerics are the kernels' bit for bit.  Non-executing integer-resident plans
   must be ``array_equal`` (the PR-5 bit-identity invariant, restated
   as a deploy gate).  Integer-EXECUTING plans quantise activations and
   clip residuals as part of their math, so bitwise equality to the
   float view is impossible by design; they gate on a max-abs bound
   (``_INT_EXEC_PROBE_TOL``, sized to the documented activation-quant
   envelope — a corrupted artifact lands orders of magnitude outside
   it).  Either way a broken plan fails CLOSED: the cell keeps serving
   the old engine.
4. **swap** — ``EngineHandle.swap`` installs the engine atomically
   under the handle's lock.  Lane state (rings, detector state) lives
   outside the Engine and the exec config is unchanged by contract, so
   in-flight lanes continue with the new params — no hop is dropped.
"""

from __future__ import annotations

import math
import time
from typing import Any, Optional

import torch

from repro_torch import runtime
from repro_torch.checkpoint import manager
from repro_torch.telemetry import log as _log


class SwapRejected(RuntimeError):
    """The parity gate refused the new artifact; the old engine serves on."""


# Max-abs probe-logit divergence an integer-EXECUTING plan may show
# against the dequantise-first float view of the same artifact: the
# eq-9 activation-quant + INT16-residual envelope (same family as the
# documented float-vs-lut logit tolerance).  Corruption (bit flips in
# the payload, wrong exponents) lands orders of magnitude outside.
_INT_EXEC_PROBE_TOL = 0.5


class CheckpointWatcher:
    """Polls a checkpoint directory for steps newer than the last seen.

    ``clock``/``sleep`` are injectable so waiting is unit-testable.
    """

    def __init__(self, ckpt_dir: str, *, poll_s: float = 0.5,
                 clock=time.monotonic, sleep=time.sleep):
        self.ckpt_dir = ckpt_dir
        self.poll_s = poll_s
        self._clock, self._sleep = clock, sleep
        self.last_step: Optional[int] = None

    def retrieve_latest_step(self) -> Optional[int]:
        """Newest COMPLETE step on disk (partial writes are invisible:
        manager.latest_step skips tmp dirs and manifest-less stragglers)."""
        return manager.latest_step(self.ckpt_dir)

    def poll(self) -> Optional[int]:
        """A step newer than the last seen, or None. Non-blocking."""
        step = self.retrieve_latest_step()
        if step is not None and (self.last_step is None
                                 or step > self.last_step):
            return step
        return None

    def wait_for_new_step(self, timeout_s: Optional[float] = None
                          ) -> Optional[int]:
        """Block (poll/sleep) until a new step appears; None on timeout."""
        t0 = self._clock()
        while True:
            step = self.poll()
            if step is not None:
                return step
            if timeout_s is not None and self._clock() - t0 >= timeout_s:
                return None
            self._sleep(self.poll_s)

    def load_for_step(self, step: int, like: Any) -> Any:
        """Read step's pytree against the ``like`` structure template and
        mark the step consumed."""
        tree = manager.restore(self.ckpt_dir, step, like)
        self.last_step = step
        return tree


def _gate_backend(backend) -> str:
    """The backend of the gate's dequantise-first reference plan: the
    serving backend, or ``lut`` for a kernel backend (same numerics)."""
    return "lut" if backend.uses_kernels else backend.name


def hot_swap(handle: "runtime.EngineHandle", params: Any, probe,
             *, metrics=None, strict: bool = True) -> "runtime.Engine":
    """Plan ``params`` under the handle's current backend, warm it, gate
    it on probe parity, and install it.  Returns the REPLACED engine.

    ``probe`` is a small representative input batch (mfcc for kwt).
    Raises :class:`SwapRejected` (engine untouched) when the parity gate
    fails; propagates ``EngineHandle.swap``'s ``ValueError`` on
    exec-config/shape mismatch when ``strict``.
    """
    old = handle.engine
    t0 = time.perf_counter()
    plan = dict(attention=old.exec_cfg.attn_impl, device=old.device)
    new = runtime.compile_model(old.cfg, params, backend=old.backend_name,
                                **plan)
    got = new.forward(probe)                              # warm
    err = None
    if new.int_resident:
        # deploy gate: the packed plan must reproduce the
        # dequantise-first (non-executing) plan of the SAME artifact —
        # bitwise for resident plans, within the activation-quant
        # envelope for integer-executing ones (module docstring).
        ref = runtime.compile_model(old.cfg, params,
                                    backend=_gate_backend(old.backend),
                                    integer_resident=False,
                                    integer_exec=False, **plan)
        want = ref.forward(probe)
        err = float((got.double() - want.double()).abs().max())
        if new.int_exec:
            bad = not math.isfinite(err) or err > _INT_EXEC_PROBE_TOL
        else:
            bad = not torch.equal(got, want)
        if bad:
            if metrics is not None:
                metrics.swap_failures.inc()
            raise SwapRejected(
                "probe logits of the packed plan diverge from the "
                "dequantise-first reference — artifact refused, old "
                "engine keeps serving")
    try:
        replaced = handle.swap(new, strict=strict)
    except ValueError:
        if metrics is not None:
            metrics.swap_failures.inc()
        raise
    dt_ms = 1e3 * (time.perf_counter() - t0)
    if metrics is not None:
        metrics.swaps.inc()
        metrics.swap_ms.observe(dt_ms)
        metrics.engine_generation.set(handle.generation)
    _log("hot_swap", generation=handle.generation, ms=dt_ms,
         backend=new.backend_name, resident=new.int_resident,
         probe_err=err)
    return replaced


def poll_and_swap(handle, watcher: CheckpointWatcher, like: Any, probe,
                  *, metrics=None) -> bool:
    """One non-blocking watch tick for a serving loop: if a new complete
    step landed, load + hot-swap it.  Returns True when a swap happened.
    A rejected artifact is consumed (no retry storm) but not installed."""
    step = watcher.poll()
    if step is None:
        return False
    params = watcher.load_for_step(step, like)
    try:
        hot_swap(handle, params, probe, metrics=metrics)
    except SwapRejected:
        return False
    return True
