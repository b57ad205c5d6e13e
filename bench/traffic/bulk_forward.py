"""Bulk scoring: one client calls ``Engine.forward`` back to back.

Parameters (the workload file's ``params``): ``batch`` windows a call,
cut from a pool of ``pool_windows`` windows drawn in set-up on the device
from the seed (``normal(0, input_std)`` MFCC windows of the model's
``input_dim``) and kept in pinned host memory, where an indexing service
stages what it hands over (a pageable copy goes through the host's own
memcpy, whose speed moved this cell's rate by 2-3 % from run to run).
Call ``j`` sends the ``batch`` windows from the ``j``-th of a seeded
order of the pool's offsets, a view of the pool and no copy, so no two
calls of a run send the same batch (the order wraps only after
``pool_windows - batch + 1`` calls).  The client keeps the card fed as an
indexing service does: each call's windows go to the card by an
asynchronous copy from the pinned pool, its logits come back by another
into pinned host memory, and up to ``ahead_s`` seconds of calls (sized
from a warm call's time in set-up) are in flight before it waits for the
oldest, so a stall of the host's shared cores does not idle the card.
End to end: ``windows_per_s``, every window of every call dispatched in
the window, over the window up to when the last of them reached the host.

The check: ``check_calls`` of the run's calls drawn from the seed (the
last one among them), every window of them through the model family's
reference (``bench/ref/<family>.py``: the configuration's int8 weights
re-derived from the same float tree), the largest and the mean gap of a
logit.
"""

from __future__ import annotations

import collections
import math
import time

import numpy as np
import torch

from bench.core import sample

SLAB = 64       # calls' logits in one pinned host allocation


class Cell:
    def __init__(self, ctx):
        self.ctx = ctx
        self.p = ctx.params
        self.calls = 0
        self.outputs = []           # logits of each call, on the host
        self.pending = collections.deque()   # the calls in flight
        self.slab, self.used = None, 0

    def setup(self):
        self.engine = self.ctx.engine()
        self.pool = self.inputs()
        rng = np.random.default_rng([int(self.ctx.seed), 5])
        self.offsets = rng.permutation(len(self.pool) - self.p["batch"] + 1)
        self.warm_x = self.batch(-1).to(self.ctx.device)
        self.engine.forward(self.warm_x).cpu()          # the one shape
        t0 = time.perf_counter()
        self.engine.forward(self.warm_x).cpu()
        call_s = time.perf_counter() - t0
        self.depth = max(1, math.ceil(self.p["ahead_s"] / call_s))

    def inputs(self) -> torch.Tensor:
        """The pool of windows, one pinned host tensor."""
        p, model = self.p, self.ctx.model
        gen = torch.Generator(device=self.ctx.device)
        gen.manual_seed(int(self.ctx.seed) + 1)
        x = torch.randn((p["pool_windows"], *model["input_dim"]),
                        generator=gen, device=self.ctx.device)
        x.mul_(p["input_std"])
        host = torch.empty(x.shape, pin_memory=x.is_cuda)
        return host.copy_(x)

    def batch(self, j: int) -> torch.Tensor:
        """The windows call ``j`` sends (``-1``: the warm-up's)."""
        off = int(self.offsets[j % len(self.offsets)])
        return self.pool[off:off + self.p["batch"]]

    def host_out(self, like: torch.Tensor) -> torch.Tensor:
        """Pinned host memory for one call's logits."""
        if self.slab is None or self.used == len(self.slab):
            self.slab = torch.empty((SLAB, *like.shape), dtype=like.dtype,
                                    pin_memory=like.is_cuda)
            self.used = 0
        self.used += 1
        return self.slab[self.used - 1]

    def step(self):
        x = self.batch(self.calls).to(self.ctx.device, non_blocking=True)
        logits = self.engine.forward(x)
        out = self.host_out(logits)
        out.copy_(logits, non_blocking=True)
        self.outputs.append(out)
        self.calls += 1
        if logits.is_cuda:
            done = torch.cuda.Event()
            done.record()
            self.pending.append(done)
            while len(self.pending) > self.depth:
                self.pending.popleft().synchronize()

    def end_to_end(self, window_s):
        return {"windows_per_s": self.calls * self.p["batch"] / window_s}

    def count_call(self):
        self.engine.forward(self.warm_x).cpu()

    def work(self) -> dict:
        return {"batch": self.p["batch"]}

    def release(self):
        self.engine = self.warm_x = None

    def check(self) -> list:
        ctx = self.ctx
        ref = ctx.spec.reference(ctx.model["family"])
        picks = sample.pick_calls(len(self.outputs), self.p["check_calls"],
                                  ctx.seed)
        w = ref.prepare(ctx.weights(), ctx.model, ctx.config["quant"])
        x_exp = ctx.config["quant"]["input_exponent"]
        gaps = []
        with torch.no_grad():
            for j in picks:
                want = ref.forward_blocks(w, self.batch(j).to(ctx.device),
                                          ctx.model, x_exp,
                                          self.p["ref_rows"])
                got = self.outputs[j].to(ctx.device)
                gaps.append((got - want).abs().flatten())
        return sample.gap_checks(ctx, "logit_gap", torch.cat(gaps))
