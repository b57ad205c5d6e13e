"""Continuous batching for LM serving: in-flight join, per-lane evict.

A fixed pool of ``slots`` decode lanes, each at its own depth:

* the decode state's ``index`` is a per-lane [B] tensor
  (``models.transformer``: cache writes scatter at ``[lane, idx[lane]]``,
  RoPE positions and validity bounds are per-lane), so every lane decodes
  at its own depth;
* joiners prefill into a FRESH decode state (an ordinary int-index
  prefill of the right-padded prompts minus their last token), which is
  then merged per lane into the live state
  (``transformer.merge_decode_state``) — resident lanes never stop
  decoding and their caches are untouched;
* the first ``decode_step`` after a join feeds the prompt's LAST token,
  writing its keys and values at slot ``len-1`` under the lane's own
  position — from then on the lane is indistinguishable from one that
  prefilled alone.

Because positions, cache slots and validity masks are all per lane, a
request's greedy tokens depend only on its prompt, the batch width and
the prefill pad width — not on what the other lanes are doing.  With a
fixed ``prefill_len`` the schedule is invisible to outputs: the same
requests in any order give the same tokens per request
(``tests/test_torch_lm_serve.py``; ``chip_smoke.py`` on the card).

Free lanes keep decoding (the batch shape is static) and their outputs
are discarded.  Every free lane is parked at depth 0 before each step:
the reference parks a lane once, when it is evicted, and relies on
JAX's scatter dropping writes past the cache end when a lane stays free
longer than ``max_len`` steps; PyTorch's ``index_put_`` has no such
mode.

Families: dense and moe (KV-cache attention, where pad keys can be
masked after the fact).  Recurrences fold pad tokens irreversibly into
their state and are refused.  A moe join group shares its experts'
capacity (``models.moe``): its prompts and their pad tokens compete for
the same slots, so order invariance holds for moe only where routing
drops nothing (ROADMAP C8).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.models import transformer


@dataclasses.dataclass(frozen=True)
class Request:
    """One generation request: prompt tokens + a generation budget."""

    rid: Any
    prompt: np.ndarray          # [L] int32, L >= 1
    max_new: int                # generation budget (tokens)


@dataclasses.dataclass(frozen=True)
class TokenEvent:
    """One decoded token for one request (``done`` on the last one)."""

    rid: Any
    token: int
    done: bool = False
    reason: str = ""            # "eos" | "len" when done


def _bucket(n: int) -> int:
    """Next power of two >= n: prompts of similar length share a prefill
    width."""
    b = 1
    while b < n:
        b *= 2
    return b


class LMScheduler:
    """A fixed pool of ``slots`` decode lanes with in-flight join/evict.

    Drive with ``submit`` + repeated ``step``; each ``step`` joins waiting
    requests into free lanes (one batched fresh prefill, no drain),
    advances EVERY lane one greedy token, and evicts lanes whose request
    hit EOS or its budget.

    ``engine`` is a ``runtime.Engine`` or a swap-safe
    ``runtime.EngineHandle``; the scheduler reads the live engine each
    step, so a hot-swap between steps changes params only (lane caches
    and positions survive).

    ``metrics`` (``telemetry.cell.make_cell_metrics``) receives
    ``cell_tokens_total``, ``cell_decode_latency_ms``,
    ``cell_prefill_latency_ms``, the joins / evictions / prefill-token
    counters, the queue depth and the lane occupancy.  A latency is the
    host's wall time of the call; on the card it is fenced with
    ``torch.cuda.synchronize`` only while metrics are kept.
    """

    def __init__(self, engine, *, slots: int, max_len: int,
                 eos_id: Optional[int] = None,
                 prefill_len: Optional[int] = None, metrics=None):
        cfg = self._engine(engine).exec_cfg
        if cfg.family not in transformer.KV_FAMILIES:
            raise NotImplementedError(
                "continuous batching covers the dense/moe KV-cache families, "
                f"not {cfg.family}")
        self._eng_ref = engine
        self.slots, self.max_len, self.eos_id = slots, max_len, eos_id
        self.prefill_len = prefill_len      # None -> per-group pow2 bucket
        self.metrics = metrics
        self.queue: list[Request] = []
        self.active: list[Optional[Request]] = [None] * slots
        self._remaining = np.zeros(slots, np.int64)
        eng = self._engine(engine)
        self.state = eng.init_decode_state(slots, max_len)
        # per-lane depth from step one
        self.state["index"] = torch.zeros((slots,), dtype=torch.long,
                                          device=eng.device)
        self._cur = torch.zeros((slots,), dtype=torch.long, device=eng.device)

    @staticmethod
    def _engine(ref):
        return ref.engine if hasattr(ref, "engine") else ref

    @property
    def engine(self):
        return self._engine(self._eng_ref)

    def _fence(self):
        dev = self.engine.device
        if self.metrics is not None and dev.type == "cuda":
            torch.cuda.synchronize(dev)

    # -- request intake ----------------------------------------------------

    def submit(self, rid, prompt, max_new: int) -> None:
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        if not (1 <= prompt.size
                and prompt.size - 1 + max_new <= self.max_len):
            raise ValueError(
                f"request {rid!r}: a prompt of {prompt.size} tokens and "
                f"{max_new} new ones do not fit max_len={self.max_len}")
        self.queue.append(Request(rid, prompt, int(max_new)))
        if self.metrics is not None:
            self.metrics.queue_depth.set(len(self.queue))

    @property
    def n_active(self) -> int:
        return sum(1 for r in self.active if r is not None)

    def idle(self) -> bool:
        return self.n_active == 0 and not self.queue

    # -- one scheduler tick ------------------------------------------------

    def step(self) -> list[TokenEvent]:
        """Join waiting requests, decode one token on every lane, evict."""
        if self.idle():
            return []
        self._join()
        eng, met = self.engine, self.metrics
        with torch.inference_mode():
            free = torch.tensor([r is None for r in self.active],
                                device=eng.device)
            self.state["index"] = torch.where(free, 0, self.state["index"])
        t0 = time.perf_counter()
        logits, self.state = eng.decode_step(self._cur, self.state)
        with torch.inference_mode():
            self._cur = logits.argmax(-1)
        toks = self._cur.cpu().numpy()
        if met is not None:
            self._fence()
            met.decode_ms.observe(1e3 * (time.perf_counter() - t0))
            met.tokens.inc(self.n_active)
        events, evicted = [], 0
        for i, req in enumerate(self.active):
            if req is None:
                continue
            self._remaining[i] -= 1
            is_eos = self.eos_id is not None and int(toks[i]) == self.eos_id
            done = is_eos or self._remaining[i] <= 0
            events.append(TokenEvent(req.rid, int(toks[i]), done,
                                     ("eos" if is_eos else "len")
                                     if done else ""))
            if done:
                self.active[i] = None
                evicted += 1
        if met is not None:
            if evicted:
                met.evictions.inc(evicted)
            met.occupancy.set(self.n_active / self.slots)
        return events

    def run(self) -> dict:
        """Drain: step until idle, tokens grouped per request id."""
        out: dict = {}
        while not self.idle():
            for ev in self.step():
                out.setdefault(ev.rid, []).append(ev.token)
        return out

    # -- the join half -----------------------------------------------------

    def _join(self) -> None:
        free = [i for i in range(self.slots) if self.active[i] is None]
        joins = list(zip(free, [self.queue.pop(0)
                                for _ in free[:len(self.queue)]]))
        if not joins:
            return
        eng, met = self.engine, self.metrics
        B = self.slots
        # right-pad prompts MINUS their last token; the first decode_step
        # feeds that token, so real token j always sits at cache slot j
        # with position j and pad keys are masked by the per-lane validity
        # bound — lane results don't depend on co-joiners' prompts.
        lens = {i: len(r.prompt) for i, r in joins}
        plen = self.prefill_len or _bucket(max(max(lens.values()) - 1, 1))
        if plen < max(lens.values()) - 1:
            raise ValueError(f"prefill_len={plen} is shorter than a "
                             "submitted prompt")
        toks = np.zeros((B, plen), np.int32)
        cur = self._cur.cpu().numpy().copy()
        idx = self.state["index"].cpu().numpy().copy()
        mask = np.zeros(B, bool)
        for i, req in joins:
            toks[i, :lens[i] - 1] = req.prompt[:-1]
            cur[i] = req.prompt[-1]
            idx[i] = lens[i] - 1
            mask[i] = True
            self.active[i] = req
            self._remaining[i] = req.max_new
        t0 = time.perf_counter()
        fresh = eng.init_decode_state(B, self.max_len)
        _, fresh = eng.prefill(toks, fresh)
        with torch.inference_mode():
            merged = transformer.merge_decode_state(self.state, fresh, mask)
            merged["index"] = torch.as_tensor(idx, dtype=torch.long,
                                              device=eng.device)
        self.state = merged
        self._cur = torch.as_tensor(cur, dtype=torch.long, device=eng.device)
        if met is not None:
            self._fence()
            met.prefill_ms.observe(1e3 * (time.perf_counter() - t0))
            met.joins.inc(len(joins))
            met.prefill_tokens.inc(int(sum(lens.values())))
            met.queue_depth.set(len(self.queue))
