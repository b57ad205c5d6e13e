"""Sequence scoring: one client calls ``Engine.forward`` back to back on
``batch`` x ``seq_len`` token ids and takes each position's
log-probability of the next token.

Parameters: ``batch``, ``seq_len``, ``pool`` distinct calls' tokens drawn
in set-up on the device from the seed, uniform over the vocabulary, and
kept in host memory; call ``j`` sends pool entry ``j``, so no two calls of
a run send the same tokens while the run makes fewer than ``pool - 1``
(the last entry warms up; the order wraps after that).  The
log-probabilities are taken on the device from the logits (the gold
logit less the row's logsumexp) and only they are copied to the host.
End to end: ``score_tokens_per_s``, every token whose log-probability
reached the host, ``batch * (seq_len - 1)`` a call, over the window.

The check: ``check_calls`` of the run's calls drawn from the seed (the
last one among them) through the model family's reference
(``bench/ref/<family>.py``: the weights cast again from the same float
tree, a layer at a time over the call); the largest and the mean gap of
a log-probability.
"""

from __future__ import annotations

import time

import torch

from bench.core import sample


def next_token_logprobs(logits: torch.Tensor, tokens: torch.Tensor
                        ) -> torch.Tensor:
    """[B, S, V] logits, [B, S] tokens -> [B, S - 1] log-probabilities."""
    gold = logits[:, :-1].gather(-1, tokens[:, 1:, None].long())[..., 0]
    return gold - logits[:, :-1].logsumexp(-1)


class Cell:
    def __init__(self, ctx):
        self.ctx = ctx
        self.p = ctx.params
        self.calls = 0
        self.latencies_ms = []
        self.outputs = []           # log-probabilities of each call, host

    @property
    def ref(self):
        return self.ctx.spec.reference(self.ctx.model["family"])

    def setup(self):
        ctx = self.ctx
        self.engine = ctx.engine()
        self.pool = self.inputs()
        self._call(-1)                                # the one shape

    def inputs(self) -> torch.Tensor:
        p = self.p
        gen = torch.Generator(device=self.ctx.device)
        gen.manual_seed(int(self.ctx.seed) + 1)
        return torch.randint(0, self.ctx.model["vocab_size"],
                             (p["pool"], p["batch"], p["seq_len"]),
                             generator=gen, device=self.ctx.device).cpu()

    def tokens(self, j: int) -> torch.Tensor:
        """The tokens call ``j`` sends (``-1``: the warm-up's)."""
        return self.pool[j % (len(self.pool) - 1) if j >= 0 else -1]

    def _call(self, j: int) -> torch.Tensor:
        tokens = self.tokens(j)
        logits = self.engine.forward(tokens)
        return next_token_logprobs(logits, tokens.to(logits.device)).cpu()

    def step(self):
        t0 = time.perf_counter()
        lp = self._call(self.calls)
        self.latencies_ms.append(1e3 * (time.perf_counter() - t0))
        self.outputs.append(lp)
        self.calls += 1

    def end_to_end(self, window_s):
        p = self.p
        return {"score_tokens_per_s":
                self.calls * p["batch"] * (p["seq_len"] - 1) / window_s}

    def count_call(self):
        self._call(-1)

    def work(self) -> dict:
        return {"batch": self.p["batch"], "seq_len": self.p["seq_len"]}

    def release(self):
        self.engine = None

    def check(self) -> list:
        ctx = self.ctx
        ref = self.ref
        picks = sample.pick_calls(len(self.outputs), self.p["check_calls"],
                                  ctx.seed)
        w = ref.prepare(ctx.weights(), ctx.config["quant"])
        x_exp = ctx.config["quant"]["input_exponent"]
        gaps = []
        with torch.no_grad():
            for j in picks:
                want = ref.logprobs(w, self.tokens(j).to(ctx.device),
                                    ctx.model, x_exp)
                got = self.outputs[j].to(ctx.device)
                gaps.append((got - want).abs().flatten())
        return sample.gap_checks(ctx, "logprob_gap", torch.cat(gaps))

