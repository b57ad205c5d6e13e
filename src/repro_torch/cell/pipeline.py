"""Double-buffered hop pipelining: featurise t+1 under encode t.

``stream.engine.stream_step`` is one hop: featurise -> embed -> ring ->
encode.  The cell splits it at the seam where the encoder takes over —
the assembled [B, T, d] window — into two callables,

* ``featurise``: frontend_push + embed_frames + ring pushes -> the new
  state and its window (everything that depends on hop t's audio),
* ``encode``: window -> logits (the heavy encoder),

and on the card overlaps them on two CUDA streams: while ``encode`` of
hop t runs on the current stream, ``featurise`` of hop t+1 runs on a side
stream, so the feature front runs one hop ahead of the encoder.  Host
chunks are staged through pinned memory with a non-blocking copy on the
side stream, so the host-to-device copy overlaps too.  This takes the
place of the reference's asynchronous dispatch of two jitted programs,
``device_put`` and buffer donation.

Ordering across the two streams: the current stream waits for an event
recorded after ``featurise`` t before ``encode`` t reads the window, and
every tensor that crosses from the side stream to the current one (the
window, the yielded state) is marked with ``record_stream`` so that the
caching allocator does not hand its memory to ``featurise`` t+1 while
the current stream may still read it.  ``featurise`` writes no tensor in
place (the ring's pushes and read-out are out of place), so the window
``encode`` t reads is never rewritten under it.

Bit-identity: both callables run the same operations as the fused
``stream_step``, in the same order per hop, so :meth:`HopPipeline.step`
and :meth:`HopPipeline.run` reproduce its logits bit for bit on every
backend (``tests/test_torch_cell.py`` on the CPU, ``chip_smoke.py`` on the
card).  On the CPU ``run`` calls the same callables in order.
"""

from __future__ import annotations

import torch

from repro_torch.dist import ctx
from repro_torch.models import kwt
from repro_torch.stream import engine as stream_engine
from repro_torch.stream import features
from repro_torch.stream import ring


def _tensors(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, torch.Tensor):
        yield tree


class HopPipeline:
    """The featurise/encode split of one engine's streaming plan.

    ``engine`` is a ``runtime.Engine`` or ``EngineHandle``; the callables
    take params as operands (``live_params()`` of the handle at the call),
    so a hot-swap between hops needs nothing else.
    """

    def __init__(self, engine, fcfg: features.FrontendConfig,
                 keep_features: bool = False):
        eng = engine.engine if hasattr(engine, "engine") else engine
        cfg = eng.exec_cfg
        assert cfg.family == "kwt", "hop pipelining drives the KWT family"
        self._eng_ref = engine
        self.cfg, self.fcfg = cfg, fcfg
        self.keep_features = keep_features
        self.device = eng.device
        self._side = None

    def side_stream(self) -> "torch.cuda.Stream":
        """The side stream featurise runs on, made once: the caching
        allocator keeps blocks per stream, so a new stream per run would
        allocate device memory anew."""
        if self._side is None:
            self._side = torch.cuda.Stream(self.device)
        return self._side

    # -- the two stages ------------------------------------------------------

    def featurise(self, params, state: dict, chunk: torch.Tensor):
        """(state, chunk [B, k*hop] on the device) -> (state, window)."""
        fe, frames = features.frontend_push(state["frontend"], chunk,
                                            self.fcfg)
        new = {"frontend": fe,
               "embed": ring.ring_push(
                   state["embed"], kwt.embed_frames(params, frames, self.cfg))}
        if "feat" in state:
            new["feat"] = ring.ring_push(state["feat"], frames)
        # the encoder consumes only the assembled window, a fresh tensor
        window = ctx.shard_activations(ring.ring_window(new["embed"]))
        return new, window

    def encode(self, params, window: torch.Tensor) -> torch.Tensor:
        """Assembled window [B, T, d] -> logits [B, n_classes]."""
        return kwt.encode_window(params, window, self.cfg)

    def _params(self):
        return self._eng_ref.live_params()

    def init_state(self, batch: int) -> dict:
        return stream_engine.init_stream_state(
            self.cfg, self.fcfg, batch, keep_features=self.keep_features,
            device=self.device)

    # -- synchronous reference ------------------------------------------------

    def step(self, state, chunk):
        """One hop through the split callables: (state, chunk) -> (state,
        logits), bit-identical to ``Engine.stream_step`` on the same chunk
        sequence."""
        p = self._params()
        with torch.inference_mode():
            state, window = self.featurise(
                p, state, torch.as_tensor(chunk).to(self.device))
            return state, self.encode(p, window)

    # -- pipelined loop ------------------------------------------------------

    def _stage(self, chunk) -> torch.Tensor:
        """A chunk on the device, copied from pinned host memory without
        blocking when it comes from the host."""
        if isinstance(chunk, torch.Tensor) and chunk.device == self.device:
            chunk.record_stream(torch.cuda.current_stream(self.device))
            return chunk
        host = torch.as_tensor(chunk)
        if host.device.type == "cpu":
            host = host.pin_memory()
        return host.to(self.device, non_blocking=True)

    def run(self, state, chunks):
        """Stream ``chunks`` with one-hop lookahead; yields ``(state_t,
        logits_t)`` per hop.  On the card, ``featurise`` t+1 is queued on
        a side stream right after ``encode`` t on the current one, with no
        host synchronisation; the yielded tensors are ready to use on the
        current stream (a consumer that reads them on the host waits for
        ``encode`` t, as it would anyway)."""
        p = self._params()
        infer = torch.inference_mode
        if self.device.type != "cuda":
            for chunk in chunks:
                with infer():
                    state, window = self.featurise(
                        p, state, torch.as_tensor(chunk).to(self.device))
                    logits = self.encode(p, window)
                yield state, logits
            return
        main = torch.cuda.current_stream(self.device)
        side = self.side_stream()
        it = iter(chunks)
        chunk = next(it, None)
        if chunk is None:
            return
        with infer():
            # everything queued so far on the current stream (the state,
            # chunks already on the card) before the side stream reads it
            side.wait_stream(main)
            for t in _tensors(state):       # the caller's, read on the side
                t.record_stream(side)
            with torch.cuda.stream(side):
                state, window = self.featurise(p, state, self._stage(chunk))
                ready = torch.cuda.Event()
                ready.record(side)
        while True:
            nxt = next(it, None)
            with infer():
                produced = None
                if isinstance(nxt, torch.Tensor) and nxt.is_cuda:
                    # a chunk made on the current stream after the wait above
                    produced = torch.cuda.Event()
                    produced.record(main)
                main.wait_event(ready)
                for t in _tensors(state):
                    t.record_stream(main)
                window.record_stream(main)
                logits = self.encode(p, window)
                if nxt is not None:
                    with torch.cuda.stream(side):
                        if produced is not None:
                            side.wait_event(produced)
                        nstate, nwindow = self.featurise(p, state,
                                                         self._stage(nxt))
                        ready = torch.cuda.Event()
                        ready.record(side)
            yield state, logits
            if nxt is None:
                return
            state, window = nstate, nwindow
