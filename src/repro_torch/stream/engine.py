"""Incremental KWT inference over a hop-synchronous stream.

Per hop, only the newly arrived time-patches are embedded
(``models.kwt.embed_frames`` on [B, k, F]) and pushed into a ring of
cached patch embeddings; the encoder (``models.kwt.encode_window``) then
runs on the assembled [B, T, d] window.  The patch embedding contracts
over F independently per frame, so the assembled window equals embedding
the whole window at once, and the streaming logits equal the offline
``models.kwt.forward`` on the same window to the bit — in the float path
and in every LUT / kernel path.  Callers pass a ``repro_torch.runtime``
Engine's ``exec_cfg`` / ``params`` (or drive ``Engine.stream_step``
directly), so PTQ and mode selection happen once at plan time.

State is one dict of tensors (frontend tail + feature ring + embedding
ring): ``stream_step`` is pure ``(params, state, chunk) -> (state,
logits)``.  The assembled window passes ``dist.ctx.shard_activations``
as in the reference (the packed multi-stream batch over the DP axes on
a mesh; a no-op off one).

Under an active ``telemetry`` tracer a hop records ``frontend`` (the MFCC
frontend), ``embed`` (the new frames' patch embedding and the ring
pushes) and ``encoder`` (the assembled window through the encoder), from
``stream_step`` and ``stream_step_frames`` alike.
"""

from __future__ import annotations

import torch

from repro_torch.device import resolve_device
from repro_torch.dist import ctx
from repro_torch.models import kwt
from repro_torch.stream import features
from repro_torch.stream import ring
from repro_torch.telemetry import trace as _trace


def window_frames(cfg) -> int:
    """The model's receptive field in frames (T of input_dim [F, T])."""
    return cfg.input_dim[1]


def init_stream_state(cfg, fcfg: features.FrontendConfig, batch: int,
                      keep_features: bool = True, device=None) -> dict:
    """Fresh streaming state for ``batch`` hop-synchronous streams on
    ``device`` (``None`` is the card, and raises where there is none).

    The embed ring caches per-frame patch embeddings so each hop re-embeds
    only its new frames.  ``keep_features`` additionally keeps the raw MFCC
    history ring (offline-parity oracles, calibration taps); production
    servers pass False to drop that scatter + state from the hot path.
    """
    device = resolve_device(device)
    t, f = window_frames(cfg), cfg.input_dim[0]
    state = {"frontend": features.frontend_init(fcfg, batch, device),
             "embed": ring.ring_init(batch, t, (cfg.d_model,),
                                     getattr(torch, cfg.dtype), device)}
    if keep_features:
        state["feat"] = ring.ring_init(batch, t, (f,), torch.float32, device)
    return state


def _advance(params, state: dict, fe: dict, frames: torch.Tensor,
             cfg) -> tuple[dict, torch.Tensor]:
    new = {"frontend": fe}
    with _trace.span("embed"):
        if "feat" in state:
            new["feat"] = ring.ring_push(state["feat"], frames)
        emb = ring.ring_push(state["embed"],
                             kwt.embed_frames(params, frames, cfg))
        new["embed"] = emb
    # The reference puts an optimization_barrier here so that XLA cannot
    # fuse the hop-sized producers into the encoder and make its rounding
    # depend on the chunk size.  Eager PyTorch fuses nothing across calls:
    # the encoder sees the assembled [B, T, d] window as offline does.
    with _trace.span("encoder"):
        window = ctx.shard_activations(ring.ring_window(emb))
        logits = kwt.encode_window(params, window, cfg)
    return new, logits


def stream_step(params, state: dict, chunk: torch.Tensor, cfg,
                fcfg: features.FrontendConfig) -> tuple[dict, torch.Tensor]:
    """Advance every stream by ``chunk`` [B, k*hop_len] samples.

    Returns ``(state, logits [B, n_classes])``.  Logits are valid once
    :func:`warm` is True for the lane (a full receptive field of real
    frames); before that the window still contains init zeros.
    """
    with _trace.span("frontend"):
        fe, frames = features.frontend_push(state["frontend"], chunk, fcfg)
    return _advance(params, state, fe, frames, cfg)


def stream_step_frames(params, state: dict, frames: torch.Tensor,
                       cfg) -> tuple[dict, torch.Tensor]:
    """Advance every stream by ``frames`` [B, k, F] pre-featurised MFCC
    frames — the edge-featurised ingest path.

    ``stream_step`` minus the frontend: feeding it the frames that
    ``features.frontend_push`` produces for a chunk yields the same logits
    and state as ``stream_step`` on that chunk (the frontend tail is
    carried, untouched, so the two paths stay interchangeable per lane).
    """
    return _advance(params, state, state["frontend"], frames, cfg)


def warm(state: dict) -> torch.Tensor:
    """[B] bool: lane's window is fully populated with real frames."""
    return ring.ring_warm(state["embed"])


def window_mfcc(state: dict) -> torch.Tensor:
    """The current feature window as an offline batch [B, F, T] — feeding
    this to ``models.kwt.forward`` reproduces ``stream_step``'s logits
    bit-for-bit (the equivalence tests' oracle)."""
    return ring.ring_window(state["feat"]).transpose(1, 2)


def reset_lane(state: dict, lane) -> dict:
    """Zero one stream's history (server slot refill): frontend tail,
    feature/embedding rings and warm-up count all restart for that lane."""
    tail = state["frontend"]["tail"].clone()
    tail[lane] = 0.0
    new = {"frontend": {"tail": tail},
           "embed": ring.ring_reset_lane(state["embed"], lane)}
    if "feat" in state:
        new["feat"] = ring.ring_reset_lane(state["feat"], lane)
    return new


def posteriors(logits: torch.Tensor) -> torch.Tensor:
    """Per-hop class posteriors for the detector (f32 softmax on the f32
    logits both quantised and float paths emit)."""
    return torch.softmax(logits.to(torch.float32), dim=-1)
