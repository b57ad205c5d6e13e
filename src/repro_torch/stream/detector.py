"""Keyword event triggering: posterior smoothing + hysteresis + refractory.

Converts the per-hop posteriors of ``engine.stream_step`` into discrete
keyword events.  Standard streaming-KWS posterior handling: a moving
average over the last ``smooth_hops`` hops suppresses single-hop spikes;
a two-threshold hysteresis (fire at ``on_threshold``, release below
``off_threshold``) stops one keyword utterance firing once per hop; a
refractory period bounds the event rate even across releases.

Everything is a pure function of dicts of tensors, batched over lanes.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.device import resolve_device
from repro_torch.stream import ring


@dataclasses.dataclass(frozen=True)
class DetectorConfig:
    keyword_class: int = 1        # index of the "dog" class (paper §III)
    smooth_hops: int = 5          # posterior moving-average window
    on_threshold: float = 0.75    # fire when smoothed posterior crosses up
    off_threshold: float = 0.5    # release (re-arm) when it falls below
    refractory_hops: int = 20     # min hops between fires, even if released


def detector_init(dcfg: DetectorConfig, batch: int, device=None) -> dict:
    """Fresh detector state for ``batch`` lanes (``device=None``: the card)."""
    device = resolve_device(device)
    return {"hist": ring.ring_init(batch, dcfg.smooth_hops, (), device=device),
            "active": torch.zeros((batch,), dtype=torch.bool, device=device),
            "cooldown": torch.zeros((batch,), dtype=torch.int32, device=device),
            "warm_hops": torch.zeros((batch,), dtype=torch.int32, device=device),
            "hop": torch.zeros((), dtype=torch.int32, device=device)}


def detector_step(state: dict, probs: torch.Tensor, dcfg: DetectorConfig,
                  warm=None) -> tuple[dict, dict]:
    """One hop: ``probs`` [B, n_classes] -> (state, events).

    ``events = {"fired": [B] bool, "score": [B] smoothed posterior,
    "hop": 0-d hop index}``.  ``warm`` gates lanes whose engine window
    is still filling (their logits describe zero-padded audio).

    Hysteresis semantics: a fire sets ``active``; the lane cannot fire
    again until the smoothed posterior *releases* below ``off_threshold``
    AND the refractory countdown has expired.
    """
    hist = ring.ring_push(state["hist"],
                          probs[:, dcfg.keyword_class][:, None])
    # mean over the hops actually seen (count < smooth_hops during warm-up;
    # unwritten slots hold zeros and are excluded by dividing by count)
    smoothed = hist["buf"].sum(dim=1) \
        / torch.clamp(hist["count"].to(torch.float32), min=1.0)
    # a lane may only fire after smooth_hops consecutive *warm* hops: the
    # history ring also collects posteriors of still-padded windows, and
    # those must age out before the average is trusted
    is_warm = torch.ones_like(state["active"]) if warm is None else warm
    warm_hops = torch.where(is_warm, state["warm_hops"] + 1, 0)
    ready = warm_hops >= dcfg.smooth_hops
    cooldown = torch.clamp(state["cooldown"] - 1, min=0)
    fired = (ready & ~state["active"] & (cooldown == 0)
             & (smoothed >= dcfg.on_threshold))
    active = fired | (state["active"] & (smoothed > dcfg.off_threshold))
    cooldown = torch.where(fired, dcfg.refractory_hops, cooldown)
    hop = state["hop"] + 1
    new = {"hist": hist, "active": active, "cooldown": cooldown,
           "warm_hops": warm_hops, "hop": hop}
    return new, {"fired": fired, "score": smoothed, "hop": hop}


def detector_reset_lane(state: dict, lane) -> dict:
    """Re-arm lane(s) on evict/join: the recycled-lane contract.

    A detector lane carries memory — the posterior history ring, the
    hysteresis latch (``active``), the refractory countdown and the
    warm-up count.  All of it belongs to the stream, not the slot: a
    server that recycles a lane without this reset hands the next stream
    the previous one's state (a live refractory countdown suppresses its
    early keyword; a latched hysteresis never fires).  ``lane`` may be an
    int or an index tensor (one batched reset for a multi-lane join).
    """
    out = {"hist": ring.ring_reset_lane(state["hist"], lane),
           "hop": state["hop"]}
    for name, value in (("active", False), ("cooldown", 0), ("warm_hops", 0)):
        t = state[name].clone()
        t[lane] = value
        out[name] = t
    return out


def event_time_s(hop, fcfg) -> float:
    """Hop index -> stream timestamp in seconds (end of the hop)."""
    return float(hop) * fcfg.hop_len / fcfg.sample_rate
