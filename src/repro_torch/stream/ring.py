"""Externalized ring-buffer state for streaming inference.

The kws_streaming external-state idiom, functionally: state is a plain
dict of tensors — ``{"buf", "pos", "count"}`` — and every operation is a
pure function ``(state, frames) -> state`` / ``state -> window`` that
returns new tensors and leaves its argument as it was, so a serving
slot's state can be kept, copied and restored like model parameters.

Layout: ``buf`` is ``[B, length, ...]`` with a *shared* 0-d write cursor
``pos`` (all lanes of a batched server advance hop-synchronously) and a
*per-lane* ``count`` [B] so freshly refilled slots can warm up
mid-stream.  ``window`` reads the last ``length`` entries out in
chronological order, oldest first.  ``pos`` stays a tensor on the
buffer's device: indices are built there, with no host sync per hop.
"""

from __future__ import annotations

import torch

from repro_torch.device import resolve_device


def ring_init(batch: int, length: int, feat_shape: tuple,
              dtype=torch.float32, device=None) -> dict:
    """Zeroed ring holding ``length`` feature vectors per lane
    (``device=None`` is the card)."""
    device = resolve_device(device)
    return {"buf": torch.zeros((batch, length) + tuple(feat_shape),
                               dtype=dtype, device=device),
            "pos": torch.zeros((), dtype=torch.int32, device=device),
            "count": torch.zeros((batch,), dtype=torch.int32, device=device)}


def ring_len(state: dict) -> int:
    return state["buf"].shape[1]


def _slots(state: dict, n: int) -> torch.Tensor:
    """Ring slots pos, pos+1, ..., pos+n-1 (mod length), on the device."""
    pos = state["pos"]
    return ((pos + torch.arange(n, device=pos.device, dtype=pos.dtype))
            % ring_len(state)).long()


def ring_push(state: dict, frames: torch.Tensor) -> dict:
    """Write ``frames`` [B, k, ...] at pos..pos+k-1 (mod length), advance.

    The scatter wraps around the end of the buffer without data movement
    (a true ring, not a shift buffer).
    """
    length = ring_len(state)
    k = frames.shape[1]
    if k > length:
        raise ValueError(
            f"push of {k} frames overruns the {length}-frame ring: the modulo "
            "scatter would write duplicate indices (unspecified winner)")
    buf = state["buf"].index_copy(1, _slots(state, k),
                                  frames.to(state["buf"].dtype))
    return {"buf": buf,
            "pos": (state["pos"] + k) % length,
            "count": torch.clamp(state["count"] + k, max=length)}


def ring_window(state: dict) -> torch.Tensor:
    """Chronological read-out [B, length, ...], oldest entry first.

    After a push, ``pos`` points at the oldest live entry (the next to be
    overwritten), so the window is the gather ``(pos + arange(L)) % L``.
    Lanes with ``count < length`` still contain init zeros in their oldest
    slots — gate on :func:`ring_warm` before trusting the window.
    """
    return state["buf"].index_select(1, _slots(state, ring_len(state)))


def ring_warm(state: dict) -> torch.Tensor:
    """[B] bool: lane has seen a full window of real frames."""
    return state["count"] >= ring_len(state)


def ring_reset_lane(state: dict, lane) -> dict:
    """Zero one lane's history (slot refill in the batched server): the
    shared cursor keeps advancing; the lane re-warms via its own count.
    ``lane`` is an int or an index tensor."""
    buf, count = state["buf"].clone(), state["count"].clone()
    buf[lane] = 0
    count[lane] = 0
    return {"buf": buf, "pos": state["pos"], "count": count}
