"""Plain reference of one always-on keyword stream: raw audio to the
detector's smoothed score, step by step.

The frontend (16 kHz, 25 ms Hann frames every 10 ms, a 512-point power
spectrum, an HTK mel filterbank of ``n_mels`` bands from 20 Hz to
7.6 kHz, the log floored at 1e-6, an orthonormal DCT-II), with the
stream left-padded by ``frame_len - hop_len`` zero samples.  Each step
feeds ``chunk_hops`` hops; the model sees the last ``T`` frames' patch
embeddings, with zero embeddings where the stream has fewer frames (a
lane's ring starts empty at its join).  The keyword posterior is the
softmax of the logits at ``keyword_class``, and the score the mean of the
posteriors of the last ``smooth_hops`` steps (as many as there are).

The detector's events (``detector_events``): a lane fires at a step when
its window has held ``T`` real frames for ``smooth_hops`` steps running,
it is not latched, its refractory count has run out and the score reaches
``on_threshold``; a fire latches it until the score falls to
``off_threshold`` or below, and starts ``refractory_hops`` steps in which
it cannot fire.  A join clears all of it.
"""

from __future__ import annotations

import numpy as np
import torch

from bench.ref import kwt


def _hz_to_mel(f):
    return 2595.0 * np.log10(1.0 + np.asarray(f) / 700.0)


def _mel_to_hz(m):
    return 700.0 * (10.0 ** (np.asarray(m) / 2595.0) - 1.0)


def mel_filterbank(fe: dict) -> np.ndarray:
    n_bins = fe["n_fft"] // 2 + 1
    freqs = np.linspace(0.0, fe["sample_rate"] / 2.0, n_bins)
    mels = np.linspace(_hz_to_mel(fe["fmin"]), _hz_to_mel(fe["fmax"]),
                       fe["n_mels"] + 2)
    edges = _mel_to_hz(mels)
    fb = np.zeros((n_bins, fe["n_mels"]), np.float32)
    for m in range(fe["n_mels"]):
        lo, c, hi = edges[m], edges[m + 1], edges[m + 2]
        up = (freqs - lo) / max(c - lo, 1e-9)
        down = (hi - freqs) / max(hi - c, 1e-9)
        fb[:, m] = np.maximum(0.0, np.minimum(up, down))
    return fb


def dct_matrix(n_mels: int, n_mfcc: int) -> np.ndarray:
    n = np.arange(n_mels)[:, None]
    k = np.arange(n_mfcc)[None, :]
    d = np.cos(np.pi * (2 * n + 1) * k / (2 * n_mels)) * np.sqrt(2.0 / n_mels)
    d[:, 0] *= np.sqrt(0.5)
    return d.astype(np.float32)


def mfcc_frames(audio: torch.Tensor, fe: dict) -> torch.Tensor:
    """audio [..., n] (whole hops) -> frames [..., n // hop_len, n_mfcc]."""
    dev = audio.device
    ctx = fe["frame_len"] - fe["hop_len"]
    x = torch.cat([audio.new_zeros(*audio.shape[:-1], ctx), audio.float()], -1)
    frames = x.unfold(-1, fe["frame_len"], fe["hop_len"])
    win = torch.from_numpy(np.hanning(fe["frame_len"]).astype(np.float32))
    spec = torch.fft.rfft(frames * win.to(dev), n=fe["n_fft"], dim=-1)
    power = spec.real.square() + spec.imag.square()
    fb = torch.from_numpy(mel_filterbank(fe)).to(dev)
    dct = torch.from_numpy(dct_matrix(fe["n_mels"], fe["n_mfcc"])).to(dev)
    return torch.log(torch.clamp(power @ fb, min=fe["log_floor"])) @ dct


def lane_scores(w: dict, audio: torch.Tensor, steps: torch.Tensor,
                model: dict, fe: dict, det: dict, chunk_hops: int,
                x_exp: int, rows: int = 4096) -> torch.Tensor:
    """The score of each lane after its ``steps[i]``-th step since its
    stream joined (counted from 1): ``audio`` [lanes, n] holds each
    lane's samples as fed, zeros past its last step."""
    t, k = model["input_dim"][1], det["smooth_hops"]
    lanes = audio.shape[0]
    emb = embed_lanes(w, audio, fe, x_exp)                      # [L, F, d]
    pad = torch.cat([emb.new_zeros(lanes, t, emb.shape[-1]), emb], 1)
    j = steps[:, None].to(emb.device) - torch.arange(k, device=emb.device)
    valid = j >= 1                                              # [L, k]
    ends = j.clamp(min=1) * chunk_hops + t
    idx = ends[..., None] - t + torch.arange(t, device=emb.device)
    lane = torch.arange(lanes, device=emb.device)[:, None, None]
    win = pad[lane, idx].reshape(lanes * k, t, -1)              # [L k, T, d]
    post = torch.cat([
        torch.softmax(kwt.encode(w, b, model, x_exp), -1)[:, det["keyword_class"]]
        for b in win.split(rows)]).reshape(lanes, k)
    post = torch.where(valid, post, 0.0)
    return post.sum(1) / valid.sum(1)


def embed_lanes(w: dict, audio: torch.Tensor, fe: dict, x_exp: int,
                lanes_a_block: int = 128) -> torch.Tensor:
    """Patch embeddings of every frame of every lane, a block of lanes at
    a time (the spectra of 2048 long streams at once would not fit)."""
    return torch.cat([kwt.embed(w, mfcc_frames(a, fe), x_exp)
                      for a in audio.split(lanes_a_block)])


def detector_events(scores: np.ndarray, streams: np.ndarray, det: dict,
                    t: int, chunk_hops: int) -> np.ndarray:
    """The fires [steps, lanes] of the detector on ``scores`` [steps,
    lanes], the smoothed score of every lane at every step; ``streams``
    [steps, lanes] names the stream each lane held at each step (a new
    name: the lane joined before that step)."""
    lanes = scores.shape[1]
    active = np.zeros(lanes, bool)
    cooldown = np.zeros(lanes, np.int64)
    warm_steps = np.zeros(lanes, np.int64)
    since = np.zeros(lanes, np.int64)
    prev = np.full(lanes, -1, np.int64)
    fired = np.zeros(scores.shape, bool)
    for j, (s, ids) in enumerate(zip(scores, streams)):
        new = ids != prev
        prev = ids
        active[new] = False
        cooldown[new] = 0
        warm_steps[new] = 0
        since[new] = 0
        since += 1
        warm = since * chunk_hops >= t
        warm_steps = np.where(warm, warm_steps + 1, 0)
        cooldown = np.maximum(cooldown - 1, 0)
        f = ((warm_steps >= det["smooth_hops"]) & ~active & (cooldown == 0)
             & (s >= det["on_threshold"]))
        active = f | (active & (s > det["off_threshold"]))
        cooldown = np.where(f, det["refractory_hops"], cooldown)
        fired[j] = f
    return fired
