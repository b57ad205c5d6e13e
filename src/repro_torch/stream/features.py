"""Streaming log-mel/MFCC frontend: framing -> FFT -> mel -> DCT.

Maps raw waveforms to the ``[B, n_mfcc, T]`` tensors
``models.kwt.forward`` consumes, in two equivalent forms:

  * :func:`mfcc` — whole-utterance (offline) featurisation;
  * :func:`frontend_init` / :func:`frontend_push` — hop-at-a-time
    incremental featurisation with externalized state, the streaming
    form: ``(state, chunk) -> (state, frames)``.

Equivalence contract: a stream is treated as left-padded with
``frame_len - hop_len`` zeros, so hop ``t`` (both paths) featurises
samples ``[t*hop - (frame_len - hop), t*hop + hop)`` of the unpadded
signal and every ``hop_len`` new samples yield exactly one new frame.
Both paths run the same per-frame math (Hann window, ``|rfft|^2``, mel
matmul, ``log``, orthonormal DCT-II) through :func:`_frame_features`.

A frame's features do not depend on how many other frames share the call
(``core.rowwise``): on the CPU the FFT batches over frames (pocketfft
transforms each row alike) and the mel and DCT products are one product
per frame; on the card cuFFT and cuBLAS pick their algorithm by the shape
of the call, so the FFT and both products run on blocks of a fixed
number of frames (``rowwise.by_row_blocks``).  Streaming frames equal
offline frames to the bit on either device
(``tests/test_torch_stream.py``; ``chip_smoke.py`` on the card).
"""

from __future__ import annotations

import dataclasses
from functools import lru_cache

import numpy as np
import torch

from repro_torch.core.rowwise import by_row_blocks, rowwise_matmul
from repro_torch.device import resolve_device


@dataclasses.dataclass(frozen=True)
class FrontendConfig:
    """Frontend hyperparameters (defaults: 16 kHz, 25 ms frames, 10 ms hop,
    16 MFCC coefficients — the paper's F=16 feature dim)."""

    sample_rate: int = 16_000
    frame_len: int = 400          # 25 ms analysis window
    hop_len: int = 160            # 10 ms hop -> one frame per hop
    n_fft: int = 512
    n_mels: int = 40
    n_mfcc: int = 16              # == cfg.input_dim[0] for KWT
    fmin: float = 20.0
    fmax: float = 7_600.0
    log_floor: float = 1e-6

    @property
    def context_len(self) -> int:
        """Samples of left context carried between hops."""
        return self.frame_len - self.hop_len

    def receptive_field(self, t_frames: int) -> int:
        """Samples covered by a ``t_frames`` model window:
        frame_len + (t_frames - 1) * hop_len."""
        return self.frame_len + (t_frames - 1) * self.hop_len


def _hz_to_mel(f):
    return 2595.0 * np.log10(1.0 + np.asarray(f) / 700.0)


def _mel_to_hz(m):
    return 700.0 * (10.0 ** (np.asarray(m) / 2595.0) - 1.0)


def mel_filterbank(fcfg: FrontendConfig) -> np.ndarray:
    """Triangular mel filterbank [n_fft//2 + 1, n_mels] (HTK-style mel)."""
    n_bins = fcfg.n_fft // 2 + 1
    freqs = np.linspace(0.0, fcfg.sample_rate / 2.0, n_bins)
    mels = np.linspace(_hz_to_mel(fcfg.fmin), _hz_to_mel(fcfg.fmax),
                       fcfg.n_mels + 2)
    edges = _mel_to_hz(mels)                       # [n_mels + 2]
    fb = np.zeros((n_bins, fcfg.n_mels), np.float32)
    for m in range(fcfg.n_mels):
        lo, c, hi = edges[m], edges[m + 1], edges[m + 2]
        up = (freqs - lo) / max(c - lo, 1e-9)
        down = (hi - freqs) / max(hi - c, 1e-9)
        fb[:, m] = np.maximum(0.0, np.minimum(up, down))
    return fb


def dct_matrix(n_mels: int, n_mfcc: int) -> np.ndarray:
    """Orthonormal DCT-II [n_mels, n_mfcc]."""
    n = np.arange(n_mels)[:, None]
    k = np.arange(n_mfcc)[None, :]
    d = np.cos(np.pi * (2 * n + 1) * k / (2 * n_mels)) \
        * np.sqrt(2.0 / n_mels)
    d[:, 0] *= np.sqrt(0.5)
    return d.astype(np.float32)


@lru_cache(maxsize=None)
def _constants(fcfg: FrontendConfig, device: torch.device) -> tuple:
    """(Hann window, mel filterbank, DCT matrix) as float32 tensors on
    ``device``, built once per config and device."""
    win = np.hanning(fcfg.frame_len).astype(np.float32)
    return tuple(torch.from_numpy(a).to(device) for a in (
        win, mel_filterbank(fcfg), dct_matrix(fcfg.n_mels, fcfg.n_mfcc)))


def _frame_features(frames: torch.Tensor, fcfg: FrontendConfig) -> torch.Tensor:
    """Per-frame MFCC math on framed audio [B, t, frame_len] -> [B, t, n_mfcc].

    The single shared realisation of the frame pipeline: the offline and
    the streaming path both call exactly this function.
    """
    win, fb, dct = _constants(fcfg, frames.device)
    x = frames.to(torch.float32) * win
    spec = _per_frame(x, lambda b: torch.fft.rfft(b, n=fcfg.n_fft, dim=-1))
    power = spec.real.square() + spec.imag.square()
    mel = _per_frame(power, lambda b: rowwise_matmul(b, fb))
    logmel = torch.log(torch.clamp(mel, min=fcfg.log_floor))
    return _per_frame(logmel, lambda b: rowwise_matmul(b, dct))


def _per_frame(x: torch.Tensor, fn) -> torch.Tensor:
    """``fn(x)`` for frames ``x`` [..., K], each frame's result independent
    of the others: on the CPU in one call (pocketfft transforms each row
    alike; ``rowwise_matmul`` takes one product per row), on the card in
    calls of ``CARD_ROWS`` frames (``core.rowwise.by_row_blocks``)."""
    if x.device.type == "cpu":
        return fn(x)
    out = by_row_blocks(x.reshape(-1, x.shape[-1]), fn)
    return out.reshape(*x.shape[:-1], out.shape[-1])


def _frame(audio: torch.Tensor, fcfg: FrontendConfig) -> torch.Tensor:
    """[B, ctx + k*hop] samples -> [B, k, frame_len] overlapping frames
    (a strided view, no copy)."""
    return audio.unfold(-1, fcfg.frame_len, fcfg.hop_len)


def mfcc(audio: torch.Tensor, fcfg: FrontendConfig) -> torch.Tensor:
    """Offline featurisation: audio [B, n] (n % hop == 0) -> [B, n_mfcc, T]
    with T = n // hop_len (left zero-padded by ``context_len`` samples)."""
    audio = torch.as_tensor(audio)
    if audio.ndim == 1:
        audio = audio[None]
    if audio.shape[-1] % fcfg.hop_len:
        raise ValueError("offline mfcc expects whole hops (pad the tail)")
    pad = audio.new_zeros(audio.shape[:-1] + (fcfg.context_len,))
    feats = _frame_features(_frame(torch.cat([pad, audio], -1), fcfg), fcfg)
    return feats.transpose(-1, -2)                # [B, n_mfcc, T]


# ---------------------------------------------------------------------------
# Streaming form: externalized state, (state, chunk) -> (state, frames)
# ---------------------------------------------------------------------------

def frontend_init(fcfg: FrontendConfig, batch: int, device=None) -> dict:
    """Fresh frontend state: the ``context_len``-sample tail of the stream
    (zeros == the offline left padding).  ``device=None`` is the card."""
    return {"tail": torch.zeros((batch, fcfg.context_len), dtype=torch.float32,
                                device=resolve_device(device))}


def frontend_push(state: dict, chunk: torch.Tensor,
                  fcfg: FrontendConfig) -> tuple[dict, torch.Tensor]:
    """Featurise ``chunk`` [B, k*hop_len] -> (new_state, frames [B, k, n_mfcc]).

    Pure function of (state, chunk): feeding the same stream in any chunking
    (all sizes that are whole hops) yields the same frames.
    """
    if chunk.ndim != 2 or chunk.shape[-1] % fcfg.hop_len:
        raise ValueError(f"chunks must be [B, k * hop_len], got "
                         f"{tuple(chunk.shape)} with hop_len {fcfg.hop_len}")
    buf = torch.cat([state["tail"], chunk.to(torch.float32)], -1)
    frames = _frame_features(_frame(buf, fcfg), fcfg)
    return {"tail": buf[:, -fcfg.context_len:]}, frames
