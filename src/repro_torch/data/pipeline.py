"""Deterministic, restart-exact data: the reference's surrogates, its bits.

Every batch is *stateless-seeded*: batch(step) is a pure function of
``(seed, step)`` — the key ``fold_in(PRNGKey(seed), step)`` — so a
restarted job resumes mid-epoch exactly (no iterator state in
checkpoints).  The keys and the random bits are the reference's
(``repro.data.pipeline`` draws from ``jax.random``): ``data.prng`` is a
numpy twin of JAX's default PRNG, so labels and uniforms equal the
reference's bit for bit, and normals and the float32 arithmetic on them
agree within the tolerances ``tests/test_torch_data.py`` states.

1. ``keyword_batch``       — synthetic GSC-style MFCC keyword data for KWT
   ("dog"/"notdog", paper §III).
2. ``keyword_audio_batch`` — the same task one level earlier in the signal
   chain: raw audio that ``stream.features.mfcc`` featurises.
3. ``keyword_event_stream`` — an unbounded-stream surrogate for the
   serving cell: noise with keyword chirps at random positions (numpy
   ``RandomState``, as the reference: positions are exact).

Batches are made on the host, in float32, and returned as CPU tensors;
the train step moves them to the parameters' device.  The LM token stream
waits for the LM families (ROADMAP queue A item 3).
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.data import prng

f32 = np.float32


def _keys(seed: int, step: int, n: int = 4) -> np.ndarray:
    return prng.split(prng.fold_in(prng.PRNGKey(seed), step), n)


def keyword_batch(seed: int, step: int, *, batch: int, input_dim=(16, 26),
                  n_classes: int = 2) -> dict:
    """Class-conditional MFCC-like features: ``{"mfcc": [B, F, T] float32,
    "labels": [B] int64}``.

    Class c gets a characteristic ridge at frequency band f_c with a
    class-specific temporal chirp, plus i.i.d. noise — enough structure
    that KWT-Tiny separates classes within a few hundred steps, mirroring
    the paper's "dog"/"notdog" setup.

    ``n_classes > 2`` is the GSC-35-style *fine-grained* surrogate: class
    c is a variant of binary class ``c % 2`` — the same primary ridge, plus
    a variant-specific secondary ridge (classes 0/1 carry none, so they
    coincide exactly with the binary task's two classes).  A model trained
    on the 35-class task therefore transfers to the binary deployment by
    grouping columns (``qat.distill.reduce_head``).
    """
    f, t = input_dim
    k1, k2, k3, k4 = _keys(seed, step)
    labels = prng.randint(k1, (batch,), 0, n_classes)
    noise = prng.normal(k2, (batch, f, t))
    freqs = np.arange(f, dtype=f32)[None, :, None]
    times = np.arange(t, dtype=f32)[None, None, :]
    # overlapping class centres + per-sample jitter: hard enough that the
    # float model lands ~0.9 and the quantisation staircase is visible
    jitter = prng.normal(k4, (batch, 1, 1)) * f32(2.0)
    coarse = (labels % 2)[:, None, None].astype(f32)
    centre = f32(f / 2.0) + jitter + (coarse - f32(0.5)) * f32(2.5)
    chirp = centre + (coarse - f32(0.5)) * times / f32(t) * f32(3.0)
    ridge = np.exp(f32(-0.5) * np.square(freqs - chirp))
    if n_classes > 2:
        variant = (labels // 2)[:, None, None].astype(f32)
        vfreq = np.mod(f32(1.3) + (variant - f32(1.0)) * f32(1.9), f32(f))
        ridge = ridge + np.where(
            variant > 0,
            f32(0.7) * np.exp(f32(-0.5) * np.square(freqs - vfreq)), f32(0.0))
    amp = f32(1.1) + f32(0.3) * prng.normal(k3, (batch, 1, 1))
    mfcc = (amp * ridge + noise).astype(f32)
    return {"mfcc": torch.from_numpy(mfcc),
            "labels": torch.from_numpy(labels.astype(np.int64))}


def gsc_eval_set(seed: int, *, n: int, input_dim=(16, 26), n_classes: int = 2,
                 batch: int = 64) -> list:
    """Fixed eval batches (deterministic, disjoint fold from training)."""
    return [keyword_batch(seed + 10_000, i, batch=batch, input_dim=input_dim,
                          n_classes=n_classes)
            for i in range(int(np.ceil(n / batch)))]


# ---------------------------------------------------------------------------
# Raw-audio surrogates for the streaming subsystem: the same
# stateless-seeded contract, one level earlier in the signal chain — the
# waveform the MFCC frontend (stream/features.py) consumes.
# ---------------------------------------------------------------------------

SAMPLE_RATE = 16_000


def _keyword_chirp(n_samples: int, t0, amp,
                   sample_rate: int = SAMPLE_RATE) -> np.ndarray:
    """The synthetic "dog" sound: an amplitude-enveloped rising chirp
    (1->3 kHz), broad-band enough to light up several mel bands.

    ``t0`` and ``amp`` are scalars or ``[B, 1]`` arrays (one chirp per
    row); float32 throughout, in the reference's order of operations."""
    t = (np.arange(n_samples, dtype=f32) - np.asarray(t0, f32)) \
        / f32(sample_rate)
    dur = n_samples / sample_rate
    f0, f1 = 1000.0, 3000.0
    phase = f32(2.0 * np.pi) * (f32(f0) * t
                                + f32(0.5 * (f1 - f0) / dur) * t * t)
    env = np.square(np.sin(f32(np.pi) * np.clip(t / f32(dur), f32(0.0),
                                                 f32(1.0))))
    return (np.asarray(amp, f32) * env * np.sin(phase)).astype(f32)


def keyword_audio_batch(seed: int, step: int, *, batch: int,
                        n_samples: int, n_classes: int = 2,
                        sample_rate: int = SAMPLE_RATE) -> dict:
    """Class-conditional raw audio: label 1 carries the chirp keyword over
    noise, label 0 is noise alone: ``{"audio": [B, n_samples] float32,
    "labels": [B] int64}``.  Featurised by ``stream.features.mfcc`` this
    trains KWT end to end from the waveform (paper §III, with audio
    standing in for the GSC recordings)."""
    k1, k2, k3, k4 = _keys(seed, step)
    labels = prng.randint(k1, (batch,), 0, n_classes)
    noise = f32(0.12) * prng.normal(k2, (batch, n_samples))
    amp = f32(0.5) + f32(0.2) * prng.uniform(k3, (batch, 1))
    jitter = prng.uniform(k4, (batch, 1)) * f32(0.2) * f32(n_samples)
    chirp = _keyword_chirp(n_samples, jitter, amp, sample_rate)
    audio = noise + np.where((labels > 0)[:, None], chirp, f32(0.0))
    return {"audio": torch.from_numpy(audio.astype(f32)),
            "labels": torch.from_numpy(labels.astype(np.int64))}


def keyword_event_stream(seed: int, stream_id: int, *, n_hops: int,
                         hop_len: int = 160, event_len_hops: int = 26,
                         mean_gap_hops: int = 60,
                         sample_rate: int = SAMPLE_RATE):
    """``n_hops * hop_len`` samples of noise with keyword chirps at random
    positions.  Host-side numpy (this feeds the serving loop).

    Returns ``(audio [n_hops*hop_len] f32, events)`` where ``events`` is a
    list of (start_hop, end_hop) ground-truth keyword intervals.
    """
    rng = np.random.RandomState((seed * 100_003 + stream_id) % (2**31 - 1))
    n = n_hops * hop_len
    audio = f32(0.12) * rng.randn(n).astype(f32)
    events, hop = [], int(rng.randint(10, mean_gap_hops))
    ev_len = event_len_hops * hop_len
    while hop + event_len_hops < n_hops:
        s = hop * hop_len
        audio[s:s + ev_len] += _keyword_chirp(
            ev_len, 0.0, 0.5 + 0.2 * rng.rand(), sample_rate)
        events.append((hop, hop + event_len_hops))
        hop += event_len_hops + int(rng.randint(mean_gap_hops // 2,
                                                2 * mean_gap_hops))
    return audio, events
