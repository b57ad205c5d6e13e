"""Keyword event streams: noise with chirp keywords at random positions.

A frozen copy of ``repro_torch.data.pipeline.keyword_event_stream`` (and
its chirp), so that a later change to the program's generator cannot
change the benchmark's audio; ``bench/tests/test_bench_traffic.py`` holds
the two equal at the commit that copied it.
"""

from __future__ import annotations

import numpy as np

f32 = np.float32
SAMPLE_RATE = 16_000


def keyword_chirp(n_samples: int, t0, amp,
                  sample_rate: int = SAMPLE_RATE) -> np.ndarray:
    """An amplitude-enveloped rising chirp (1 -> 3 kHz), float32."""
    t = (np.arange(n_samples, dtype=f32) - np.asarray(t0, f32)) \
        / f32(sample_rate)
    dur = n_samples / sample_rate
    f0, f1 = 1000.0, 3000.0
    phase = f32(2.0 * np.pi) * (f32(f0) * t
                                + f32(0.5 * (f1 - f0) / dur) * t * t)
    env = np.square(np.sin(f32(np.pi) * np.clip(t / f32(dur), f32(0.0),
                                                 f32(1.0))))
    return (np.asarray(amp, f32) * env * np.sin(phase)).astype(f32)


def keyword_event_stream(seed: int, stream_id: int, *, n_hops: int,
                         hop_len: int = 160, event_len_hops: int = 26,
                         mean_gap_hops: int = 60,
                         sample_rate: int = SAMPLE_RATE):
    """``(audio [n_hops * hop_len] float32, [(start_hop, end_hop), ...])``."""
    rng = np.random.RandomState((seed * 100_003 + stream_id) % (2**31 - 1))
    n = n_hops * hop_len
    audio = f32(0.12) * rng.randn(n).astype(f32)
    events, hop = [], int(rng.randint(10, mean_gap_hops))
    ev_len = event_len_hops * hop_len
    while hop + event_len_hops < n_hops:
        s = hop * hop_len
        audio[s:s + ev_len] += keyword_chirp(
            ev_len, 0.0, 0.5 + 0.2 * rng.rand(), sample_rate)
        events.append((hop, hop + event_len_hops))
        hop += event_len_hops + int(rng.randint(mean_gap_hops // 2,
                                                2 * mean_gap_hops))
    return audio, events
