"""Deterministic, restart-exact data for KWT training.

``keyword_batch`` is *stateless-seeded*: batch(step) is a pure function of
``(seed, step)`` — a ``numpy.random.default_rng`` seeded from the pair —
so a restarted job resumes mid-epoch exactly (no iterator state in
checkpoints).  The formulas are the reference's (``repro.data.pipeline``);
the random bits are numpy's, not ``jax.random``'s, so a batch of the port
is not the reference's batch of the same ``(seed, step)``.  Parity tests
feed both packages the same numpy arrays instead.

The batch is made on the host, in float32, and returned as CPU tensors;
the train step moves it to the parameters' device.  The LM token stream
and the raw-audio surrogates wait for their slices (ROADMAP queue A items
7 and 8).
"""

from __future__ import annotations

import numpy as np
import torch


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
    f32 = np.float32
    rng = np.random.default_rng([seed, step])
    labels = rng.integers(0, n_classes, batch)
    noise = rng.standard_normal((batch, f, t), dtype=f32)
    jitter = rng.standard_normal((batch, 1, 1), dtype=f32) * f32(2.0)
    amp = f32(1.1) + f32(0.3) * rng.standard_normal((batch, 1, 1), dtype=f32)
    freqs = np.arange(f, dtype=f32)[None, :, None]
    times = np.arange(t, dtype=f32)[None, None, :]
    # overlapping class centres + per-sample jitter: hard enough that the
    # float model lands ~0.9 and the quantisation staircase is visible
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
    mfcc = (amp * ridge + noise).astype(f32)
    return {"mfcc": torch.from_numpy(mfcc),
            "labels": torch.from_numpy(labels.astype(np.int64))}


def gsc_eval_set(seed: int, *, n: int, input_dim=(16, 26), n_classes: int = 2,
                 batch: int = 64) -> list:
    """Fixed eval batches (deterministic, disjoint fold from training)."""
    return [keyword_batch(seed + 10_000, i, batch=batch, input_dim=input_dim,
                          n_classes=n_classes)
            for i in range(int(np.ceil(n / batch)))]
