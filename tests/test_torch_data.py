"""repro_torch.data against repro.data: the same (seed, step), the same data.

``repro_torch.data.prng`` is a numpy twin of JAX's default PRNG
(threefry2x32, ``jax_threefry_partitionable`` on, as in jax 0.9.0), and
the port's data pipelines draw from it.  Terms, with the errors measured
behind them (this file's seeds, numpy/PyTorch CPU vs XLA:CPU):

* exact: ``PRNGKey``, ``fold_in``, ``split``, the 32-bit ``bits``,
  ``uniform`` and ``randint`` (hypothesis sweep of seeds and steps); the
  labels of ``keyword_batch``, ``gsc_eval_set`` and
  ``keyword_audio_batch``; the event positions of ``keyword_event_stream``;
* ``normal``: ``NORMAL_RTOL`` 1e-5 with ``NORMAL_ATOL`` 1e-6 — the
  uniforms under it are exact, but ``erfinv`` is ``torch.erfinv`` in
  float32 where XLA evaluates its own polynomial (measured 5.8e-6
  relative, 2.2e-5 absolute on values near 5; 41 % of values bit-equal);
* ``keyword_batch`` mfcc: ``MFCC_ATOL`` 5e-5 (measured 2.1e-5: the noise
  is a normal);
* ``keyword_audio_batch`` audio: ``AUDIO_ATOL`` 1e-5 (measured 2.6e-6:
  the noise normal times 0.12, and the chirp's float32 ``sin``, numpy's
  against XLA's);
* ``keyword_event_stream`` audio: ``STREAM_ATOL`` 1e-6 (measured 1.8e-7:
  the chirp's ``sin``; the noise is numpy's ``RandomState`` in both).
"""

import jax
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro.data import pipeline as jpipeline
from repro_torch.data import pipeline as tpipeline
from repro_torch.data import prng

NORMAL_RTOL = 1e-5
NORMAL_ATOL = 1e-6
MFCC_ATOL = 5e-5
AUDIO_ATOL = 1e-5
STREAM_ATOL = 1e-6


def _eq(jax_array, np_array):
    a = np.asarray(jax_array)
    assert a.dtype == np_array.dtype and a.shape == np_array.shape
    np.testing.assert_array_equal(a, np_array)


# ---------------------------------------------------------------------------
# the PRNG twin
# ---------------------------------------------------------------------------

@settings(max_examples=25, deadline=None)
@given(seed=st.integers(0, 2**32 - 1), step=st.integers(0, 2**31 - 1))
def test_keys_fold_in_and_split_equal_jax(seed, step):
    jk, tk = jax.random.PRNGKey(seed), prng.PRNGKey(seed)
    _eq(jk, tk)
    jf, tf = jax.random.fold_in(jk, step), prng.fold_in(tk, step)
    _eq(jf, tf)
    _eq(jax.random.split(jf, 4), prng.split(tf, 4))
    _eq(jax.random.split(jf, 3), prng.split(tf, 3))


@settings(max_examples=20, deadline=None)
@given(seed=st.integers(0, 2**31 - 1), step=st.integers(0, 10_000),
       n=st.integers(1, 300))
def test_bits_uniform_and_randint_equal_jax(seed, step, n):
    key = jax.random.fold_in(jax.random.PRNGKey(seed), step)
    tkey = prng.fold_in(prng.PRNGKey(seed), step)
    _eq(jax.random.bits(key, (n, 3)), prng.random_bits(tkey, (n, 3)))
    _eq(jax.random.uniform(key, (n,)), prng.uniform(tkey, (n,)))
    for hi in (2, 35, 1000):
        _eq(jax.random.randint(key, (n,), 0, hi),
            prng.randint(tkey, (n,), 0, hi))


@pytest.mark.parametrize("seed,step", [(0, 0), (3, 5), (12345, 77)])
def test_normal_uniforms_exact_and_normals_within_tolerance(seed, step):
    key = jax.random.fold_in(jax.random.PRNGKey(seed), step)
    tkey = prng.fold_in(prng.PRNGKey(seed), step)
    want = np.asarray(jax.random.normal(key, (64, 16, 26)))
    got = prng.normal(tkey, (64, 16, 26))
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=NORMAL_RTOL, atol=NORMAL_ATOL)
    # the uniforms behind them are the reference's bits
    lo = np.nextafter(np.float32(-1.0), np.float32(0.0), dtype=np.float32)
    _eq(jax.random.uniform(key, (64, 16, 26), minval=lo, maxval=1.0),
        prng.normal_uniforms(tkey, (64, 16, 26)))


# ---------------------------------------------------------------------------
# the pipelines
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed,step", [(0, 0), (3, 5), (7, 123)])
@pytest.mark.parametrize("input_dim,n_classes", [((16, 26), 2),
                                                 ((40, 98), 35)])
def test_keyword_batch_is_the_reference_batch(seed, step, input_dim,
                                              n_classes):
    j = jpipeline.keyword_batch(seed, step, batch=64, input_dim=input_dim,
                                n_classes=n_classes)
    t = tpipeline.keyword_batch(seed, step, batch=64, input_dim=input_dim,
                                n_classes=n_classes)
    assert t["labels"].dtype == torch.int64 and t["mfcc"].dtype == torch.float32
    np.testing.assert_array_equal(t["labels"].numpy(), np.asarray(j["labels"]))
    np.testing.assert_allclose(t["mfcc"].numpy(), np.asarray(j["mfcc"]),
                               rtol=0, atol=MFCC_ATOL)


def test_gsc_eval_set_is_the_reference_fold():
    j = jpipeline.gsc_eval_set(0, n=100, batch=32)
    t = tpipeline.gsc_eval_set(0, n=100, batch=32)
    assert len(t) == len(j) == 4
    for a, b in zip(j, t):
        np.testing.assert_array_equal(b["labels"].numpy(),
                                      np.asarray(a["labels"]))
        np.testing.assert_allclose(b["mfcc"].numpy(), np.asarray(a["mfcc"]),
                                   rtol=0, atol=MFCC_ATOL)


@pytest.mark.parametrize("seed,step", [(0, 0), (3, 5), (7, 123)])
def test_keyword_audio_batch_is_the_reference_batch(seed, step):
    j = jpipeline.keyword_audio_batch(seed, step, batch=64, n_samples=4160)
    t = tpipeline.keyword_audio_batch(seed, step, batch=64, n_samples=4160)
    assert t["audio"].shape == (64, 4160) and t["audio"].dtype == torch.float32
    np.testing.assert_array_equal(t["labels"].numpy(), np.asarray(j["labels"]))
    np.testing.assert_allclose(t["audio"].numpy(), np.asarray(j["audio"]),
                               rtol=0, atol=AUDIO_ATOL)
    # both classes present, and only label 1 carries the chirp
    lab = t["labels"].numpy()
    assert set(lab.tolist()) == {0, 1}
    energy = np.square(t["audio"].numpy()).mean(-1)
    assert energy[lab == 1].mean() > 2 * energy[lab == 0].mean()


@pytest.mark.parametrize("stream_id", [0, 1, 5])
def test_keyword_event_stream_is_the_reference_stream(stream_id):
    ja, je = jpipeline.keyword_event_stream(3, stream_id, n_hops=400)
    ta, te = tpipeline.keyword_event_stream(3, stream_id, n_hops=400)
    assert te == je and len(te) >= 2
    assert ta.dtype == np.float32 and ta.shape == ja.shape
    np.testing.assert_allclose(ta, ja, rtol=0, atol=STREAM_ATOL)


def test_keyword_chirp_matches_the_reference():
    j = np.asarray(jpipeline._keyword_chirp(4160, 0.0, 0.6))
    t = tpipeline._keyword_chirp(4160, 0.0, 0.6)
    assert t.dtype == np.float32
    np.testing.assert_allclose(t, j, rtol=0, atol=STREAM_ATOL)


def test_port_data_is_deterministic_and_stateless():
    a = tpipeline.keyword_audio_batch(1, 2, batch=8, n_samples=1600)
    b = tpipeline.keyword_audio_batch(1, 2, batch=8, n_samples=1600)
    c = tpipeline.keyword_audio_batch(1, 3, batch=8, n_samples=1600)
    assert torch.equal(a["audio"], b["audio"])
    assert not torch.equal(a["audio"], c["audio"])
