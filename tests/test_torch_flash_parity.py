"""The flash-LUT attention's plain version and the tied head on the
``cuda`` plan, against the reference, on the CPU.

The attention kernel's plain version is ``ref.lut_attention_tiled`` at the
reference's key tile, ``fit_block(Lk, 128)``: the online softmax that
rescales, by a 1/32-bin LUT probe, at every tile edge.  The wrapper's CPU
branch and every plan but ``cuda`` take it (``kernels.ops``).  The
reference's ``flash_lut`` plans run its Pallas kernel, here in interpret
mode, so they rescale at the same edges; one softmax over all keys does
not, and parts from them once the keys span two tiles.

The weight-last (tied-head) layout: the reference sends only ``[K, N]``
weights to its int8 kernel and takes the tied head's integer product
outside it; the port's ``cuda`` plan does the same.

Stated tolerances, beside the errors measured on the CPU (PyTorch against
XLA:CPU):

* the plain version against the Pallas kernel (``interpret=True``) at
  ``[1, 4(1), 256, D]``, two key tiles, D of 136, 192 and 256, causal and
  not, LUT and exact: ``KERNEL_ATOL`` 1e-6.  Measured at most 6.0e-7;
  one softmax over all keys reads 6.4e-3 to 1.1e-2 in the LUT mode.
* the plain version's share of outputs bit-equal to the Pallas kernel's
  at KWT-1's shape (one tile of 99 keys, D 64): ``MIN_BIT_EQUAL`` 0.55.
  Measured 0.583 to 0.586 over three inputs (the row sums in float64,
  rounded once); 0.492 to 0.500 with the sums in float32, 0.11 with one
  softmax.
* whole-model logits (scale ~4.4) at S = 256, two key tiles, under
  ``flash_lut``, on nemotron-4-340b's smoke config at head_dim 192 and
  internlm2-1.8b's: the port's ``lut_float`` against the reference's,
  ``LUT_FLOAT_ATOL`` 0.02 (measured 0.0051 and 0.0100; 0.0398 and 0.0698
  with one softmax), and the port's ``cuda`` plan (plain versions)
  against the reference's ``pallas``, ``CUDA_ATOL`` 0.04 (measured 0.0229
  and 0.0247; 0.0657 and 0.0757 with one softmax).  What is left is the
  float products' other summation order moving an occasional LUT bin,
  as at one key tile.
* the tied head: ``cuda`` (plain versions) against ``pallas``, bit-equal
  (measured 0.0).
* the quantiser in slices of a leaf's last axis (how nemotron-4-340b's
  embed and head are cast on one card): bit-equal to the reference
  recipe's cast of the whole leaf.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import runtime as jrt
from repro.configs import registry as jregistry
from repro.configs.base import QuantConfig as JQuantConfig
from repro.kernels import ops as jops
from repro_torch import convert
from repro_torch import runtime as trt
from repro_torch.configs import registry as tregistry
from repro_torch.configs.base import QuantConfig as TQuantConfig
from repro_torch.kernels import lut_attention as tattn
from repro_torch.kernels import ops as tops
from test_torch_lm_model import np_params

torch.set_num_threads(1)

KERNEL_ATOL = 1e-6
MIN_BIT_EQUAL = 0.55
LUT_FLOAT_ATOL = 0.02
CUDA_ATOL = 0.04
S = 256          # two key tiles of 128


def _qkv(shape, seed):
    b, hq, hkv, lq, lk, d = shape
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32)
            for s in ((b, hq, lq, d), (b, hkv, lk, d), (b, hkv, lk, d))]


def _pallas(q, k, v, causal, use_lut):
    return np.asarray(jops.lut_attention(*map(jnp.asarray, (q, k, v)),
                                         causal=causal, use_lut=use_lut,
                                         interpret=True))


@pytest.mark.parametrize("d", [136, 192, 256])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("use_lut", [True, False])
def test_plain_version_is_the_pallas_kernel_above_d128(d, causal, use_lut):
    """The wrapper's CPU branch at head dims the wide kernel takes, two key
    tiles, GQA 4 to 1: the reference kernel's function to float32
    rounding."""
    q, k, v = _qkv((1, 4, 1, S, S, d), seed=d)
    got = tops.lut_attention(*map(torch.from_numpy, (q, k, v)),
                             causal=causal, use_lut=use_lut).numpy()
    diff = np.abs(got - _pallas(q, k, v, causal, use_lut))
    assert diff.max() <= KERNEL_ATOL, diff.max()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_plain_version_is_bit_equal_to_the_pallas_kernel_mostly(seed):
    """At one key tile the plain version and the kernel do the same
    operations; the float64 row sum makes them the same bits on most
    outputs (see the module docstring)."""
    q, k, v = _qkv((64, 1, 1, 99, 99, 64), seed=seed)
    got = tops.lut_attention_plain(*map(torch.from_numpy, (q, k, v)),
                                   causal=False).numpy()
    assert (got == _pallas(q, k, v, False, True)).mean() >= MIN_BIT_EQUAL


def test_wrapper_refuses_a_head_dim_above_256():
    """D = 257 is past the kernel's limit, on the CPU as on the card (a
    plan the host rehearses is one the card runs); D = 256 is taken."""
    q = torch.zeros(1, 2, 4, 257)
    with pytest.raises(ValueError, match="D <= 256"):
        tops.lut_attention(q, q, q, causal=True)
    assert tattn.MAX_D == 256
    q = torch.zeros(1, 2, 4, 256)
    assert tops.lut_attention(q, q, q, causal=True).shape == q.shape


def _setup(name, **over):
    jcfg = jregistry.get(name).smoke.with_(**over)
    tover = {k: TQuantConfig(**vars(v)) if isinstance(v, JQuantConfig)
             else v for k, v in over.items()}
    tcfg = tregistry.get(name).smoke.with_(**tover)
    npp = np_params(jcfg, 0)
    return jcfg, tcfg, jax.tree.map(jnp.asarray, npp), \
        convert.from_numpy_tree(npp, "cpu")


CONFIGS = {"nemotron-4-340b": {"head_dim": 192}, "internlm2-1.8b": {}}
PLANS = {"lut_float": ("lut_float", LUT_FLOAT_ATOL),
         "cuda": ("pallas", CUDA_ATOL)}


@pytest.mark.parametrize("name", list(CONFIGS))
@pytest.mark.parametrize("plan", list(PLANS))
def test_flash_lut_forward_matches_reference_at_two_key_tiles(name, plan):
    jcfg, tcfg, jp, tp = _setup(name, **CONFIGS[name])
    assert tcfg.resolved_head_dim == jcfg.resolved_head_dim
    jplan, atol = PLANS[plan]
    toks = np.random.default_rng(1).integers(
        0, tcfg.vocab_size, (2, S)).astype(np.int32)
    want = np.asarray(jrt.compile_model(jcfg, jp, backend=jplan,
                                        attention="flash_lut")
                      .forward(jnp.asarray(toks)))
    eng = trt.compile_model(tcfg, tp, backend=plan, attention="flash_lut",
                            device="cpu", plain_kernels=plan == "cuda")
    got = eng.forward(toks).numpy()
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= atol, np.abs(got - want).max()


def test_tied_head_on_the_cuda_plan_is_the_pallas_plan():
    """internlm2-1.8b's smoke config with a tied head and scalar exponents:
    the ``cuda`` plan takes the tied head's integer product outside the
    kernel, as the reference's ``pallas`` plan does; the logits are the
    same bits."""
    jcfg, tcfg, jp, tp = _setup(
        "internlm2-1.8b", tie_embeddings=True,
        quant=JQuantConfig(per_channel=False))
    toks = np.random.default_rng(1).integers(
        0, tcfg.vocab_size, (2, 8)).astype(np.int32)
    want = np.asarray(jrt.compile_model(jcfg, jp, backend="pallas")
                      .forward(jnp.asarray(toks)))
    eng = trt.compile_model(tcfg, tp, backend="cuda", device="cpu",
                            plain_kernels=True)
    got = eng.forward(toks).numpy()
    assert "lm_head" not in eng.params
    assert got.shape == (2, 8, tcfg.padded_vocab)
    assert np.array_equal(got, want), np.abs(got - want).max()


@pytest.mark.parametrize("per_channel", [True, False])
@pytest.mark.parametrize("bits", [8, 4])
def test_quantiser_in_column_slices_is_the_reference_cast(per_channel, bits,
                                                          monkeypatch):
    """A leaf larger than ``CHUNK_ELEMS`` (nemotron-4-340b's embed and
    head on the card) is cast in slices of its last axis; with the slices
    forced down to a few columns the stored leaf is the reference
    recipe's, bits, exponent and per-channel exponents alike."""
    from repro.runtime import QuantRecipe as JRecipe
    from repro_torch.runtime import recipe as trecipe
    w = np.random.default_rng(5).normal(0, 0.3, (3, 40, 37)).astype(
        np.float32)
    want = JRecipe(per_channel=per_channel, bits=bits).quantize(
        {"w": jnp.asarray(w)})["w"]
    monkeypatch.setattr(trecipe, "CHUNK_ELEMS", 3 * 40 * 5)
    got = trecipe.QuantRecipe(per_channel=per_channel, bits=bits).quantize(
        {"w": torch.from_numpy(w)})["w"]
    assert got.exponent == want.exponent and got.bits == want.bits
    assert np.array_equal(got.values.numpy(), np.asarray(want.values))
    if per_channel:
        assert np.array_equal(got.axis_exponents.numpy(),
                              np.asarray(want.axis_exponents))
    else:
        assert got.axis_exponents is None and want.axis_exponents is None
