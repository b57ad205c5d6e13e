"""The wide flash-LUT attention (128 < D <= 256): its causal skip is exact,
and its walk and geometry on the CPU.

``csrc/lut_attention_wide.cu`` walks, for each block of query rows, only
the key tiles up to the block's last row's last key.  A tile past a row's
last key changes nothing in the reference kernel's online softmax: the row
max stays (every lane is -1e30), the rescale is the probe of 0, exactly
1.0 (entry 0 of the table; ``exp(-0)`` in the exact mode), and p is 0 on
every lane.  So the walk below, which takes for each block of rows only
its visible tiles with the arithmetic of ``ref.lut_attention_tiled``,
must give that function's bits (``torch.equal``, no tolerance), at head
dims of both wide instances, key tiles of 4, 32 and 128, LUT and exact,
float32 and bf16 inputs, and Lq below, at and above Lk.

A row that sees no key (causal, Lq > Lk) is 0 in the port's plain version
and in the reference's Pallas kernel (interpret mode).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro_torch.analysis import geometry as an_geometry
from repro_torch.core import approx
from repro_torch.core import lut as lutlib
from repro_torch.kernels import lut_attention as tattn
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref

torch.set_num_threads(1)

_NEG = -1e30


def _skip_walk(q, k, v, *, use_lut, block_k, rows):
    """``ref.lut_attention_tiled`` (causal) where each block of ``rows``
    query rows takes only the tiles it sees (``lut_attention.item_tiles``):
    the wide kernel's walk in plain PyTorch.  A block's m, l and acc are
    moved only by its own tiles; past them they are left as they are.
    Each tile is computed at the tiled version's shapes (all rows), since
    CPU elementwise kernels round an element by where it lies (a vector
    body and a scalar tail), and only the rows of the blocks that see it
    take the result."""
    b, hq, lq, d = q.shape
    hkv, lk = k.shape[1], k.shape[2]
    scale = d ** -0.5
    tab = lutlib.bank_tensors(q.device)["exp_f32"]

    def exp_neg(x):
        z = x.clamp(0.0, lutlib.EXP_RANGE)
        return tab[approx._exp_index_f32(z)] if use_lut else torch.exp(-z)

    qf = q.to(torch.float32).reshape(b, hkv, hq // hkv, lq, d)
    kf, vf = k.to(torch.float32), v.to(torch.float32)
    splits = -(-lq // rows)
    nts = tattn.item_tiles(lq, lk, block_k, rows, splits, True)
    # the tiles each row's block walks
    walk = torch.tensor(nts).repeat_interleave(rows)[:lq][:, None]
    m = torch.full((b, hkv, hq // hkv, lq, 1), _NEG)
    l = torch.zeros_like(m)
    acc = torch.zeros_like(qf)
    qpos = torch.arange(lq)[:, None] + (lk - lq)
    for tile in range(max(nts)):
        kt = tile * block_k
        seen = walk > tile
        s = torch.einsum("bhgqd,bhkd->bhgqk", qf,
                         kf[:, :, kt:kt + block_k]) * scale
        valid = qpos >= torch.arange(kt, kt + block_k)
        s = torch.where(valid, s, _NEG)
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        p = torch.where(valid, exp_neg(m_new - s), 0.0)
        alpha = exp_neg(m_new - m)
        l = torch.where(seen, alpha * l + p.sum(
            dim=-1, keepdim=True, dtype=torch.float64).to(torch.float32), l)
        acc = torch.where(seen, alpha * acc + torch.einsum(
            "bhgqk,bhkd->bhgqd", p, vf[:, :, kt:kt + block_k]), acc)
        m = torch.where(seen, m_new, m)
    out = acc / l.clamp(min=1e-30)
    return out.reshape(b, hq, lq, d).to(q.dtype)


# (block_k, Lk, then Lq below, at and above Lk)
_TILES = {4: (12, (8, 12, 20)), 32: (96, (72, 96, 136)),
          128: (256, (200, 256, 320))}


def _rows(hq, lq, lk, d, bk):
    """The wide kernel's query rows a block, from the geometry mirror."""
    code, (_, threads, _, _) = tattn.geometry(
        1, hq, 1, lq, lk, d, bk, sms=an_geometry.H100_SMS,
        occupancy=an_geometry.h100_occupancy)
    assert code == 0
    return threads // 64 * 16


@pytest.mark.parametrize("d", [136, 192, 256])
@pytest.mark.parametrize("bk", [4, 32, 128])
@pytest.mark.parametrize("use_lut", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("where", ["lq<lk", "lq=lk", "lq>lk"])
def test_skip_walk_is_the_tiled_version(d, bk, use_lut, dtype, where):
    lk, lqs = _TILES[bk]
    lq = lqs[("lq<lk", "lq=lk", "lq>lk").index(where)]
    rng = np.random.default_rng(d * 1000 + bk * 10 + lq)
    q, k, v = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
               .to(dtype) for s in ((1, 2, lq, d), (1, 1, lk, d),
                                    (1, 1, lk, d)))
    want = ref.lut_attention_tiled(q, k, v, causal=True, use_lut=use_lut,
                                   block_k=bk)
    for rows in {16, 64, _rows(2, lq, lk, d, bk)}:
        got = _skip_walk(q, k, v, use_lut=use_lut, block_k=bk, rows=rows)
        assert torch.equal(got, want), (rows, (got - want).abs().max())


@pytest.mark.parametrize("use_lut", [True, False])
def test_rows_that_see_no_key_are_zero(use_lut):
    """Causal with Lq = 24 > Lk = 8: rows 0-15 see no key and are 0 in the
    port's plain version and in the reference's Pallas kernel."""
    rng = np.random.default_rng(7)
    q, k, v = (rng.standard_normal(s).astype(np.float32)
               for s in ((1, 2, 24, 136), (1, 1, 8, 136), (1, 1, 8, 136)))
    got = tops.lut_attention(*map(torch.from_numpy, (q, k, v)), causal=True,
                             use_lut=use_lut).numpy()
    pallas = np.asarray(jops.lut_attention(*map(jnp.asarray, (q, k, v)),
                                           causal=True, use_lut=use_lut,
                                           interpret=True))
    for out in (got, pallas):
        assert not out[:, :, :16].any()
        assert np.abs(out[:, :, 16:]).min(axis=-1).max() > 0
    np.testing.assert_allclose(got, pallas, atol=1e-6, rtol=0)


def test_tile_steps_at_nemotron():
    """nemotron-4-340b's causal (2, 96(8), 1024, 192) at key tiles of 128:
    blocks of 64 rows walk 72 of a head's 128 (item, tile) steps, and the
    snake over 132 blocks gives the busiest block within 1 % of the mean."""
    steps = tattn.tile_steps(2, 96, 8, 1024, 1024, 192, 128, True,
                             sms=an_geometry.H100_SMS,
                             occupancy=an_geometry.h100_occupancy)
    assert steps["walked"] == 192 * 72 and steps["full"] == 192 * 128
    assert steps["busiest"] <= 1.01 * steps["walked"] / 132
    # without the mask every tile is walked
    full = tattn.tile_steps(2, 96, 8, 1024, 1024, 192, 128, False,
                            sms=an_geometry.H100_SMS,
                            occupancy=an_geometry.h100_occupancy)
    assert full["walked"] == full["full"] == 192 * 128


@pytest.mark.parametrize("d", [64, 128])
def test_tile_steps_takes_only_the_wide_kernel(d):
    """The narrow kernel (D <= 128) has no causal skip to count: the
    mirror of the wide kernel's walk refuses it."""
    with pytest.raises(ValueError, match="D > 128"):
        tattn.tile_steps(2, 4, 2, 64, 256, d, 128, True,
                         sms=an_geometry.H100_SMS,
                         occupancy=an_geometry.h100_occupancy)
