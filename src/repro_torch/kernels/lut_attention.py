"""Flash attention with the LUT exp in the online softmax: wrapper of the
CUDA kernels ``csrc/lut_attention.cu`` (D <= 128) and
``csrc/lut_attention_wide.cu`` (128 < D <= 256), which replace the
reference's Pallas ``lut_attention``.  Plain version:
:func:`ref.lut_attention_tiled`, the same online softmax over the same
key tiles (the reference kernel's own arithmetic, to float32 rounding),
against which the kernel is held tightly.  :func:`ref.lut_attention`, one
softmax over the whole key axis, stays the reference's oracle: the online
form agrees with it to float32 rounding where the keys are one tile, and
within the LUT's bin width (the reference's own 0.05 bound) where they
are several.

The kernel reads its operands where they lie: any strides for batch,
head and row, the depth axis at stride 1.  So the model hands it views of
its ``[B, L, H, D]`` projections, and :func:`empty_out` allocates the
output so that its ``[B, L, H, D]`` transpose is contiguous."""

from __future__ import annotations

import torch

from repro_torch.kernels import _launch, ref

launches = 0   # kernel launches made by this wrapper (both modes)

MAX_BLOCK_K = 128   # keys a tile: the score tile of a warp stays in registers
NARROW_D = 128      # attn_kernel; above it attn_wide_kernel
MAX_D = 256
_INT32_MAX = 2 ** 31 - 1
_MAX_WARPS, _ENTRIES, _MAX_SMEM = 8, 320, 232448   # csrc/lut_attention_tile.cuh


def _smem_floats(stages: int, wpb: int, nt: int, srow: int) -> int:
    return _ENTRIES + stages * wpb * 16 * srow + stages * 2 * nt * 8 * srow


# csrc/lut_attention_wide.cu: the table and the row maxima ahead of Q
_WIDE_HEAD_BYTES = (_ENTRIES + _MAX_WARPS * 16) * 4


def _wide_ring(dt: int, nt: int) -> tuple:
    """(ring slots, bytes a slot) of the wide instance (its ``Ring`` and
    ``slot_bytes``): tiles of <= 32 keys in chunks of 32 through 4 slots;
    tiles of <= 128 in chunks of 64 float32 or 128 bf16 keys through 3
    slots at D <= 192 and 2 at D <= 256; a slot holds the larger chunk of
    the two dtypes."""
    stages = 4 if nt <= 4 else (3 if dt <= 24 else 2)
    f32 = (32 if nt <= 4 else 64) * (dt * 8 + 4) * 4
    bf16 = (32 if nt <= 4 else 128) * (dt * 8 + 8) * 2
    return stages, max(f32, bf16)


def _wide_smem_bytes(gpb: int, dt: int, nt: int) -> int:
    stages, slot = _wide_ring(dt, nt)
    return _WIDE_HEAD_BYTES + gpb * 16 * (dt * 8 + 4) * 4 + stages * slot


def _wide_geometry(pairs: int, lq: int, d: int, bk: int, sms: int,
                   occupancy) -> tuple:
    """``launch_wide``'s choice (D > 128): two warps a group of 16 query
    rows (they split each chunk's keys), at most 4 groups a block, halved
    while an SM holds no block; K and V through a ring of chunks
    (:func:`_wide_ring`).  The geometry is the same for float32 and bf16
    (bf16 uses part of the shared memory)."""
    dt = 24 if d <= 192 else 32
    nt = 4 if bk <= 32 else 16
    groups = -(-lq // 16)
    splits = 1 if pairs >= 2 * sms else -(-(2 * sms) // pairs)
    splits = min(max(splits, 1), groups)
    gpb = min(-(-groups // splits), _MAX_WARPS // 2)
    while True:
        splits = -(-groups // gpb)
        items = pairs * splits
        if items > _INT32_MAX:
            return 1, (0, 0, 0, 0)
        threads = 64 * gpb
        nbytes = _wide_smem_bytes(gpb, dt, nt)
        bps = occupancy(("lut_attention", dt, nt), threads, nbytes) \
            if nbytes <= _MAX_SMEM else 0
        if bps <= 0:
            if gpb == 1:
                return 1, (0, 0, 0, 0)
            gpb = (gpb + 1) // 2
            continue
        return 0, (min(items, bps * sms), threads, nbytes,
                   (dt * 100 + nt) * 10 + _wide_ring(dt, nt)[0])


def item_tiles(lq: int, lk: int, bk: int, rows: int, splits: int,
               causal: bool) -> list:
    """The key tiles each of a head's ``splits`` items (blocks of ``rows``
    query rows) walks in the wide kernel: under a causal mask up to the
    last row's last key, ``(r_last + lk - lq) // bk``, and one fully
    masked tile where no row sees a key; else every tile."""
    tiles = lk // bk
    out = []
    for sp in range(splits):
        last = min(sp * rows + rows, lq) - 1 + lk - lq
        out.append((1 if last < 0 else min(tiles, last // bk + 1))
                   if causal else tiles)
    return out


def tile_steps(b: int, hq: int, hkv: int, lq: int, lk: int, d: int, bk: int,
               causal: bool, *, sms: int, occupancy) -> dict:
    """The wide kernel's (item, key tile) steps of a launch (D > 128), from
    the geometry mirror: ``walked`` those its blocks take, ``full`` those
    of a walk over every tile, ``busiest`` the most one block takes (its
    items dealt in a snake over the grid, the longest first).  Its C twin,
    ``lut_attention_wide_steps``, walks the kernel's own item order."""
    if d <= NARROW_D:
        raise ValueError(f"tile_steps: the wide kernel takes D > {NARROW_D}")
    code, (grid, threads, _, _) = geometry(b, hq, hkv, lq, lk, d, bk,
                                           sms=sms, occupancy=occupancy)
    if code:
        raise ValueError("tile_steps: the launcher refuses "
                         f"{(b, hq, hkv, lq, lk, d, bk)}")
    if grid == 0:
        return {"walked": 0, "full": 0, "busiest": 0}
    pairs, tiles = b * hq, lk // bk
    rows = threads // 64 * 16
    splits = -(-lq // rows)
    nts = item_tiles(lq, lk, bk, rows, splits, causal)
    items = pairs * splits
    # rank r takes split splits - 1 - r // pairs; block i's li-th rank is
    # li * grid + (i, or grid - 1 - i where li is odd)
    length = [nts[splits - 1 - r // pairs] for r in range(items)]
    busiest = 0
    for i in range(grid):
        n, li = 0, 0
        while True:
            r = li * grid + (grid - 1 - i if li & 1 else i)
            if r >= items:
                break
            n += length[r]
            li += 1
        busiest = max(busiest, n)
    return {"walked": sum(length), "full": items * tiles, "busiest": busiest}


def geometry(b: int, hq: int, hkv: int, lq: int, lk: int, d: int, bk: int, *,
             sms: int, occupancy) -> tuple:
    """The launcher's choice for ``lut_attention_geometry``'s arguments,
    written out in Python: ``(code, (grid, threads, shared memory,
    variant))``, variant ``(DT * 100 + NT) * 10 + stages`` (DT > 16: the
    wide kernel of D > 128).
    ``occupancy(("lut_attention", DT, NT), threads, smem)`` is the blocks an
    SM holds (the card's answer, or a model of it)."""
    if hkv <= 0 or hq % hkv or bk <= 0 or bk > MAX_BLOCK_K or lk % bk \
            or d <= 0 or d > MAX_D:
        return 1, (0, 0, 0, 0)
    pairs = b * hq
    if pairs == 0 or lq == 0:
        return 0, (0, 0, 0, 0)
    if d > NARROW_D:
        return _wide_geometry(pairs, lq, d, bk, sms, occupancy)
    dt = 1 if d <= 8 else 8 if d <= 64 else 16
    nt = 4 if bk <= 32 else 13 if 96 < bk <= 104 else 16
    srow = dt * 8 + 4
    groups = -(-lq // 16)
    splits = 1 if pairs >= 2 * sms else -(-(2 * sms) // pairs)
    splits = min(max(splits, 1), groups)
    wpb = min(-(-groups // splits), _MAX_WARPS)
    tiles = lk // bk
    wpb0, force_one = wpb, False
    while True:
        splits = -(-groups // wpb)
        items = pairs * splits
        if items > _INT32_MAX:
            return 1, (0, 0, 0, 0)
        threads = 32 * wpb
        bytes1 = _smem_floats(1, wpb, nt, srow) * 4
        bytes2 = _smem_floats(2, wpb, nt, srow) * 4
        key = ("lut_attention", dt, nt)
        bps1 = occupancy(key, threads, bytes1) if bytes1 <= _MAX_SMEM else 0
        bps2 = occupancy(key, threads, bytes2) if bytes2 <= _MAX_SMEM else 0
        one = force_one or (tiles == 1 and (bps1 >= 2 * bps2
                                            or items <= bps1 * sms))
        stages = 1 if one else 2
        nbytes, bps = (bytes1, bps1) if one else (bytes2, bps2)
        if bps <= 0:
            if wpb == 1:
                if force_one:
                    return 1, (0, 0, 0, 0)
                force_one, wpb = True, wpb0
                continue
            wpb = (wpb + 1) // 2
            continue
        grid = min(items, bps * sms)
        return 0, (grid, threads, nbytes, (dt * 100 + nt) * 10 + stages)


def strides(t: torch.Tensor, what: str) -> tuple[int, int, int]:
    """The (batch, head, row) element strides of a ``[B, H, L, D]``
    operand; its depth axis must have stride 1 (any stride where D is 1)."""
    s = t.stride()
    if s[3] != 1 and t.shape[3] > 1:
        raise ValueError(f"lut_attention: the depth axis of {what} must have "
                         f"stride 1, got strides {s}")
    return s[:3]


def empty_out(q: torch.Tensor) -> torch.Tensor:
    """An uninitialised ``[B, Hq, Lq, D]`` output in q's dtype whose
    ``transpose(1, 2)`` is contiguous: the layer's
    ``out.transpose(1, 2).reshape(B, L, H * D)`` is then a view."""
    b, hq, lq, d = q.shape
    return torch.empty((b, lq, hq, d), dtype=q.dtype,
                       device=q.device).transpose(1, 2)


def lut_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool, use_lut: bool, scale: float,
                  block_k: int) -> torch.Tensor:
    """q [B, Hq, Lq, D], k/v [B, Hkv, Lk, D] -> [B, Hq, Lq, D] in q's dtype.

    ``block_k`` is the key-tile edge at which the online softmax rescales
    (it must divide Lk); it is not a performance knob: the LUT rescale
    makes the answer depend on it.  Operands may be strided views (depth
    at stride 1); on the card the output is laid out as
    :func:`empty_out` says.  The kernel's limits (``block_k`` <=
    MAX_BLOCK_K, D <= MAX_D) hold on the CPU too, so that a plan the host
    rehearses is one the card runs.
    """
    if q.ndim != 4 or k.ndim != 4 or v.shape != k.shape or \
            q.shape[0] != k.shape[0] or q.shape[3] != k.shape[3]:
        raise ValueError("lut_attention takes q [B,Hq,Lq,D] and k, v "
                         f"[B,Hkv,Lk,D], got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    b, hq, lq, d = q.shape
    hkv, lk = k.shape[1], k.shape[2]
    if hq % hkv:
        raise ValueError(f"GQA needs Hq % Hkv == 0, got Hq={hq}, Hkv={hkv}")
    if block_k <= 0 or lk % block_k:
        raise ValueError(f"block_k={block_k} does not divide Lk={lk}")
    if block_k > MAX_BLOCK_K or d > MAX_D:
        raise ValueError(f"lut_attention kernel takes block_k <= "
                         f"{MAX_BLOCK_K} and D <= {MAX_D}, got block_k="
                         f"{block_k}, D={d}")
    st_q, st_k, st_v = strides(q, "q"), strides(k, "k"), strides(v, "v")
    if not _launch.on_cuda(q, "lut_attention"):
        return ref.lut_attention_tiled(q, k, v, causal=causal,
                                       use_lut=use_lut, scale=scale,
                                       block_k=block_k)
    dt = q.dtype
    if (dt is not torch.float32 and dt is not torch.bfloat16) or \
            k.dtype is not dt or v.dtype is not dt:
        raise TypeError("lut_attention kernel takes float32 or bfloat16 "
                        f"q, k, v of one dtype, got {q.dtype}, {k.dtype}, "
                        f"{v.dtype}")
    idx = q.get_device()
    if k.get_device() != idx or v.get_device() != idx:
        raise RuntimeError("lut_attention: operands on different devices")
    if max(st_q + st_k + st_v) > _INT32_MAX:
        raise ValueError("lut_attention: a stride exceeds int32")
    global launches
    out = empty_out(q)
    if out.numel() == 0:
        return out
    st = _launch.state(idx)
    _launch.launch(st, st.lib.lut_attention_launch, "lut_attention",
                   q.data_ptr(), k.data_ptr(), v.data_ptr(), st.exp_f32,
                   out.data_ptr(), b, hq, hkv, lq, lk, d, block_k, causal,
                   use_lut, dt is torch.bfloat16, scale, *st_q, *st_k, *st_v,
                   *out.stride()[:3])
    launches += 1
    return out
