"""Flash attention with the LUT exp in the online softmax: wrapper of the
CUDA kernel ``csrc/lut_attention.cu`` (which replaces the reference's
Pallas ``lut_attention``).  Plain version: :func:`ref.lut_attention`,
which takes the softmax over the whole key axis at once — the kernel's
online form agrees with it to float32 rounding where the keys are one
tile, and within the LUT's bin width (the reference's own 0.05 bound)
where they are several.  :func:`ref.lut_attention_tiled` is the kernel's
online softmax over the same key tiles, against which the kernel is held
tightly wherever the keys are cut.

The kernel reads its operands where they lie: any strides for batch,
head and row, the depth axis at stride 1.  So the model hands it views of
its ``[B, L, H, D]`` projections, and :func:`empty_out` allocates the
output so that its ``[B, L, H, D]`` transpose is contiguous."""

from __future__ import annotations

import torch

from repro_torch.kernels import _launch, ref

launches = 0   # kernel launches made by this wrapper (both modes)

MAX_BLOCK_K = 128   # keys a tile: the score tile of a warp stays in registers
MAX_D = 128
_INT32_MAX = 2 ** 31 - 1


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
    :func:`empty_out` says.
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
    st_q, st_k, st_v = strides(q, "q"), strides(k, "k"), strides(v, "v")
    if not _launch.on_cuda(q, "lut_attention"):
        return ref.lut_attention(q, k, v, causal=causal, scale=scale,
                                 softmax_mode="lut" if use_lut else "exact")
    dt = q.dtype
    if (dt is not torch.float32 and dt is not torch.bfloat16) or \
            k.dtype is not dt or v.dtype is not dt:
        raise TypeError("lut_attention kernel takes float32 or bfloat16 "
                        f"q, k, v of one dtype, got {q.dtype}, {k.dtype}, "
                        f"{v.dtype}")
    idx = q.get_device()
    if k.get_device() != idx or v.get_device() != idx:
        raise RuntimeError("lut_attention: operands on different devices")
    if block_k > MAX_BLOCK_K or d > MAX_D:
        raise ValueError(f"lut_attention kernel takes block_k <= "
                         f"{MAX_BLOCK_K} and D <= {MAX_D}, got block_k="
                         f"{block_k}, D={d}")
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
