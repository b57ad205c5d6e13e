"""Flash attention with the LUT exp in the online softmax: wrapper of the
CUDA kernel ``csrc/lut_attention.cu`` (which replaces the reference's
Pallas ``lut_attention``).  Plain version: :func:`ref.lut_attention`,
which takes the softmax over the whole key axis at once — the kernel's
online form agrees with it to float32 rounding where the keys are one
tile, and within the LUT's bin width (the reference's own 0.05 bound)
where they are several.  :func:`ref.lut_attention_tiled` is the kernel's
online softmax over the same key tiles, against which the kernel is held
tightly wherever the keys are cut."""

from __future__ import annotations

import torch

from repro_torch.core import lut as lutlib
from repro_torch.kernels import build, ref
from repro_torch.kernels._launch import require_cuda, stream_of

launches = 0   # kernel launches made by this wrapper (both modes)


def lut_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool, use_lut: bool, scale: float,
                  block_k: int) -> torch.Tensor:
    """q [B, Hq, Lq, D], k/v [B, Hkv, Lk, D] -> [B, Hq, Lq, D] in q's dtype.

    ``block_k`` is the key-tile edge at which the online softmax rescales
    (it must divide Lk); it is not a performance knob: the LUT rescale
    makes the answer depend on it.
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
    if q.device.type == "cpu":
        return ref.lut_attention(q, k, v, causal=causal, scale=scale,
                                 softmax_mode="lut" if use_lut else "exact")
    require_cuda(q, "lut_attention")
    if q.dtype not in (torch.float32, torch.bfloat16) or \
            k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError("lut_attention kernel takes float32 or bfloat16 "
                        f"q, k, v of one dtype, got {q.dtype}, {k.dtype}, "
                        f"{v.dtype}")
    if k.device != q.device or v.device != q.device:
        raise RuntimeError("lut_attention: operands on different devices")
    global launches
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    tab = lutlib.bank_tensors(q.device)["exp_f32"]
    lib = build.load()
    with torch.cuda.device(q.device):
        code = lib.lut_attention_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), tab.data_ptr(),
            out.data_ptr(), b, hq, hkv, lq, lk, d, block_k, int(causal),
            int(use_lut), int(q.dtype == torch.bfloat16), scale, stream_of(q))
    build.check(code, f"lut_attention q {tuple(q.shape)} k {tuple(k.shape)} "
                      f"block_k {block_k} (a refused launch: shared memory "
                      "grows with D * block_k)")
    launches += 1
    return out
