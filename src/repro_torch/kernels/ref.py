"""Plain PyTorch versions of every CUDA kernel in this package.

Each function is the bit-level specification its kernel is held against:
same LUT contents, same index math, same accumulation widths.  The
wrappers take these for tensors on the CPU; the GPU smoke script calls
them on CUDA tensors to compare with the kernels.
"""

from __future__ import annotations

import torch

from repro_torch.core import approx, lut as lutlib, quant


def lut_softmax(x: torch.Tensor, *, fixed: bool = True,
                range_reduce: bool = True) -> torch.Tensor:
    """Row softmax over the last axis via the paper's LUT pipeline.

    ``fixed=True`` is ``approx.softmax_lut(fixed=True)``: the Q8.24
    pipeline with the rounding pre-shift.  The float variant gathers
    LUT_EXP in float32 and divides by the row sum; the sum is taken in
    float64, where it is exact for rows of up to 2^14 lanes (every table
    entry is a multiple of 2^-38 not above 1), so the value does not
    depend on the order of summation and the kernel can match it to the
    bit.
    """
    if fixed:
        return approx.softmax_lut(x, axis=-1, fixed=True,
                                  range_reduce=range_reduce)
    x = x.to(torch.float32)
    z = (x.amax(dim=-1, keepdim=True) - x).clamp(0.0, lutlib.EXP_RANGE)
    num = lutlib.bank_tensors(x.device)["exp_f32"][approx._exp_index_f32(z)]
    total = num.sum(dim=-1, keepdim=True, dtype=torch.float64)
    return num / total.to(torch.float32)


def lut_gelu(x: torch.Tensor, *, interp: bool = False) -> torch.Tensor:
    """Piecewise LUT GELU, computed in float32, returned in ``x.dtype``."""
    return approx.gelu_lut(x, interp=interp).to(x.dtype)


def int8_matmul_raw(x_int: torch.Tensor, w_int: torch.Tensor, *,
                    shift: int = 0, out_int16: bool = False) -> torch.Tensor:
    """[M,K] int8 @ [K,N] int8 -> int32 with epilogue ``>> shift`` (or
    ``<< -shift``); ``out_int16`` clips to the INT16 range and narrows."""
    acc = quant.exact_int_matmul(x_int, w_int)
    acc = acc >> shift if shift >= 0 else acc << (-shift)
    if out_int16:
        return acc.clamp(quant.INT16_MIN, quant.INT16_MAX).to(torch.int16)
    return acc


def int8_matmul_scaled(x_int: torch.Tensor, w_int: torch.Tensor, *,
                       shift: int, clip16: bool, out_exp: int,
                       axis_exponents: torch.Tensor | None = None
                       ) -> torch.Tensor:
    """The integer-executing linear: int32 accumulate, shift, optional
    INT16 clip, then float32 ``acc * 2^-out_exp * 2^-axis_exponents[n]``
    (the wrapper arithmetic of the reference's ``ops.int8_matmul``)."""
    acc = int8_matmul_raw(x_int, w_int, shift=shift, out_int16=clip16)
    out = acc.to(torch.float32) * (2.0 ** (-out_exp))
    if axis_exponents is not None:
        out = out * torch.exp2(-axis_exponents.to(torch.float32))
    return out


def int8_matmul_io(x: torch.Tensor, w: torch.Tensor, *, shift: int,
                   clip16: bool, out_exp: int,
                   axis_exponents: torch.Tensor | None = None,
                   x_exp: int | None = None, x_bits: int = 8,
                   w_shape: tuple | None = None) -> torch.Tensor:
    """:func:`int8_matmul_scaled` with the kernel's input modes: a float
    activation is quantised by eq 9 first (``quant.quantize_act`` with
    ``x_exp`` and ``x_bits``, in an int8 container), and a nibble-packed
    int4 weight payload (``w_shape = (K, N)``) unpacked first
    (``quant.unpack_po2``)."""
    if x.is_floating_point():
        x = quant.quantize_act(x, x_exp, bits=x_bits).to(torch.int8)
    if w_shape is not None:
        w = quant.unpack_po2(w, 4, w_shape)
    return int8_matmul_scaled(x, w, shift=shift, clip16=clip16,
                              out_exp=out_exp, axis_exponents=axis_exponents)


def int8_matmul(x_int: torch.Tensor, w_int: torch.Tensor, *, x_exp: int,
                w_exp: int, out_exp: int | None = None,
                residual_bits: int = 32) -> torch.Tensor:
    """INT8 x INT8 -> INT32 accumulate -> shift-rescale (paper eq 9 epilogue).

    Returns float32 dequantised output (the framework-facing contract).
    """
    q = quant.qmatmul(quant.QTensor(x_int, x_exp), quant.QTensor(w_int, w_exp),
                      out_exponent=out_exp, residual_bits=residual_bits)
    return q.dequantize()


def masked_lut_softmax(s: torch.Tensor, mask: torch.Tensor | None) -> torch.Tensor:
    """LUT softmax with *structural* masking: masked scores never enter the
    numerator sum (mirrors the C pipeline, which only computes valid
    entries) — avoids the e^{-10} clip leak that -inf masking would cause.
    A fully masked row is zeros (the reference's oracle divides 0 by 0
    there; its kernel, and this port's, give 0).
    """
    s = s.to(torch.float32)
    neg = torch.finfo(torch.float32).min
    sm = s if mask is None else torch.where(mask, s, neg)
    m = sm.amax(dim=-1, keepdim=True)
    z = (m - s).clamp(0.0, lutlib.EXP_RANGE)
    num = lutlib.bank_tensors(s.device)["exp_f32"][approx._exp_index_f32(z)]
    if mask is not None:
        num = torch.where(mask, num, 0.0)
    # an unmasked row sums to at least 1 (its max lane is EXP_F32[0] = 1),
    # so the clamp changes nothing but a fully masked row
    return num / num.sum(dim=-1, keepdim=True).clamp(min=1e-30)


def lut_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True, softmax_mode: str = "lut",
                  scale: float | None = None) -> torch.Tensor:
    """Scaled-dot-product attention with LUT softmax (eq 1 + eq 10), the
    whole key axis in one softmax, as the reference's oracle: the plain
    version of the attention kernel.  Where the keys are several tiles the
    kernel is held tightly to :func:`lut_attention_tiled` instead.

    q: [B, Hq, Lq, D], k/v: [B, Hkv, Lk, D] with Hq % Hkv == 0 (GQA: query
    head ``h`` reads key/value head ``h // (Hq // Hkv)``).  Causal masking
    right-aligns the queries against the keys (query ``i`` sees keys up to
    ``i + Lk - Lq``); a query that sees no key (Lq > Lk) gets zeros, as
    from the kernel.  Computed in float32, returned in ``q.dtype``.
    """
    b, hq, lq, d = q.shape
    hkv, lk = k.shape[1], k.shape[2]
    if hq % hkv:
        raise ValueError(f"GQA needs Hq % Hkv == 0, got Hq={hq}, Hkv={hkv}")
    group = hq // hkv
    scale = (d ** -0.5) if scale is None else scale
    qf = q.to(torch.float32).reshape(b, hkv, group, lq, d)
    s = torch.einsum("bhgqd,bhkd->bhgqk", qf, k.to(torch.float32)) * scale
    mask = torch.ones((lq, lk), dtype=torch.bool, device=q.device).tril(
        diagonal=lk - lq) if causal else None
    if softmax_mode == "exact":
        sm = s if mask is None else \
            torch.where(mask, s, torch.finfo(torch.float32).min)
        p = torch.softmax(sm, dim=-1)
        if mask is not None:
            p = torch.where(mask, p, 0.0)
    elif softmax_mode == "lut":
        p = masked_lut_softmax(s, mask)
    else:
        raise ValueError(f"unknown softmax_mode {softmax_mode!r}; "
                         "available: lut, exact")
    out = torch.einsum("bhgqk,bhkd->bhgqd", p, v.to(torch.float32))
    return out.reshape(b, hq, lq, d).to(q.dtype)


_NEG = -1e30   # the reference kernel's mask value: m_new - s never inf - inf


def lut_attention_tiled(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool, use_lut: bool, block_k: int,
                        scale: float | None = None) -> torch.Tensor:
    """The reference kernel's online softmax (``_attn_kernel``), one step
    per key tile of ``block_k`` keys, in its arithmetic: what the
    flash-LUT attention kernel is held to where the keys are several tiles
    (``chip_smoke.py``).

    Per tile: ``s = (q . k) * scale`` (masked lanes -1e30), ``m_new =
    max(m, max s)``, ``p = E(clip(m_new - s, 0, 10))`` (0 on a masked lane,
    or, non-causal, where ``s <= -5e29``), ``alpha = E(clip(m_new - m, 0,
    10))``, ``l = alpha * l + sum p``, ``acc = alpha * acc + p @ v``; then
    ``acc / max(l, 1e-30)``.  ``E`` is the EXP_F32 probe (``use_lut``) or
    ``exp(-z)``.  ``alpha`` is itself a 1/32-bin probe, so the result
    depends on ``block_k``: where the keys are several tiles it differs
    from :func:`lut_attention`'s single softmax by up to a few 1e-3.
    Each tile's ``sum p`` is taken in float64 and rounded once: the
    products then agree with the reference kernel's bit for bit more
    often (tests/test_torch_flash_parity.py).
    """
    b, hq, lq, d = q.shape
    hkv, lk = k.shape[1], k.shape[2]
    if hq % hkv:
        raise ValueError(f"GQA needs Hq % Hkv == 0, got Hq={hq}, Hkv={hkv}")
    if block_k <= 0 or lk % block_k:
        raise ValueError(f"block_k={block_k} does not divide Lk={lk}")
    scale = (d ** -0.5) if scale is None else scale
    tab = lutlib.bank_tensors(q.device)["exp_f32"]

    def exp_neg(x):
        z = x.clamp(0.0, lutlib.EXP_RANGE)
        return tab[approx._exp_index_f32(z)] if use_lut else torch.exp(-z)

    qf = q.to(torch.float32).reshape(b, hkv, hq // hkv, lq, d)
    kf, vf = k.to(torch.float32), v.to(torch.float32)
    m = torch.full((b, hkv, hq // hkv, lq, 1), _NEG, device=q.device)
    l = torch.zeros_like(m)
    acc = torch.zeros_like(qf)
    qpos = torch.arange(lq, device=q.device)[:, None] + (lk - lq)
    for kt in range(0, lk, block_k):
        s = torch.einsum("bhgqd,bhkd->bhgqk", qf,
                         kf[:, :, kt:kt + block_k]) * scale
        if causal:
            valid = qpos >= torch.arange(kt, kt + block_k, device=q.device)
            s = torch.where(valid, s, _NEG)
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        p = exp_neg(m_new - s)
        p = torch.where(valid if causal else s > _NEG / 2, p, 0.0)
        alpha = exp_neg(m_new - m)
        l = alpha * l + p.sum(dim=-1, keepdim=True,
                              dtype=torch.float64).to(torch.float32)
        acc = alpha * acc + torch.einsum("bhgqk,bhkd->bhgqd", p,
                                         vf[:, :, kt:kt + block_k])
        m = m_new
    out = acc / l.clamp(min=1e-30)
    return out.reshape(b, hq, lq, d).to(q.dtype)
