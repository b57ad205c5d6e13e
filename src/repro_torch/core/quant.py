"""Power-of-2 post-training static quantisation (paper §IV, eq 9, Table V).

    W_int = floor(W_float * 2^y), stored INT8, dequantised by bit shift.

Design points carried over from the paper:
  * scale factors are powers of two so (de)quantisation is a shift;
  * weights and inputs get *separate* exponents (Table V: 2^6 vs 2^5);
  * intermediate results of int matmuls accumulate wider (paper: INT16
    residuals; here int32 accumulation, optionally clipped back to int16
    to reproduce the paper's storage type);
  * SoftMax and LayerNorm stay in float in the faithful path (§IV cites
    [12]: quantising them is "quite taxing on accuracy").

Integer products.  ``int8 @ int8`` on the CPU returns int8 and wraps, and
integer ``matmul`` is not implemented for CUDA tensors, so every integer
contraction here goes through :func:`exact_int_matmul`, which widens to an
exact container first.  Float32 contractions over integer grids rely on
TF32 being off (``runtime.compile_model`` sets the flags).

Not ported: the reference's ``matmul_unrolled`` / ``_SMALL_MACS`` pair,
which exists only to steer XLA:CPU's thunk dispatch for tiny contractions
and changes no value; the stochastic-rounding key of ``quantize_po2``
and ``gather_descale`` (LM embeddings) wait for their slices.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from repro_torch.core.tree import tree_leaves, tree_map

Pytree = Any

INT8_MIN, INT8_MAX = -128, 127
INT16_MIN, INT16_MAX = -(2**15), 2**15 - 1

# f32 holds every integer up to 2^24 exactly; while K * 2^(xbits-1) *
# 2^(wbits-1) stays under this, an f32 GEMM over integer grids is
# bit-equal to int32 accumulation in any summation order (TF32 off).
_F32_EXACT = 1 << 24


def int_range(bits: int) -> tuple[int, int]:
    """The two's-complement range of a ``bits``-wide signed integer."""
    return -(2 ** (bits - 1)), 2 ** (bits - 1) - 1


def storage_dtype(bits: int):
    """Narrowest container dtype for ``bits``-wide values.

    ``bits<=4`` values are *stored* nibble-packed (two per uint8 byte, see
    :func:`pack_po2`); their element dtype before packing is int8.
    """
    return torch.int8 if bits <= 8 else torch.int16


# ---------------------------------------------------------------------------
# The packed-int codec.
# ---------------------------------------------------------------------------

def packed_length(n: int, bits: int) -> int:
    """Stored bytes for ``n`` values at ``bits`` width (nibble packing)."""
    return (n + 1) // 2 if bits <= 4 else n


def pack_po2(values: torch.Tensor, bits: int) -> torch.Tensor:
    """Pack ``bits<=4`` two's-complement values, two nibbles per byte.

    ``values`` is any int tensor whose elements fit the ``bits``-wide
    range; the result is a flat uint8 tensor of ``ceil(n/2)`` bytes (low
    nibble = even index).  Odd lengths pad the final high nibble with
    zero; empty tensors pack to an empty byte string.  Exact inverse:
    :func:`unpack_po2` with the original shape.
    """
    if not 1 <= bits <= 4:
        raise ValueError(f"pack_po2 is the sub-byte codec (bits={bits})")
    # & 0xF on the signed value keeps the low two's-complement nibble
    flat = (values.reshape(-1).to(torch.int16) & 0xF).to(torch.uint8)
    if flat.numel() % 2:
        flat = torch.cat([flat, flat.new_zeros(1)])
    pairs = flat.reshape(-1, 2)
    return pairs[:, 0] | (pairs[:, 1] << 4)


def unpack_po2(packed: torch.Tensor, bits: int, shape) -> torch.Tensor:
    """Inverse of :func:`pack_po2`: nibble-packed bytes -> int8 ``shape``.

    Sign-extends each 4-bit two's-complement nibble ((v ^ 8) - 8), so the
    round-trip is exact for every value in the ``bits``-wide range.
    """
    if not 1 <= bits <= 4:
        raise ValueError(f"unpack_po2 is the sub-byte codec (bits={bits})")
    n = int(np.prod(shape, dtype=np.int64))
    lo = packed & 0xF
    hi = (packed >> 4) & 0xF
    flat = torch.stack([lo, hi], dim=-1).reshape(-1)[:n]
    return ((flat.to(torch.int8) ^ 8) - 8).reshape(tuple(shape))


def pack_payload(values: torch.Tensor, bits: int) -> torch.Tensor:
    """Storage form of an int tensor: nibble-packed for ``bits<=4``, the
    narrowest int dtype otherwise."""
    if bits <= 4:
        return pack_po2(values, bits)
    return values.to(storage_dtype(bits))


def unpack_payload(payload: torch.Tensor, bits: int, shape) -> torch.Tensor:
    """Inverse of :func:`pack_payload` (identity above 4 bits)."""
    if bits <= 4:
        return unpack_po2(payload, bits, shape)
    return payload.reshape(tuple(shape))


@dataclasses.dataclass
class QTensor:
    """An eq-9 quantised tensor: int values + static power-of-2 exponent.

    Storage is dtype-true (the bytes a 64 kB device would hold): int8 for
    ``4 < bits <= 8``, int16 above, and nibble-packed uint8 (two values
    per byte, :func:`pack_po2`) for ``bits <= 4``.  When packed,
    ``logical_shape`` carries the pre-pack shape and ``values`` is the
    flat byte image; :meth:`int_values` restores the int8 grid.
    """

    values: torch.Tensor              # int8 / int16, or uint8 nibble-packed
    exponent: int
    axis_exponents: torch.Tensor | None = None    # per-channel (beyond-paper)
    bits: int = 8
    logical_shape: tuple | None = None            # set iff nibble-packed

    @classmethod
    def store(cls, q: torch.Tensor, exponent: int, *, bits: int = 8,
              axis_exponents: torch.Tensor | None = None) -> "QTensor":
        """Build a dtype-true QTensor from an (already clipped) int grid."""
        qi = q.to(storage_dtype(bits))         # signed cast BEFORE nibble wrap
        if bits <= 4:
            return cls(values=pack_po2(qi, bits), exponent=exponent,
                       axis_exponents=axis_exponents, bits=bits,
                       logical_shape=tuple(qi.shape))
        return cls(values=qi, exponent=exponent,
                   axis_exponents=axis_exponents, bits=bits)

    @property
    def packed(self) -> bool:
        return self.logical_shape is not None

    @property
    def shape(self):
        return self.logical_shape if self.packed else tuple(self.values.shape)

    @property
    def stored_bytes(self) -> int:
        """True packed storage bytes (values + per-channel exponents)."""
        b = self.values.numel() * self.values.element_size()
        if self.axis_exponents is not None:
            b += self.axis_exponents.numel() * self.axis_exponents.element_size()
        return b

    def int_values(self) -> torch.Tensor:
        """The integer grid at its logical shape (unpacks when packed)."""
        if self.packed:
            return unpack_po2(self.values, self.bits, self.logical_shape)
        return self.values

    def dequantize(self) -> torch.Tensor:
        out = self.int_values().to(torch.float32) * (2.0 ** (-self.exponent))
        if self.axis_exponents is not None:
            out = out * torch.exp2(-self.axis_exponents.to(torch.float32))
        return out

    def to(self, device) -> "QTensor":
        axis = self.axis_exponents
        return dataclasses.replace(
            self, values=self.values.to(device),
            axis_exponents=None if axis is None else axis.to(device))


def quantize_po2(w: torch.Tensor, exponent: int, *, bits: int = 8,
                 rounding: str = "floor") -> QTensor:
    """eq 9: floor(w * 2^y) with saturation to the ``bits``-wide int range.

    ``rounding="nearest"`` adds the half-LSB offset before the floor (an
    adder in front of the truncating shift in hardware terms): floor's
    systematic -LSB/2 bias is correlated across every weight and measurably
    shifts whole-model logits; the offset removes it at zero ROM cost.

    Storage is the narrowest dtype for ``bits`` (int8 up to 8 bits,
    nibble-packed below 5), and saturation clips at the true ``bits``-wide
    edges (e.g. [-8, 7] at 4 bits).
    """
    lo, hi = int_range(bits)
    scaled = w.to(torch.float32) * (2.0 ** exponent)
    if rounding == "nearest":
        q = torch.floor(scaled + 0.5)
    elif rounding == "floor":
        q = torch.floor(scaled)
    else:
        raise ValueError(f"unknown rounding {rounding!r}")
    return QTensor.store(q.clamp(lo, hi), exponent, bits=bits)


def choose_exponent(w: torch.Tensor, *, bits: int = 8) -> int:
    """Largest y such that floor(max|w| * 2^y) does not saturate.

    The paper picks y by accuracy sweep (Table V); this is the analytic
    no-overflow bound used as the sweep's starting point.
    """
    maxabs = float(w.abs().max())
    if maxabs == 0.0:
        return bits - 1
    return int(np.floor(np.log2((2 ** (bits - 1) - 1) / maxabs)))


def exact_int_matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` over integer tensors with int32 (wrapping) accumulation.

    On the CPU this is torch's int32 matmul (the operands are widened
    first: a narrow integer product would wrap at its own width).  CUDA
    has no integer matmul, so there the product runs in an exact float
    container: float32 for int8 operands while K * 2^7 * 2^7 <= 2^24
    (every partial sum is then an integer float32 holds; TF32 must be
    off), float64 otherwise — exact for any K below 2^37 — cast back
    through int64 so that an overflowing accumulator wraps as int32 does.
    """
    if x.device.type == "cpu":
        return torch.matmul(x.to(torch.int32), w.to(torch.int32))
    narrow = x.dtype == torch.int8 and w.dtype == torch.int8
    if narrow and x.shape[-1] * 2 ** 14 <= _F32_EXACT:
        return torch.matmul(x.to(torch.float32),
                            w.to(torch.float32)).to(torch.int32)
    acc = torch.matmul(x.to(torch.float64), w.to(torch.float64))
    return acc.to(torch.int64).to(torch.int32)


def qmatmul(x: QTensor, w: QTensor, *, out_exponent: int | None = None,
            residual_bits: int = 16) -> QTensor:
    """Integer matmul with int32 accumulation and shift rescale.

    C_int32 = X_int8 @ W_int8 has exponent (x.e + w.e).  The result is
    shifted to ``out_exponent`` and clipped to the residual width (paper:
    INT16 intermediates).
    """
    acc = exact_int_matmul(x.int_values(), w.int_values())
    acc_exp = x.exponent + w.exponent
    out_exponent = acc_exp if out_exponent is None else out_exponent
    shift = acc_exp - out_exponent
    acc = acc >> shift if shift >= 0 else acc << (-shift)
    if residual_bits == 16:
        acc = acc.clamp(INT16_MIN, INT16_MAX).to(torch.int16)
    return QTensor(values=acc, exponent=out_exponent, bits=residual_bits)


def resident_values(w: QTensor) -> torch.Tensor:
    """Float view of a stored-integer leaf: unpack the nibble/int8 grid
    and apply the power-of-2 de-scale — both exact, so the values equal
    the plan-time dequantisation bit for bit.  (The reference hides this
    behind an ``optimization_barrier`` to keep XLA from re-fusing; eager
    PyTorch fuses nothing, so there is no barrier to port.)"""
    return w.dequantize()


def qt_einsum(eq: str, x: torch.Tensor, w: QTensor) -> torch.Tensor:
    """Einsum against a *stored-integer* QTensor weight with float
    activations (the non-executing integer-resident plan): the float view
    is materialised per call by :func:`resident_values`, so logits are
    bit-identical to the dequantise-first float-matmul path while storage
    stays dtype-true.

    Integer activations go through ``kernels.ops.int8_matmul`` or
    :func:`qmatmul`; this helper is the float-activation contract.
    """
    if isinstance(x, QTensor):
        raise TypeError("qt_einsum is the float-activation path; integer "
                        "activations go through kernels.ops.int8_matmul / "
                        "quant.qmatmul on the same stored operands")
    return torch.einsum(eq, x, resident_values(w))


# ---------------------------------------------------------------------------
# Full-integer execution: eq-9 activation quantiser + integer-executing
# einsum over the STORED payload (no float weight view, no unpack stage).
# ---------------------------------------------------------------------------

def quantize_act(x: torch.Tensor, exponent: int, *, bits: int = 8
                 ) -> torch.Tensor:
    """eq 9 applied to a linear-layer input: the per-layer activation
    quantiser of the integer-executing pipeline.

    Same semantics as the PTQ weight cast with nearest rounding: scale by
    the power-of-2 input exponent (Table V: 2^5), floor with the half-LSB
    offset, saturate at the ``bits``-wide edges.  Returns the integer
    GRID in an f32 container (values in [lo, hi], exactly representable).
    """
    lo, hi = int_range(bits)
    q = torch.floor(x.to(torch.float32) * (2.0 ** exponent) + 0.5)
    return q.clamp(lo, hi)


def int_container(w: QTensor) -> torch.Tensor:
    """The stored integer grid in an f32 container — value-preserving
    (every ``bits``-wide integer is exact in f32), NOT a dequantisation:
    no scale is applied, the values stay on the integer lattice."""
    return w.int_values().to(torch.float32)


def requant(acc: torch.Tensor, x_exp: int, w_exp: int,
            axis_exponents: torch.Tensor | None = None) -> torch.Tensor:
    """Power-of-2 requantisation epilogue of the integer matmul: descale
    the accumulator by 2^-(x_exp+w_exp), then the per-output-channel
    refinements.  All multiplications are by powers of two — exact in
    f32 — so the plain and the CUDA realisations produce identical bits."""
    if not acc.is_floating_point():
        acc = acc.to(torch.float32)
    out = acc * (2.0 ** (-(x_exp + w_exp)))
    if axis_exponents is not None:
        out = out * torch.exp2(-axis_exponents.to(torch.float32))
    return out


def int_exec_supported(w, eq: str) -> bool:
    """Can ``int_exec_einsum`` run ``eq`` against ``w`` integer-only?

    Supported: rank-2 weights contracted on the activation's last axis,
    weight-first (``bsd,df->bsf``-family) or weight-last (the tied-
    embedding head ``...d,vd->...v``).  Per-channel ``axis_exponents``
    live on the weight's LAST axis, so the weight-last layout puts them
    on the contraction axis where they cannot fold into a post-matmul
    epilogue — those fall back to the float-view path.
    """
    if not isinstance(w, QTensor) or len(w.shape) != 2:
        return False
    lhs, rhs = eq.split("->")[0].split(",")
    if len(rhs) != 2:
        return False
    if rhs[0] == lhs[-1]:                 # weight-first: per-channel
        return True                       # exps fold into the epilogue
    if rhs[1] == lhs[-1]:                 # weight-last (tied head)
        return w.axis_exponents is None
    return False


def _int_grid_matmul(xq: torch.Tensor, ws, k: int, x_bits: int,
                     transpose_w: bool = False) -> torch.Tensor:
    """``xq @ concat(ws)`` over integer grids, contracting the last
    activation axis: in f32 containers while that is exact, in int32
    otherwise."""
    wide = max(w.bits for w in ws)
    if k * 2 ** (x_bits - 1) * 2 ** (wide - 1) <= _F32_EXACT:
        wi = torch.cat([int_container(w) for w in ws], dim=-1)
        return torch.matmul(xq, wi.T if transpose_w else wi)
    wl = torch.cat([w.int_values() for w in ws], dim=-1)
    return exact_int_matmul(xq.to(torch.int32), wl.T if transpose_w else wl)


def int_exec_einsum(eq: str, x: torch.Tensor, w: QTensor, *,
                    x_exp: int, x_bits: int = 8, residual_bits: int = 16,
                    use_kernel: bool = False) -> torch.Tensor:
    """Integer-executing linear layer: quantise the activation (eq 9),
    multiply against the STORED int8 / nibble-packed int4 payload, clip
    to the paper's INT16 residual, requantise.  No ``dequantize_tree``
    stage, no float weight view — the only float-producing op in the
    plan is the exact po2 :func:`requant` epilogue.

    ``use_kernel`` (the ``cuda`` plan) routes the quantiser, the product,
    the clip and the epilogue through the hand-written CUDA kernel
    (``kernels.ops.int8_matmul``), which takes the float activation and
    the stored payload as they are; the torch realisation below is that
    kernel's plain version — same eq-9 roundings, same integer
    accumulation, same int16 clip, same epilogue order, identical bits.
    """
    lhs, rhs = eq.split("->")[0].split(",")
    transpose_w = rhs[0] != lhs[-1]       # weight-last (tied head) layout
    k = int(x.shape[-1])
    if use_kernel:
        if transpose_w:
            raise NotImplementedError(
                "the weight-last (tied-head) layout belongs to the LM slice "
                "of the port; the CUDA int8 matmul takes [K, N] weights")
        from repro_torch.kernels import ops as _kops
        # the float activation goes in as it is: the kernel quantises it
        return _kops.int8_matmul(x, w, x_exp=x_exp, x_bits=x_bits,
                                 residual_bits=residual_bits)
    xq = quantize_act(x, x_exp, bits=x_bits)
    acc = _int_grid_matmul(xq, (w,), k, x_bits, transpose_w)
    if residual_bits == 16:
        acc = acc.clamp(INT16_MIN, INT16_MAX)
    axis = None if transpose_w else w.axis_exponents
    return requant(acc, x_exp, w.exponent, axis)


def int_exec_qkv(x: torch.Tensor, ws, *, x_exp: int, x_bits: int = 8,
                 residual_bits: int = 16):
    """Fused Q/K/V integer projection: ONE product over the three stored
    payloads concatenated on the output axis, with each leaf's
    scalar-exponent delta folded into the per-column requant epilogue.
    Bitwise equal to three separate :func:`int_exec_einsum` calls — the
    K-reduction is per-column independent, and the po2 column scale
    2^-(x+e0+delta) == 2^-(x+e_leaf)·2^-axis_leaf exactly.

    Returns the per-leaf outputs (split back at the leaf widths).
    """
    k = int(x.shape[-1])
    xq = quantize_act(x, x_exp, bits=x_bits)
    acc = _int_grid_matmul(xq, ws, k, x_bits)
    if residual_bits == 16:
        acc = acc.clamp(INT16_MIN, INT16_MAX)
    e0 = ws[0].exponent
    if all(w.exponent == e0 and w.axis_exponents is None for w in ws):
        axis = None
    else:
        cols = []
        for w in ws:
            delta = torch.full((w.shape[-1],), float(w.exponent - e0),
                               dtype=torch.float32, device=x.device)
            if w.axis_exponents is not None:
                delta = delta + w.axis_exponents.to(torch.float32)
            cols.append(delta)
        axis = torch.cat(cols)
    out = requant(acc, x_exp, e0, axis)
    return torch.split(out, [w.shape[-1] for w in ws], dim=-1)


def dequantize_tree(tree: Pytree) -> Pytree:
    """Replace every QTensor leaf with its float32 dequantisation."""
    return tree_map(
        lambda leaf: leaf.dequantize() if isinstance(leaf, QTensor) else leaf,
        tree)


def quantize_tree(params: Pytree, *, weight_exponent: int = 6,
                  bits: int = 8, skip_norm_scales: bool = True,
                  rounding: str = "nearest") -> Pytree:
    """PTQ a parameter tree with one global weight exponent (Table V row).

    LayerNorm scale+shift vectors and biases stay float (paper §IV) —
    detected as rank<=1 leaves when ``skip_norm_scales``.
    """
    def one(leaf):
        if not isinstance(leaf, torch.Tensor) or not leaf.is_floating_point():
            return leaf
        if skip_norm_scales and leaf.ndim <= 1:
            return leaf
        return quantize_po2(leaf, weight_exponent, bits=bits, rounding=rounding)

    return tree_map(one, params)


def tree_quantized_bytes(tree: Pytree) -> tuple[int, int]:
    """(quantised_bytes, float_bytes) of a (partially) quantised tree.

    ``quantised_bytes`` is the TRUE packed storage count — nibble-packed
    bytes for ``bits<=4`` leaves plus any per-channel exponent bytes.
    """
    qb = fb = 0
    for leaf in tree_leaves(tree):
        if isinstance(leaf, QTensor):
            qb += leaf.stored_bytes
        elif isinstance(leaf, torch.Tensor):
            fb += leaf.numel() * leaf.element_size()
    return qb, fb
