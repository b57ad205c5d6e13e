"""QuantRecipe: the paper's PTQ pipeline (§IV, eq 9, Table V) as one value.

A recipe is everything ``runtime.compile_model`` needs to turn float
parameters into the deployed numeric form: weight/input exponents, the
rounding rule for the eq-9 cast, optional per-channel exponent refinement,
and the residual (intermediate) width.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch.core import quant
from repro_torch.core.tree import tree_leaves, tree_map

Pytree = Any

# elements of a leaf one quantiser pass takes: a larger leaf is cast in
# slices of its last (output-channel) axis, so the cast's float32
# temporaries stay near 1 GiB (nemotron-4-340b's embed is 4.7 G elements)
CHUNK_ELEMS = 1 << 28


def po2_fake_quant(w: torch.Tensor, weight_exponent, *, bits: int = 8,
                   rounding: str = "nearest", per_channel: bool = False):
    """The eq-9 cast in float: quantise-dequantise without the int8 store.

    Returns ``(fq, q, extra, unsat)``:
      * ``fq`` — the dequantised float values, bit-identical to
        ``QuantRecipe.quantize(...)`` -> ``dequantize`` (power-of-2 scales
        make every (de)scale multiplication exact in f32);
      * ``q`` — the clipped integer grid (f32 values in [lo, hi]; the
        exact values ``QuantRecipe.quantize`` casts to int8);
      * ``extra`` — the per-channel exponent refinements (int32, last-axis
        channels) or ``None`` on the scalar path;
      * ``unsat`` — bool mask of lanes whose cast did NOT saturate.
    """
    lo = -(2 ** (bits - 1))
    hi = 2 ** (bits - 1) - 1
    wf = w.to(torch.float32)
    e = torch.as_tensor(weight_exponent, dtype=torch.float32, device=wf.device)
    extra = None
    if per_channel and w.ndim >= 2:
        # Per-channel refinement: each output channel (last axis) shifts to
        # its own no-saturation bound — extra precision for small channels,
        # saturation-free casts for large ones, still power-of-2 shifts
        # only (stored as QTensor.axis_exponents).
        maxabs = wf.abs().amax(dim=tuple(range(w.ndim - 1)))
        extra = torch.floor(torch.log2(hi / maxabs.clamp(min=1e-30)))
        extra = (extra - e).clamp(-12, 12).to(torch.int32)
        scaled = wf * torch.exp2(e + extra.to(torch.float32))
    else:
        scaled = wf * torch.exp2(e)
    if rounding == "nearest":
        q = torch.floor(scaled + 0.5)
    elif rounding == "floor":
        q = torch.floor(scaled)
    else:
        raise ValueError(f"unknown rounding {rounding!r}")
    unsat = (q >= lo) & (q <= hi)
    q = q.clamp(lo, hi)
    # dequantise in the same order QTensor.dequantize uses (both exact)
    fq = q * torch.exp2(-e)
    if extra is not None:
        fq = fq * torch.exp2(-extra.to(torch.float32))
    return fq, q, extra, unsat


@dataclasses.dataclass(frozen=True)
class QuantRecipe:
    """One deployment's quantisation policy (paper §IV + Table V).

    ``weight_exponent``/``input_exponent`` are the Table V power-of-2
    scales (best row: weights 2^6, inputs 2^5).  ``rounding`` selects the
    eq-9 cast: ``"nearest"`` adds the half-LSB offset (default),
    ``"floor"`` reproduces the paper's cast bit-exactly.  ``per_channel``
    refines each output channel to its own no-saturation power-of-2
    exponent (beyond-paper; stored as ``QTensor.axis_exponents``).
    ``residual_bits=16`` is the paper's INT16 intermediate clip, consumed
    by the int8 matmul path.
    """

    weight_exponent: int = 6
    input_exponent: int = 5
    bits: int = 8
    residual_bits: int = 16
    rounding: str = "nearest"
    per_channel: bool = False
    skip_norm_scales: bool = True      # norms/biases stay float (paper §IV)

    @classmethod
    def from_config(cls, cfg, **overrides) -> "QuantRecipe":
        """Build from ``cfg.quant`` (configs.base.QuantConfig) or defaults.

        ``per_channel`` resolves registry-driven: an explicit
        ``cfg.quant.per_channel`` wins; otherwise LM-scale families default
        to per-channel refinement while ``kwt`` configs keep the paper's
        scalar Table V recipe.
        """
        q = getattr(cfg, "quant", None)
        kw = {"per_channel": cfg.family != "kwt"}
        if q is not None:
            kw.update({"weight_exponent": q.weight_exponent,
                       "input_exponent": q.input_exponent,
                       "residual_bits": q.residual_bits,
                       "bits": getattr(q, "bits", 8)})
            if q.per_channel is not None:
                kw["per_channel"] = q.per_channel
        kw.update(overrides)
        return cls(**kw)

    def with_(self, **kw) -> "QuantRecipe":
        return dataclasses.replace(self, **kw)

    # -- serialisation ------------------------------------------------------

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "QuantRecipe":
        names = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in names})

    # -- calibration --------------------------------------------------------

    def calibrated(self, params: Pytree) -> "QuantRecipe":
        """Recipe with the analytic no-saturation weight exponent for
        ``params`` (largest y with no quantised leaf clipping)."""
        exps = [quant.choose_exponent(leaf, bits=self.bits)
                for leaf in tree_leaves(params) if self._quantizes(leaf)]
        if not exps:
            return self
        return self.with_(weight_exponent=int(min(exps)))

    # -- application -------------------------------------------------------

    def _quantizes(self, leaf) -> bool:
        """Leaf selection: norms and biases (rank<=1) stay float per
        paper §IV."""
        if not isinstance(leaf, torch.Tensor) or not leaf.is_floating_point():
            return False
        return not (self.skip_norm_scales and leaf.ndim <= 1)

    def _quantize_leaf(self, w: torch.Tensor) -> quant.QTensor:
        per_channel = self.per_channel and w.ndim >= 2
        if not per_channel and w.numel() <= CHUNK_ELEMS:
            return quant.quantize_po2(w, self.weight_exponent, bits=self.bits,
                                      rounding=self.rounding)
        # the cast is elementwise and a channel's exponent reads its own
        # column only, so slices of the last axis give the whole's bits
        cols = w.shape[-1]
        step = max(1, CHUNK_ELEMS // max(1, w.numel() // cols))
        grids, extras = [], []
        for c0 in range(0, cols, step):
            part = w[..., c0:c0 + step]
            if per_channel:
                _, q, extra, _ = po2_fake_quant(
                    part, self.weight_exponent, bits=self.bits,
                    rounding=self.rounding, per_channel=True)
                # per-channel refinements are clipped to [-12, 12], so
                # one int8 per output channel stores them exactly
                extras.append(extra.to(torch.int8))
                grids.append(q.to(quant.storage_dtype(self.bits)))
            else:
                grids.append(quant.quantize_po2(
                    part, self.weight_exponent, bits=self.bits,
                    rounding=self.rounding).int_values())
        q = grids[0] if len(grids) == 1 else torch.cat(grids, dim=-1)
        # dtype-true storage through the shared codec (nibble-packed below
        # 5 bits)
        return quant.QTensor.store(
            q, self.weight_exponent, bits=self.bits,
            axis_exponents=torch.cat(extras) if extras else None)

    def fake_quant_leaf(self, w: torch.Tensor, weight_exponent=None):
        """(fq, unsat) for one weight leaf — the QAT forward-pass values.
        ``weight_exponent`` (a Python number or a 0-dim tensor, e.g. the
        learned exponent on the device) overrides the recipe field."""
        e = self.weight_exponent if weight_exponent is None else weight_exponent
        fq, _, _, unsat = po2_fake_quant(w, e, bits=self.bits,
                                         rounding=self.rounding,
                                         per_channel=self.per_channel and
                                         w.ndim >= 2)
        return fq, unsat

    def quantize(self, params: Pytree) -> Pytree:
        """params -> tree with QTensor leaves (norms/biases stay float)."""
        return tree_map(
            lambda leaf: self._quantize_leaf(leaf) if self._quantizes(leaf)
            else leaf, params)

    def apply(self, params: Pytree) -> Pytree:
        """PTQ round-trip: the float params a dequantise-first engine runs
        (int8 values de-scaled by their power-of-2 shifts)."""
        return quant.dequantize_tree(self.quantize(params))

    def quantized_bytes(self, params: Pytree) -> tuple[int, int]:
        """(int bytes, residual float bytes) of the deployed tree."""
        return quant.tree_quantized_bytes(self.quantize(params))
