"""Backend registry: *which* numeric/kernel realisation runs the model.

The paper's pipeline has three executable readings of the same math —
exact float ops, the plain LUT reference (the ROM contents as gathers),
and the hand-written CUDA kernels.  A ``Backend`` bundles the decision:
the softmax/activation modes it pins on the config and whether params get
the eq-9 PTQ by default.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class Backend:
    """One execution policy.

    ``quantize``: apply the QuantRecipe PTQ to params by default.
    ``uses_lut``: the 2.69 kB ROM bank is live (Engine.lut_bytes > 0).
    ``uses_kernels``: softmax, GELU and every integer linear execute as
    hand-written CUDA kernels, and so does the attention under
    ``attention="flash_lut"``; such a plan needs a CUDA device.
    ``int_resident``: the Engine keeps the quantised weights in their
    stored integer form (int8 / nibble-packed int4 QTensors) rather than
    a plan-time dequantised float copy.
    ``int_exec``: the plan integer-EXECUTES: linear layers quantise
    their inputs (eq 9, the recipe's input exponent) and multiply the
    stored payload directly with a per-channel po2 requant epilogue
    (``quant.int_exec_einsum``) — no per-call ``dequantize_tree`` unpack
    stage, no float weight view in the plan.
    """

    name: str
    description: str
    softmax_mode: str
    act_approx: str
    quantize: bool = False
    uses_lut: bool = False
    uses_kernels: bool = False
    int_resident: bool = False
    int_exec: bool = False
    attention: str = "xla"         # xla | flash_lut (kernels.lut_attention)

    def configure(self, cfg, *, attention: str | None = None):
        """Pin this backend's execution modes onto a ModelConfig.  The ONLY
        place that mutates softmax_mode / act_approx / attn_impl.
        ``attention`` overrides the backend's registered attention
        realisation (the ``compile_model(attention=...)`` knob)."""
        attn = self.attention if attention is None else attention
        if attn not in ("xla", "flash_lut"):
            raise ValueError(f"unknown attention impl {attn!r}; "
                             "available: xla, flash_lut")
        return cfg.with_(softmax_mode=self.softmax_mode,
                         act_approx=self.act_approx, attn_impl=attn)


_REGISTRY: dict[str, Backend] = {}


def register_backend(backend: Backend) -> Backend:
    """Register (or override) a backend under ``backend.name``."""
    _REGISTRY[backend.name] = backend
    return backend


def get_backend(name) -> Backend:
    if isinstance(name, Backend):
        return name
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(f"unknown backend {name!r}; available: "
                       f"{', '.join(sorted(_REGISTRY))}") from None


def available_backends() -> tuple[str, ...]:
    return tuple(sorted(_REGISTRY))


register_backend(Backend(
    "float", "exact float ops, float params (paper's baseline)",
    softmax_mode="exact", act_approx="exact"))

register_backend(Backend(
    "lut_float", "LUT softmax with float carry + LUT GELU, PTQ params "
                 "(Table IX column 3: quantised but unaccelerated)",
    softmax_mode="lut", act_approx="lut", quantize=True, uses_lut=True))

register_backend(Backend(
    "lut", "plain Q8.24 LUT reference: fixed-point softmax + LUT GELU, "
           "integer-resident AND integer-executing PTQ params (the "
           "'+Hardware' path, Table IX column 4)",
    softmax_mode="lut_fixed", act_approx="lut", quantize=True, uses_lut=True,
    int_resident=True, int_exec=True))

register_backend(Backend(
    "cuda", "hand-written CUDA kernels for softmax, GELU and every int8 "
            "linear; integer-resident and integer-executing PTQ params",
    softmax_mode="cuda", act_approx="cuda", quantize=True, uses_lut=True,
    uses_kernels=True, int_resident=True, int_exec=True))
