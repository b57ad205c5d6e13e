"""Engine: one planned execution of one model + backend + recipe.

``compile_model(cfg, params, backend=..., recipe=..., device=...)`` is the
single entry point through which execution is selected.  It resolves the
backend (float / lut_float / lut / cuda), applies the QuantRecipe PTQ
when the backend calls for it, pins the execution modes onto the config
ONCE, places the parameters on the device, and returns an ``Engine``:

    eng = runtime.compile_model(cfg, params, backend="cuda")
    logits = eng.forward(mfcc)            # offline [B, F, T] -> [B, C]
    state, logits = eng.stream_step(state, chunk, fcfg)   # one hop
    emb    = eng.embed_frames(frames)     # streaming building blocks
    logits = eng.encode_window(window)

Execution is eager under ``torch.inference_mode()``: there is no jit to
plan, so the reference's jitted programs, its flat-leaf dispatch and its
separate unpack executable have no counterpart here.  Capturing the
fixed-shape forward in a CUDA graph is a follow-up.

Device rule: ``device=None`` means the card and raises where there is
none; the CPU is used only when the caller passes ``device="cpu"``.  The
``cuda`` backend needs a CUDA device.

Numerics: ``compile_model`` turns TF32 off for matmuls and cuDNN — the
float score product in TF32 would move logits far beyond every stated
tolerance, and the f32-container integer products rely on exact float32.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch

from repro_torch.core import lut as lutlib
from repro_torch.core import quant
from repro_torch.core.tree import tree_leaves, tree_map
from repro_torch.device import resolve_device
from repro_torch.runtime.backends import Backend, get_backend
from repro_torch.runtime.recipe import QuantRecipe

Pytree = Any


def _model_module(cfg):
    if cfg.family == "kwt":
        from repro_torch.models import kwt
        return kwt
    raise NotImplementedError(
        f"family={cfg.family!r} is not ported yet: the LM families wait for "
        "ROADMAP queue A item 8")


def _tree_bytes(tree) -> int:
    return sum(x.numel() * x.element_size() for x in tree_leaves(tree)
               if isinstance(x, torch.Tensor))


def _later(what: str, item: str):
    raise NotImplementedError(f"{what} is not ported yet: it waits for "
                              f"ROADMAP queue A {item}")


@dataclasses.dataclass
class Engine:
    """A planned model: prepared params + pinned execution config.

    ``exec_cfg`` is the ONLY config that carries softmax_mode /
    act_approx different from the user's ``cfg``.
    """

    cfg: Any                        # the config compile_model was given
    exec_cfg: Any                   # cfg with the backend's modes pinned
    params: Pytree                  # PTQ-applied when the backend quantizes
    backend: Backend
    recipe: Optional[QuantRecipe]
    device: torch.device
    quantized_bytes: Optional[tuple] = None   # (int bytes, float bytes)
    int_exec: bool = False          # integer-executing plan: the model
    #                                 consumes the packed tree directly

    def __post_init__(self):
        self._mod = _model_module(self.exec_cfg)

    def live_params(self):
        """The operand tree the model runs on.

        Integer-EXECUTING plans have no float view at all: the model
        consumes the packed QTensors directly, so this returns ``params``
        as-is.  Non-executing integer-resident plans store packed QTensors
        and materialise the float view per call (po2 de-scales are exact,
        so the values equal the dequantise-first plan's bit for bit).
        """
        if self.int_resident and not self.int_exec:
            return quant.dequantize_tree(self.params)
        return self.params

    def _input(self, x):
        return torch.as_tensor(x).to(self.device)

    # -- inference entry points --------------------------------------------

    def forward(self, x):
        """Offline forward: mfcc [B,F,T] -> logits [B,n_classes]."""
        with torch.inference_mode():
            return self._mod.forward(self.live_params(), self._input(x),
                                     self.exec_cfg)

    def embed_frames(self, frames):
        """[B, t, F] time-major frames -> [B, t, d] patch embeddings."""
        with torch.inference_mode():
            return self._mod.embed_frames(self.live_params(),
                                          self._input(frames), self.exec_cfg)

    def encode_window(self, window):
        """Assembled [B, T, d] window -> logits [B, n_classes]."""
        with torch.inference_mode():
            return self._mod.encode_window(self.live_params(),
                                           self._input(window), self.exec_cfg)

    def stream_step(self, state, chunk, fcfg):
        """One hop of incremental inference (``stream.engine.stream_step``
        under this engine's plan): (state, chunk [B, k*hop]) -> (state,
        logits).  ``state`` comes from ``stream.engine.init_stream_state``
        on this engine's device; ``chunk`` may be numpy or a tensor
        anywhere and is moved there."""
        from repro_torch.stream import engine as stream_engine
        with torch.inference_mode():
            return stream_engine.stream_step(
                self.live_params(), state, self._input(chunk), self.exec_cfg,
                fcfg)

    def init_decode_state(self, batch: int, max_len: int):
        _later("Engine.init_decode_state", "item 8 (LM families)")

    def prefill(self, tokens, state):
        _later("Engine.prefill", "item 8 (LM families)")

    def decode_step(self, token, state):
        _later("Engine.decode_step", "item 8 (LM families)")

    # -- introspection -----------------------------------------------------

    @property
    def backend_name(self) -> str:
        return self.backend.name

    @property
    def rom_bytes(self) -> int:
        """TRUE packed bytes of the integer weight image the plan deploys
        (nibble-packed below 5 bits; 0 when nothing is quantised)."""
        return self.quantized_bytes[0] if self.quantized_bytes else 0

    @property
    def lut_bytes(self) -> int:
        """LUT ROM footprint of the plan (paper: 2.69 kB; 0 for float)."""
        return lutlib.make_lut_bank().rom_bytes if self.backend.uses_lut else 0

    @property
    def param_bytes(self) -> int:
        """Deployed parameter bytes: packed ints + residual floats when
        quantised, plain float tree bytes otherwise."""
        if self.quantized_bytes is not None:
            return sum(self.quantized_bytes)
        return _tree_bytes(self.params)

    @property
    def int_resident(self) -> bool:
        """True when the live tree holds stored-integer QTensors rather
        than a dequantised float copy."""
        return _has_qtensors(self.params)

    def describe(self) -> str:
        """One-line plan summary."""
        q = "" if self.recipe is None else \
            f", w=2^{self.recipe.weight_exponent}" \
            f"/x=2^{self.recipe.input_exponent} " \
            f"int{self.recipe.bits} {self.recipe.rounding}" + \
            (" int-exec" if self.int_exec else
             " resident" if self.int_resident else "")
        kern = ", kernels=cuda" if self.backend.uses_kernels else ""
        attn = "" if self.exec_cfg.attn_impl == "xla" else \
            f", attn={self.exec_cfg.attn_impl}"
        return (f"Engine[{self.backend.name}] {self.exec_cfg.name} on "
                f"{self.device}: params {self.param_bytes} B, "
                f"rom {self.rom_bytes} B, lut {self.lut_bytes} B{q}{kern}"
                f"{attn}")


def _has_qtensors(tree) -> bool:
    return any(isinstance(leaf, quant.QTensor) for leaf in tree_leaves(tree))


def _recipe_from_tree(cfg, tree) -> QuantRecipe:
    """Reconstruct the deployment recipe of an already-quantised tree from
    its own QTensor metadata (bits / exponent / per-channel), so
    ``Engine.recipe`` and ``describe()`` report the artifact's actual
    policy rather than the config default."""
    qleaves = [leaf for leaf in tree_leaves(tree)
               if isinstance(leaf, quant.QTensor)]
    return QuantRecipe.from_config(
        cfg, bits=qleaves[0].bits,
        weight_exponent=min(q.exponent for q in qleaves),
        per_channel=any(q.axis_exponents is not None for q in qleaves))


def _pin_int_exec(exec_cfg, recipe: QuantRecipe):
    """Pin the integer-execution plan flavour onto the exec config: the
    activation quantiser shares the recipe's eq-9 semantics (input
    exponent, residual width), so layers and the artifact agree on the
    fixed-point grid by construction."""
    from repro_torch.configs.base import QuantConfig
    qc = exec_cfg.quant if exec_cfg.quant is not None else QuantConfig()
    qc = dataclasses.replace(qc, input_exponent=recipe.input_exponent,
                             residual_bits=recipe.residual_bits)
    return exec_cfg.with_(int_exec=True, quant=qc)


def _to_device(tree, device):
    return tree_map(
        lambda leaf: leaf.to(device)
        if isinstance(leaf, (torch.Tensor, quant.QTensor)) else leaf, tree)


def compile_model(cfg, params, backend="float",
                  recipe: QuantRecipe | None = None,
                  attention: str | None = None,
                  integer_resident: bool | None = None,
                  integer_exec: bool | None = None,
                  taps: bool = False, device=None) -> Engine:
    """Plan execution of ``params`` under ``backend`` on ``device``.

    ``recipe=None`` -> the backend's default policy: quantising backends
    (lut_float / lut / cuda) derive a QuantRecipe from ``cfg.quant``; the
    float backend leaves params untouched.  Passing an explicit recipe
    forces PTQ on any backend.  ``params`` may also be an
    already-quantised QTensor tree (e.g. one quantised by the reference
    and carried across by ``repro_torch.convert``): it is deployed as-is,
    no float detour and no re-quantisation.

    ``integer_resident`` overrides the backend's weight-residency policy
    (default: ``lut``/``cuda`` keep the stored int8 / nibble-packed int4
    QTensors live; other backends deploy the dequantised float copy).
    ``integer_exec`` overrides the execution policy (default:
    ``lut``/``cuda`` integer-EXECUTE resident plans); ``False`` keeps the
    dequantise-per-call resident plan, whose logits are bit-identical to
    dequantise-first.

    ``device=None`` resolves to the CUDA device and raises when there is
    none.  The ``cuda`` backend on a CPU device raises.
    """
    if taps:
        _later("compile_model(taps=True)", "item 7 (telemetry)")
    be = get_backend(backend)
    device = resolve_device(device)
    if be.uses_kernels and device.type != "cuda":
        raise ValueError(
            f"backend {be.name!r} runs hand-written CUDA kernels and needs a "
            f"CUDA device, got device={str(device)!r}; on the CPU use 'lut', "
            "whose logits the cuda plan reproduces")
    # Full float32 everywhere: see the module docstring.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    params = _to_device(params, device)
    pre_quantized = _has_qtensors(params)
    if recipe is None and pre_quantized:
        recipe = _recipe_from_tree(cfg, params)
    elif recipe is None and be.quantize:
        recipe = QuantRecipe.from_config(cfg)
    qbytes = None
    int_exec = False
    exec_flag = be.int_exec if integer_exec is None else bool(integer_exec)
    if recipe is not None or pre_quantized:
        qtree = params if pre_quantized else recipe.quantize(params)
        # ROM footprint is the artifact's full packed image, independent
        # of which leaves the plan keeps resident.
        qbytes = quant.tree_quantized_bytes(qtree)
        resident = (be.int_resident and cfg.family == "kwt"
                    if integer_resident is None else bool(integer_resident))
        params = qtree if resident else quant.dequantize_tree(qtree)
        int_exec = exec_flag and resident
    if be.uses_kernels and not int_exec:
        raise ValueError(
            f"backend {be.name!r} integer-executes stored weights; it cannot "
            "be planned with integer_resident=False or integer_exec=False")
    exec_cfg = be.configure(cfg, attention=attention)
    if int_exec:
        exec_cfg = _pin_int_exec(exec_cfg, recipe)
    return Engine(cfg=cfg, exec_cfg=exec_cfg, params=params, backend=be,
                  recipe=recipe, device=device, quantized_bytes=qbytes,
                  int_exec=int_exec)
