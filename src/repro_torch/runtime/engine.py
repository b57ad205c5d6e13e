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

LM engines (the dense, moe, rwkv and hybrid families) expose
``init_decode_state`` / ``prefill`` / ``decode_step`` (and ``forward``:
tokens -> logits) instead, which ``cell.scheduler`` and
``launch/serve.py`` run off (dense and moe; the recurrent families are
served as one drain batch through these entry points, as in the
reference); each kind's entry points raise on the other's engine.
The encdec family (whisper) is planned like the LMs but runs at module
level only (ROADMAP C11): ``models.encdec`` with float params and the
plan's ``exec_cfg``.  Its engine's ``init_decode_state``, ``prefill``,
``decode_step`` and ``forward`` raise ``TypeError`` naming C11 (the
reference's ``prefill`` raises a bare ``TypeError``, since it passes no
frames, so a state from its engine has no use).

Execution is eager under ``torch.inference_mode()``: there is no jit to
plan, so the reference's jitted programs, its flat-leaf dispatch and its
separate unpack executable have no counterpart here.  Capturing the
fixed-shape forward in a CUDA graph is a follow-up.

Telemetry: under an active ``telemetry`` tracer, ``forward``,
``stream_step``, ``prefill`` and ``decode_step`` record the reference's
spans (``forward`` / ``unpack`` / ``encode`` / ``taps``, ``stream_step`` /
``unpack`` / ``hop``, ``prefill`` / ``decode_step`` over ``encode``); the
model's own spans (``stream.engine``'s stages, ``models.layers``' layers)
nest inside them.  No span synchronizes: a span times the host, and its
device time is read from a ``torch.profiler`` trace of the same run
(``telemetry.trace``); with no tracer the path is the untraced one.
``compile_model(taps=True)`` plans the quantisation-health aux
(``telemetry.taps``): a second, tapped pass whose statistics ``forward``
returns beside the logits of the untapped pass.
:class:`EngineHandle` is the swap-safe reference a serving cell holds.

Device rule: ``device=None`` means the card and raises where there is
none; the CPU is used only when the caller passes ``device="cpu"``.  The
``cuda`` backend needs a CUDA device, unless the caller asks for its
plain versions on the CPU (``plain_kernels=True``).

Numerics: ``compile_model`` turns TF32 off for matmuls and cuDNN — the
float score product in TF32 would move logits far beyond every stated
tolerance, and the f32-container integer products rely on exact float32.
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Any, Optional

import torch

from repro_torch.core import lut as lutlib
from repro_torch.core import quant
from repro_torch.core.tree import tree_leaves, tree_map
from repro_torch.device import resolve_device
from repro_torch.runtime.backends import Backend, get_backend
from repro_torch.runtime.recipe import QuantRecipe
from repro_torch.telemetry import taps as _taps
from repro_torch.telemetry import trace as _trace

Pytree = Any


def _model_module(cfg):
    if cfg.family == "kwt":
        from repro_torch.models import kwt
        return kwt
    if cfg.family == "encdec":
        from repro_torch.models import encdec
        return encdec
    from repro_torch.models import transformer
    if cfg.family in transformer.FAMILIES:
        return transformer
    raise ValueError(f"unknown model family {cfg.family!r}")


def _tree_bytes(tree) -> int:
    return sum(x.numel() * x.element_size() for x in tree_leaves(tree)
               if isinstance(x, torch.Tensor))


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
    taps: bool = False              # forward also returns quant-health aux
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
        """Offline forward: mfcc [B,F,T] -> logits [B,n_classes].

        With ``taps`` planned (``compile_model(..., taps=True)``) returns
        ``(logits, aux)`` where ``aux`` maps tap sites to quantisation-
        health scalars (telemetry.taps).  The logits come from the
        untapped pass either way."""
        self._refuse_encdec("forward")
        tr = _trace.active_tracer()
        if tr is None and not self.taps:
            with torch.inference_mode():
                return self._mod.forward(self.live_params(), self._input(x),
                                         self.exec_cfg)
        return self._forward_instrumented(tr, x)

    def _live_traced(self, tr):
        """Operand tree under tracing.  Plans with no unpack stage — float
        params, or integer-EXECUTING packed params — emit no ``unpack``
        span: there is no such stage to attribute."""
        if not (self.int_resident and not self.int_exec):
            return self.params
        with tr.span("unpack"):
            return self.live_params()

    def _forward_instrumented(self, tr, x):
        cfg = self.exec_cfg
        with torch.inference_mode():
            if tr is None:                         # taps only, no tracing
                lp, x = self.live_params(), self._input(x)
                return self._mod.forward(lp, x, cfg), self._run_taps(lp, x)
            with tr.span("forward", {"backend": self.backend.name}):
                lp = self._live_traced(tr)
                with tr.span("encode"):
                    x = self._input(x)
                    logits = self._mod.forward(lp, x, cfg)
                if self.taps:
                    with tr.span("taps"):
                        aux = self._run_taps(lp, x)
                    return logits, aux
            return logits

    def _run_taps(self, lp, x):
        """The aux pass of a ``taps=True`` plan: the forward again, with
        the telemetry.taps collector active, returning ONLY the health
        statistics; served logits never come from this pass."""
        with _taps.collecting() as col:
            logits = self._mod.forward(lp, x, self.exec_cfg)
            _taps.tap_activation("logits", logits, self.exec_cfg)
        return _taps.pack(col)

    def embed_frames(self, frames):
        """[B, t, F] time-major frames -> [B, t, d] patch embeddings."""
        self._require_kwt("embed_frames")
        with torch.inference_mode():
            return self._mod.embed_frames(self.live_params(),
                                          self._input(frames), self.exec_cfg)

    def encode_window(self, window):
        """Assembled [B, T, d] window -> logits [B, n_classes]."""
        self._require_kwt("encode_window")
        with torch.inference_mode():
            return self._mod.encode_window(self.live_params(),
                                           self._input(window), self.exec_cfg)

    def stream_step(self, state, chunk, fcfg):
        """One hop of incremental inference (``stream.engine.stream_step``
        under this engine's plan): (state, chunk [B, k*hop]) -> (state,
        logits).  ``state`` comes from ``stream.engine.init_stream_state``
        on this engine's device; ``chunk`` may be numpy or a tensor
        anywhere and is moved there."""
        self._require_kwt("stream_step")
        from repro_torch.stream import engine as stream_engine
        tr = _trace.active_tracer()
        if tr is None:
            with torch.inference_mode():
                return stream_engine.stream_step(
                    self.live_params(), state, self._input(chunk),
                    self.exec_cfg, fcfg)
        with tr.span("stream_step", {"backend": self.backend.name}):
            lp = self._live_traced(tr)
            with tr.span("hop"), torch.inference_mode():
                return stream_engine.stream_step(
                    lp, state, self._input(chunk), self.exec_cfg, fcfg)

    # -- LM serving entry points ------------------------------------------

    def init_decode_state(self, batch: int, max_len: int):
        """Zero decode state for ``batch`` lanes of ``max_len`` tokens on
        the engine's device, index 0 (ordinary tensors: the caller may
        edit them; ``prefill`` / ``decode_step`` write them in place): KV
        caches (for hybrid a ring of ``min(max_len, sliding_window)``
        slots) in the dtype the plan computes keys and values in
        (``kv_dtype``: float32 on the integer plans, whose blocks are a
        float32 view; int8 codes and float32 scales whatever the plan
        under ``cfg.quant.quantize_kv_cache``), and the recurrences of
        rwkv and hybrid."""
        self._require_lm("init_decode_state")
        self._refuse_encdec("init_decode_state")
        return self._mod.init_decode_state(
            self.exec_cfg, batch, max_len, device=self.device,
            dtype=self._mod.kv_dtype(self.params, self.exec_cfg))

    def prefill(self, tokens, state):
        """tokens [B, S] -> (last logits [B, V], state); the caches of
        ``state`` are written in place (``models.transformer``)."""
        return self._lm_call("prefill", tokens, state)

    def decode_step(self, token, state):
        """token [B] -> (logits [B, V], state), one token on every lane."""
        return self._lm_call("decode_step", token, state)

    def _lm_call(self, what: str, tokens, state):
        self._require_lm(what)
        self._refuse_encdec(what)
        fn = getattr(self._mod, what)
        tr = _trace.active_tracer()
        if tr is None:
            with torch.inference_mode():
                return fn(self.live_params(), self._input(tokens),
                          self.exec_cfg, state)
        with tr.span(what, {"backend": self.backend.name}):
            lp = self._live_traced(tr)
            with tr.span("encode"), torch.inference_mode():
                return fn(lp, self._input(tokens), self.exec_cfg, state)

    def _require_kwt(self, what: str):
        if self.exec_cfg.family != "kwt":
            raise NotImplementedError(
                f"{what} is a KWT streaming entry point; family="
                f"{self.exec_cfg.family!r} engines expose forward/prefill/"
                "decode_step")

    def _refuse_encdec(self, what: str):
        if self.exec_cfg.family == "encdec":
            raise TypeError(
                f"Engine.{what} does not drive the encdec family (ROADMAP "
                "C11): call repro_torch.models.encdec (encode, prefill, "
                "decode_step) with float params and this plan's exec_cfg")

    def _require_lm(self, what: str):
        if self.exec_cfg.family == "kwt":
            raise NotImplementedError(
                f"{what} is an LM serving entry point; family='kwt' engines "
                "expose forward/stream_step/embed_frames/encode_window")

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

    def describe(self, analyze: bool = False, cost: bool = False) -> str:
        """One-line plan summary.  ``cost=True`` appends the static cost
        model's totals (``repro_torch.perf``) plus the paper-style
        per-(stage, op) table priced on the RV32 MCU model — the one-stop
        answer to "what does this plan cost and where".  ``analyze=True``
        appends the static-analysis verdict (``repro_torch.analysis``),
        running the pass pipeline on first use; a verdict cached by an
        earlier ``check_engine`` call is appended either way."""
        if analyze and not hasattr(self, "_analysis_verdict"):
            from repro_torch import analysis
            analysis.check_engine(self)
        q = "" if self.recipe is None else \
            f", w=2^{self.recipe.weight_exponent}" \
            f"/x=2^{self.recipe.input_exponent} " \
            f"int{self.recipe.bits} {self.recipe.rounding}" + \
            (" int-exec" if self.int_exec else
             " resident" if self.int_resident else "")
        kern = "" if not self.backend.uses_kernels else \
            ", kernels=cuda" if self.device.type == "cuda" else \
            ", kernels=cuda (their plain versions on the cpu)"
        attn = "" if self.exec_cfg.attn_impl == "xla" else \
            f", attn={self.exec_cfg.attn_impl}"
        verdict = getattr(self, "_analysis_verdict", None)
        verdict = f" | {verdict}" if verdict else ""
        line = (f"Engine[{self.backend.name}] {self.exec_cfg.name} on "
                f"{self.device}: params {self.param_bytes} B, "
                f"rom {self.rom_bytes} B, lut {self.lut_bytes} B{q}{kern}"
                f"{attn}{verdict}")
        if cost:
            from repro_torch import perf
            rep = perf.engine_cost(self, batch=1)
            mcu = perf.PAPER_MCU
            line += (f" | cost/fwd: {rep.flops:.0f} flops, "
                     f"{rep.bytes:.0f} B moved, AI {rep.intensity:.2f}, "
                     f"~{mcu.cycles(rep.flops, rep.bytes):.3g} "
                     f"{mcu.name} cycles\n" + rep.table(mcu))
        return line


class EngineHandle:
    """A swap-safe reference to the live Engine of a serving cell.

    Serving loops read ``handle.engine`` each hop; ``cell.hotswap``
    replaces the Engine atomically under the handle's lock after warming
    and probe-parity verification.  Lane state (stream rings, detector
    state) lives outside the Engine, so a swap changes only params — in-
    flight lanes keep their positions and no hop is dropped.

    ``swap`` enforces plan compatibility by default: the incoming Engine
    must share the exec config (same arch dims + pinned modes), the
    device, and a param tree of identical structure and leaf shapes,
    compared leaf by leaf in the trees' own (insertion) order on both
    sides.
    """

    def __init__(self, engine: Engine):
        self._lock = threading.Lock()
        self._engine = engine
        self._generation = 0
        self._live_cache = None          # (generation, operand tree)

    @property
    def engine(self) -> Engine:
        return self._engine

    @property
    def generation(self) -> int:
        """Bumps once per completed swap (serving loops key caches on it)."""
        return self._generation

    def live_params(self):
        """The current Engine's operand tree, cached per generation (one
        unpack per swap instead of one per hop for non-executing resident
        plans; see :meth:`Engine.live_params`)."""
        with self._lock:
            gen, eng = self._generation, self._engine
        cache = self._live_cache
        if cache is not None and cache[0] == gen:
            return cache[1]
        with torch.inference_mode():
            live = eng.live_params()
        self._live_cache = (gen, live)
        return live

    def swap(self, new_engine: Engine, *, strict: bool = True) -> Engine:
        """Install ``new_engine``; returns the Engine it replaced."""
        if strict:
            old = self._engine
            if new_engine.exec_cfg != old.exec_cfg:
                raise ValueError(
                    "hot-swap across exec configs would change the serving "
                    f"plan mid-traffic: {old.exec_cfg.name}/{old.backend.name}"
                    f" -> {new_engine.exec_cfg.name}/"
                    f"{new_engine.backend.name} (swap(strict=False) to force)")
            if new_engine.device != old.device:
                raise ValueError(f"hot-swap across devices: {old.device} -> "
                                 f"{new_engine.device}")
            old_shapes = [tuple(getattr(x, "shape", ()))
                          for x in tree_leaves(old.params)]
            new_shapes = [tuple(getattr(x, "shape", ()))
                          for x in tree_leaves(new_engine.params)]
            if old_shapes != new_shapes:
                raise ValueError("hot-swap param tree shape mismatch")
        with self._lock:
            old, self._engine = self._engine, new_engine
            self._generation += 1
            self._live_cache = None
        return old


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


def _lm_partial_resident(qtree: dict) -> dict:
    """LM partial residency: keep the big vocab-facing leaves (embedding
    table / untied head) packed for integer execution, dequantise the
    stacked blocks.  The embedding is consumed row-wise through
    ``quant.gather_descale`` and the head through the integer matmul
    (the CUDA kernel on the ``cuda`` plan); the blocks' per-channel
    exponents have no layer axis to slice, so the blocks run their float
    view (float32), as in the reference."""
    packed = {k: v for k, v in qtree.items() if k in ("embed", "lm_head")}
    rest = {k: v for k, v in qtree.items() if k not in packed}
    return {**quant.dequantize_tree(rest), **packed}


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
                  taps: bool = False, device=None,
                  plain_kernels: bool = False) -> Engine:
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

    ``taps=True`` plans the quantisation-health aux: ``forward`` returns
    ``(logits, aux)`` where aux carries per-layer int8 saturation, LUT
    out-of-domain fractions and Q8.24 headroom (telemetry.taps), from a
    second pass; the logits are the untapped pass's, equal to a
    ``taps=False`` plan's.

    The LM families (dense, moe, rwkv, hybrid, encdec) get PARTIAL
    residency under an integer-executing backend (``lut`` / ``cuda``):
    embedding and head stay packed, the blocks are dequantised, and the
    plan is pinned integer-executing (``_lm_partial_resident``);
    ``integer_resident`` overrides that as it does for KWT.

    ``device=None`` resolves to the CUDA device and raises when there is
    none.  The ``cuda`` backend on a CPU device raises, unless
    ``plain_kernels=True`` asks for its plain versions there (every kernel
    wrapper takes its plain version for a CPU tensor): the kernel plan's
    rehearsal on the host, by explicit request only.
    """
    be = get_backend(backend)
    device = resolve_device(device)
    if be.uses_kernels and device.type != "cuda" and not plain_kernels:
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
        if integer_resident is not None or cfg.family == "kwt":
            resident = (be.int_resident and cfg.family == "kwt"
                        if integer_resident is None
                        else bool(integer_resident))
            params = qtree if resident else quant.dequantize_tree(qtree)
            int_exec = exec_flag and resident
        elif exec_flag and be.int_resident and isinstance(qtree, dict) \
                and "embed" in qtree:
            params = _lm_partial_resident(qtree)
            int_exec = True
        else:
            params = quant.dequantize_tree(qtree)
        del qtree
    if be.uses_kernels and not int_exec:
        raise ValueError(
            f"backend {be.name!r} integer-executes stored weights; it cannot "
            "be planned with integer_resident=False or integer_exec=False")
    exec_cfg = be.configure(cfg, attention=attention)
    if int_exec:
        exec_cfg = _pin_int_exec(exec_cfg, recipe)
    return Engine(cfg=cfg, exec_cfg=exec_cfg, params=params, backend=be,
                  recipe=recipe, device=device, quantized_bytes=qbytes,
                  taps=taps, int_exec=int_exec)
