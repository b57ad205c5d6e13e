"""repro_torch.runtime — one Engine/Backend API for float, LUT and CUDA
kernel execution.

Owns execution policy end to end: which numeric path runs the model
(``Backend`` registry), how params are quantised (``QuantRecipe``), and
the single planning entry point ``compile_model(cfg, params,
backend=..., recipe=..., device=...) -> Engine``.
"""

from repro_torch.runtime.backends import (Backend, available_backends,
                                          get_backend, register_backend)
from repro_torch.runtime.engine import Engine, EngineHandle, compile_model
from repro_torch.runtime.recipe import QuantRecipe


def quantize_params(params, cfg, rounding: str = "nearest"):
    """Compat shim for the old ``launch.serve.quantize_params``: PTQ per
    paper §IV (int8 weights at the Table V exponent, norms/biases float),
    returned as the dequantised float tree the engine runs."""
    return QuantRecipe.from_config(cfg, rounding=rounding).apply(params)


__all__ = ["Backend", "Engine", "EngineHandle", "QuantRecipe",
           "available_backends", "compile_model", "get_backend",
           "quantize_params", "register_backend"]
