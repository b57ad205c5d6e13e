"""repro_torch.runtime — one Engine/Backend API for float, LUT and CUDA
kernel execution.

Owns execution policy end to end: which numeric path runs the model
(``Backend`` registry), how params are quantised (``QuantRecipe``), and
the single planning entry point ``compile_model(cfg, params,
backend=..., recipe=..., device=...) -> Engine``.
"""

from repro_torch.runtime.backends import (Backend, available_backends,
                                          get_backend, register_backend)
from repro_torch.runtime.engine import Engine, compile_model
from repro_torch.runtime.recipe import QuantRecipe

__all__ = ["Backend", "Engine", "QuantRecipe", "available_backends",
           "compile_model", "get_backend", "register_backend"]
