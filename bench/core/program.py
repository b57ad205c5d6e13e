"""The system under test, built from a configuration file: the port's
``ModelConfig`` with the file's ``model`` fields, the file's ``quant``
recipe, and an ``Engine`` planned by ``runtime.compile_model`` under the
file's ``plan``.  The benchmark touches the program only through this
module, the traffic kinds and the kernel names its readers match."""

from __future__ import annotations

import dataclasses

import torch


def model_config(config: dict, **overrides):
    from repro_torch.configs import registry
    from repro_torch.configs.base import ModelConfig

    names = {f.name for f in dataclasses.fields(ModelConfig)}
    kw = {k: tuple(v) if isinstance(v, list) else v
          for k, v in {**config["model"], **overrides}.items() if k in names}
    return registry.get(config["registry"]).config.with_(**kw)


def compile_engine(config: dict, cfg, tree: dict, device: torch.device,
                   plan: dict):
    """``runtime.compile_model`` of ``tree`` under ``plan`` (``backend``,
    ``attention``, and ``quant`` overriding the file's recipe)."""
    from repro_torch import runtime

    recipe = runtime.QuantRecipe(**{**config["quant"],
                                    **plan.get("quant", {})})
    return runtime.compile_model(
        cfg, tree, backend=plan["backend"], recipe=recipe,
        attention=plan.get("attention"), device=device,
        plain_kernels=device.type == "cpu")
