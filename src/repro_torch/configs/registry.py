"""--arch name resolution for launchers, tests and the smoke run.

Every name of the reference's registry resolves here.  Of the LM
families only ``dense`` has a model module in the port so far
(``launch.steps.model_module`` raises for the others and names their
ROADMAP item)."""

from __future__ import annotations

import importlib

ARCHS = {
    "granite-moe-3b-a800m": "granite_moe_3b_a800m",
    "deepseek-moe-16b": "deepseek_moe_16b",
    "chameleon-34b": "chameleon_34b",
    "whisper-large-v3": "whisper_large_v3",
    "hymba-1.5b": "hymba_1_5b",
    "rwkv6-3b": "rwkv6_3b",
    "nemotron-4-340b": "nemotron_4_340b",
    "granite-8b": "granite_8b",
    "internlm2-1.8b": "internlm2_1_8b",
    "qwen2.5-14b": "qwen2_5_14b",
    "kwt-1": "kwt_1",
    "kwt-tiny": "kwt_tiny",
}

ASSIGNED = [k for k in ARCHS if not k.startswith("kwt")]

# the dense decoder-only LMs: the family this port serves
DENSE = [k for k in ASSIGNED
         if importlib.import_module(f"repro_torch.configs.{ARCHS[k]}")
         .CONFIG.family == "dense"]


def get(name: str):
    """Return the ArchEntry for an --arch id."""
    mod = importlib.import_module(f"repro_torch.configs.{ARCHS[name]}")
    return mod.ENTRY


def all_entries():
    return {name: get(name) for name in ARCHS}
