"""--arch name resolution.  The port's registry holds the two KWT
entries; the LM families join it with their slice of the port."""

from __future__ import annotations

import importlib

ARCHS = {
    "kwt-1": "kwt_1",
    "kwt-tiny": "kwt_tiny",
}


def get(name: str):
    """Return the ArchEntry for an --arch id."""
    mod = importlib.import_module(f"repro_torch.configs.{ARCHS[name]}")
    return mod.ENTRY


def all_entries():
    return {name: get(name) for name in ARCHS}
