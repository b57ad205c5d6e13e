"""The benchmark as data: ``BENCHMARK.json`` and the files it names.

A cell, a configuration, a traffic kind, a per-layer metric and a kernel
family are each found by name under the benchmark's folder, so a later
change adds one by adding files and entries and edits nothing here:

* ``bench/workloads/<cell>.json``  the cell: config, traffic, kind,
  its parameters, the limits of its checks, why it exists;
* ``bench/configs/<config>.json``  the configuration as it is run (the
  file ``BENCHMARK.json`` names);
* ``bench/traffic/<kind>.py``      the generator and driver of one kind
  of traffic (``Cell``);
* ``bench/metrics/<metric>.py``    a per-layer metric's reader; a name
  with no file of its own falls back to the file of its first dotted
  part (``mfu_pct.bulk`` -> ``mfu_pct.py``), which reads the rest;
* ``bench/kernels/<family>.py``    a kernel family's cost of a shape,
  and its kernels' names;
* ``bench/models/<family>.py``     a model family (the configuration's
  ``model.family``): its weight layout, its FLOPs of a call, and the
  shapes of a call's work for each kernel family;
* ``bench/ref/<name>.py``          a plain reference, by the name a
  traffic kind asks for (the model family's, or ``<family>_stream``).
"""

from __future__ import annotations

import importlib.util
import json
import re
import sys
from pathlib import Path

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


class Spec:
    """The benchmark under the checkout ``root``."""

    def __init__(self, root: Path):
        self.root = Path(root)
        self.bench = self.root / "bench"
        self.doc = json.loads((self.root / "BENCHMARK.json").read_text())
        self.cells = {w["name"]: w for w in self.doc["workloads"]}
        self.configs = {c["name"]: c for c in self.doc["configs"]}

    # -- files ------------------------------------------------------------

    def workload(self, cell: str) -> dict:
        """The cell's entry merged with its file; the two must agree on
        the configuration and the traffic."""
        entry = self.cells.get(cell)
        if entry is None:
            raise KeyError(f"no workload {cell!r} in BENCHMARK.json")
        wl = json.loads((self.bench / "workloads" / f"{cell}.json")
                        .read_text())
        for key in ("config", "traffic"):
            if wl[key] != entry[key]:
                raise ValueError(f"{cell}: {key} {wl[key]!r} in its file, "
                                 f"{entry[key]!r} in BENCHMARK.json")
        return {**wl, "name": cell, "chips": entry["chips"]}

    def config(self, name: str) -> dict:
        return json.loads((self.root / self.configs[name]["file"])
                          .read_text())

    def traffic(self, kind: str):
        return load(self.bench / "traffic" / f"{kind}.py")

    def reader(self, metric: str):
        own = self.bench / "metrics" / f"{metric}.py"
        if own.exists():
            return load(own)
        return load(self.bench / "metrics" / f"{metric.split('.')[0]}.py")

    def kernel_family(self, family: str):
        return load(self.bench / "kernels" / f"{family}.py")

    def model_family(self, family: str):
        return load(self.bench / "models" / f"{family}.py")

    def reference(self, name: str):
        return load(self.bench / "ref" / f"{name}.py")

    # -- which metrics a cell reports --------------------------------------

    def end_to_end(self, cell: str) -> list[dict]:
        return [m for m in self.doc["end_to_end"]
                if cell in m.get("workloads", [cell])]

    def per_layer(self, cell: str) -> list[dict]:
        mine = {m["name"] for m in self.end_to_end(cell)}

        def reported(m):
            if "workloads" in m:
                return cell in m["workloads"]
            return m["moves"] in mine
        return [m for m in self.doc["per_layer"] if reported(m)]


def load(path: Path):
    """Import a file of the benchmark by its path (its name may hold dots)."""
    path = Path(path)
    key = "bench_file_" + re.sub(r"\W", "_", str(path))
    if key in sys.modules:
        return sys.modules[key]
    spec = importlib.util.spec_from_file_location(key, path)
    if spec is None or not path.exists():
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[key] = mod
    spec.loader.exec_module(mod)
    return mod
