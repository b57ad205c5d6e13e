"""BENCHMARK.json against the contract's form, and the files it names."""

import json
import re

from bench.core.spec import NAME, UNIT

TOP = {"command", "paths", "run_seconds", "configs", "workloads",
       "end_to_end", "per_layer"}
TEXT = re.compile(r"^[^\n\t]{1,200}$")


def test_top_level_keys_and_command(spec):
    doc = spec.doc
    assert set(doc) == TOP
    assert doc["command"] == ["python3", "bench/run.py"]
    assert doc["paths"] == ["bench"]
    assert 1 <= doc["run_seconds"] <= 51
    assert len((spec.root / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_names_units_and_text(spec):
    doc = spec.doc
    names = [c["name"] for c in doc["configs"]] \
        + [w["name"] for w in doc["workloads"]] \
        + [m["name"] for m in doc["end_to_end"] + doc["per_layer"]]
    assert len(names) == len(set(names))
    for n in names + [w["traffic"] for w in doc["workloads"]] \
            + [k for c in doc["configs"] for k in c["reduced"]]:
        assert NAME.match(n), n
    for m in doc["end_to_end"] + doc["per_layer"]:
        assert UNIT.match(m["unit"]), m
        assert m["better"] in ("lower", "higher")
    for w in doc["workloads"]:
        assert TEXT.match(w["why"]) and w["chips"] in (1, 4)
    for c in doc["configs"]:
        assert TEXT.match(c["why"]) and TEXT.match(c["source"])
        assert c["file"].startswith("bench/")
    for m in doc["per_layer"]:
        assert TEXT.match(m["layer"])


def test_entry_keys(spec):
    doc = spec.doc
    for c in doc["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
    for w in doc["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
    for m in doc["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in doc["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")


def test_every_cell_reports_setup_another_e2e_and_a_layer(spec):
    for cell in spec.cells:
        e2e = {m["name"] for m in spec.end_to_end(cell)}
        assert "setup_s" in e2e and len(e2e) >= 2, cell
        assert spec.per_layer(cell), cell


def test_per_layer_cells_report_what_they_move(spec):
    for m in spec.doc["per_layer"]:
        assert m["moves"] in {e["name"] for e in spec.doc["end_to_end"]}
        for cell in m["workloads"]:
            assert m["moves"] in {e["name"] for e in spec.end_to_end(cell)}


def test_workload_and_config_files(spec):
    used = set()
    for cell, entry in spec.cells.items():
        wl = spec.workload(cell)
        assert (spec.root / spec.configs[entry["config"]]["file"]).exists()
        assert (spec.bench / "traffic" / f"{wl['kind']}.py").exists()
        assert wl["limits"] and wl["why"] == entry["why"]
        used.add(entry["config"])
        pair = (entry["config"], entry["traffic"])
        assert pair not in used, pair
        used.add(pair)
    assert {c["name"] for c in spec.doc["configs"]} <= used


def test_config_files_state_what_runs(spec):
    from repro_torch.configs import registry
    for name in spec.configs:
        cfg = spec.config(name)
        assert cfg["name"] == name and cfg["source"] == \
            spec.configs[name]["source"]
        reg = registry.get(cfg["registry"]).config
        for key in ("n_layers", "d_model", "n_heads", "n_kv_heads",
                    "head_dim", "d_ff", "vocab_size"):
            assert cfg["model"][key] == getattr(reg, key), (name, key)


def test_every_metric_has_a_reader(spec):
    for m in spec.doc["per_layer"]:
        assert hasattr(spec.reader(m["name"]), "read"), m["name"]
    for cell in spec.cells:
        for m in spec.per_layer(cell):
            if m["name"].startswith("roof_pct."):
                fam = spec.kernel_family(m["name"].split(".")[1])
                assert fam.KERNELS and callable(fam.work)
    json.dumps(spec.doc)
