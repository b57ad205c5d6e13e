"""A new cell and a new per-layer metric are picked up by adding files
and entries alone: a fixture workload and a fixture reader in a
temporary copy of the benchmark, no file of it edited but
BENCHMARK.json."""

import json
import shutil
import time

from bench.core import runner
from bench.core.spec import Spec
from bench.tests import tiny
from bench.tests.conftest import ROOT


def test_a_cell_and_a_metric_added_as_files(tmp_path):
    shutil.copytree(ROOT / "bench", tmp_path / "bench")
    doc = json.loads((ROOT / "BENCHMARK.json").read_text())
    wl = json.loads((ROOT / "bench/workloads/kwt1.bulk.json").read_text())
    wl.update(traffic="bulk_16", why="a fixture: 16 windows a call")
    wl["params"]["batch"] = 16
    (tmp_path / "bench/workloads/kwt1.fixture.json").write_text(
        json.dumps(wl))
    (tmp_path / "bench/metrics/calls_seen.py").write_text(
        "def read(name, run):\n    return float(run.calls)\n")
    doc["workloads"].append({"name": "kwt1.fixture", "config": "kwt-1",
                             "traffic": "bulk_16", "chips": 1,
                             "why": wl["why"]})
    for m in doc["end_to_end"]:
        if m["name"] == "windows_per_s":
            m["workloads"].append("kwt1.fixture")
    doc["per_layer"].append({"name": "calls_seen.fixture", "unit": "calls",
                             "better": "higher", "source": "host_clock",
                             "layer": "entry", "moves": "windows_per_s",
                             "workloads": ["kwt1.fixture"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(doc))

    spec = Spec(tmp_path)
    ctx = runner.context(spec, "kwt1.fixture", 9, "cpu",
                         plan={"backend": "lut"},
                         model_overrides=tiny.KWT)
    res = runner.run(ctx, 0.2, False, time.perf_counter())
    assert res["correct"] and "windows_per_s" in res["metrics"]
    res = runner.run(ctx, 0.2, True, time.perf_counter())
    assert res["metrics"]["calls_seen.fixture"]["value"] >= 1
    assert "mfu_pct.bulk" not in res["metrics"]


TOY_MODEL = '''"""A fixture family: one matrix, one product a call."""


def layout(model):
    return {"w": ((model["d_model"], model["d_ff"]), "matrix"),
            "b": ((model["d_ff"],), "vector")}


def flops(model, work):
    return 2.0 * work["batch"] * model["d_model"] * model["d_ff"]


def kernel_work(config, work):
    m = config["model"]
    return {"int8_matmul": [(work["batch"], m["d_model"], m["d_ff"], 4,
                             config["quant"]["per_channel"])]}
'''


def test_a_model_family_added_as_files(tmp_path):
    """A family the harness has never seen (its weight layout, FLOPs, the
    shapes of its kernels' work and its reference) is found by the
    configuration's ``model.family``: core/, metrics/ and kernels/ hold no
    branch on a family."""
    import torch

    from bench.core.trace import Trace
    shutil.copytree(ROOT / "bench", tmp_path / "bench")
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    (tmp_path / "bench/models/toy.py").write_text(TOY_MODEL)
    (tmp_path / "bench/ref/toy.py").write_text(
        "def forward(w, x):\n    return x @ w['w'] + w['b']\n")
    spec = Spec(tmp_path)
    config = {"model": {"family": "toy", "d_model": 8, "d_ff": 16},
              "quant": {"per_channel": False}, "mfu_peak_flops": 1e12,
              "weights": {"norm_mean": 1.0, "norm_std": 0.1,
                          "vector_std": 0.1}}
    ctx = runner.Context(spec, {"params": {}}, config, 3,
                         torch.device("cpu"), {})
    tree = ctx.weights()
    assert tree["w"].shape == (8, 16) and tree["b"].shape == (16,)
    x = torch.ones(2, 8)
    assert spec.reference("toy").forward(tree, x).shape == (2, 16)

    class Cell:
        def work(self):
            return {"batch": 4}
    trace = Trace(1.0, [(0, 10**6, "int8_matmul_kernel")], [])
    info = runner.RunInfo(spec, Cell(), config["model"], config, {},
                          calls=5, window_s=2.0, traced_calls=2,
                          trace=trace)
    mfu = spec.reader("mfu_pct.toy").read("mfu_pct.toy", info)
    assert mfu == 100.0 * 5 * 2 * 4 * 8 * 16 / 2.0 / 1e12
    roof = spec.reader("roof_pct.int8_matmul.toy").read(
        "roof_pct.int8_matmul.toy", info)
    ops, nbytes, peak = spec.kernel_family("int8_matmul").product(
        4, 8, 16, 4, False)
    least = max(nbytes / 3.35e12, ops / peak)
    assert roof == 100.0 * least * 2 / 1e-3
