"""Nothing a run loads is JAX or the JAX package, and the references load
nothing of the program.  Top-level module names are compared whole:
``repro_torch`` is the port, ``repro`` the JAX package."""

import ast
import json
import subprocess
import sys

from bench.tests.conftest import ROOT

FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_no_file_of_the_benchmark_imports_jax_or_the_jax_package():
    for path in (ROOT / "bench").rglob("*.py"):
        tops = {name.split(".")[0] for name in _imports(path)}
        assert not tops & FORBIDDEN, (path, tops & FORBIDDEN)


def test_references_import_nothing_of_the_program():
    for path in (ROOT / "bench" / "ref").glob("*.py"):
        for name in _imports(path):
            assert name.split(".")[0] not in FORBIDDEN | {"repro_torch"}, \
                (path, name)
            if name.startswith("bench."):
                assert name.startswith("bench.ref"), (path, name)


def test_a_rehearsed_run_loads_no_jax():
    """A run of every traffic kind, in a fresh process: the modules loaded
    once the windows have closed."""
    code = f"""
import json, sys
sys.path[:0] = [{str(ROOT)!r}, {str(ROOT / 'src')!r}]
from bench.core.spec import Spec
from bench.tests import tiny
sys.argv = ['run.py']
spec = Spec(__import__('pathlib').Path({str(ROOT)!r}))
for cell in ('kwt1.bulk', 'kwt1.streams', 'internlm2.score_8k'):
    tiny.run(spec, cell, seconds=0.05)
sys.path.insert(0, {str(ROOT / 'bench')!r})
import run
print(json.dumps(run.forbidden_modules()))
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


def test_the_command_refuses_without_a_card_or_the_port(tmp_path):
    """No card here: exit non-zero, no result.  In a directory that holds
    only BENCHMARK.json and bench/: the same."""
    import os
    import shutil
    cmd = [sys.executable, "bench/run.py", "--workload", "kwt1.bulk",
           "--seed", "1", "--seconds", "1", "--trace", "0"]
    out = subprocess.run(cmd, capture_output=True, text=True, cwd=ROOT,
                         timeout=300, env={**os.environ,
                                           "CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode != 0 and out.stdout.strip() == ""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "bench", tmp_path / "bench")
    out = subprocess.run(cmd, capture_output=True, text=True, cwd=tmp_path,
                         timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""
