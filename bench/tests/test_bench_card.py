"""The command itself on a card: one short run of a cell prints the
contract's line with ``correct`` true and loads no JAX (``run.py`` exits
non-zero otherwise).  Skips where there is no card."""

import json
import subprocess
import sys

import pytest

from bench.tests.conftest import ROOT


@pytest.mark.card
def test_a_short_run_on_the_card(card):
    out = subprocess.run(
        [sys.executable, "bench/run.py", "--workload", "kwt1.bulk", "--seed",
         "2147483999", "--seconds", "2", "--trace", "1"],
        capture_output=True, text=True, cwd=ROOT, timeout=900)
    assert out.returncode == 0, out.stderr[-4000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"] and res["device"]["platform"] == "gpu"
    assert set(res) >= {"correct", "attempted", "failed", "metrics",
                        "device", "breakdown", "checks"}
    assert list(res)[-1] == "checks"
