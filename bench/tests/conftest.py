"""Test settings of the benchmark's own tests (``python -m pytest
bench/tests``; the repository's tier-1 run does not collect them).

``card``: a test that needs a CUDA card; its ``card`` fixture skips it,
at run time, where there is none."""

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)


def pytest_configure(config):
    config.addinivalue_line("markers",
                            "card: needs a CUDA card (skips without one)")


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card")
    return torch.device("cuda")


@pytest.fixture(scope="session")
def spec():
    from bench.core.spec import Spec
    return Spec(ROOT)
