"""The benchmark's own tests: its modules are imported from ``benchmark/``
(as ``run.py`` imports them) and the port from the repository's root."""

import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parent.parent
for p in (str(BENCH.parent), str(BENCH)):
    if p not in sys.path:
        sys.path.insert(0, p)


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (on the H100: python -m pytest -m cuda benchmark/tests)")
    return torch.device("cuda")
