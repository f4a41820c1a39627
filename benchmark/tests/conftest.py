"""Fixtures of the benchmark's CPU tests (run them with
``python -m pytest benchmark/tests``)."""

from __future__ import annotations

import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from benchmark.config import load_manifest  # noqa: E402

# the tests' tensors are small: a few threads per worker process, not one
# per core in each of them
torch.set_num_threads(2)


@pytest.fixture(scope="session")
def manifest():
    return load_manifest()

