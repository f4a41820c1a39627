"""On the card only: one short run of a cell through the command, its
result line as the contract has it."""

from __future__ import annotations

import json
import subprocess
import sys

import pytest
import torch

from benchmark.config import ROOT


@pytest.mark.cuda
def test_a_short_run_prints_the_result_line():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", "gauss-fit",
         "--seed", str(2 ** 33 + 1), "--seconds", "2", "--trace", "1"],
        capture_output=True, text=True, timeout=900, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-4000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert list(res)[-1] == "checks"
    assert {"correct", "attempted", "failed", "metrics", "device",
            "breakdown"} <= set(res)
    assert res["device"]["platform"] == "gpu" and res["device"]["busy_s"] > 0
