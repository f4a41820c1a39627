"""The check that decides ``correct``: the control (the reference in
TF32, put in the program's place) comes out not correct, and so does a
run with each fault of ``faults.py`` planted under the timed path, with
the cells' own limits.  On the CPU, at sizes a test run holds; the
benchmark's runs make neither."""

from __future__ import annotations

import time

import math

import pytest
import torch

from benchmark import faults, run, sampler
from benchmark.compare import max_abs_gap
from benchmark.reference import model as rm

from _cells import tiny_cell

#: what each cell's fault can reach: a decode has no M-step
CELL_FAULTS = {
    "ns-decode": ("half_batch", "answer_altered", "nan_answer"),
    "gauss-fit": faults.FAULTS,
}
SIZES = {"ns-decode": dict(T=1500), "gauss-fit": dict(T=1200, n_iter=4)}


@pytest.mark.parametrize("bad", [float("nan"), float("inf")])
def test_a_gap_over_a_non_finite_entry_is_infinite(bad):
    """One entry that is not finite, in any block of rows, makes the gap
    infinite: it never reads as a small finite gap."""
    ref = torch.zeros(10, 3, dtype=torch.float64)
    prog = torch.full((10, 3), 1e-9)
    prog[7, 1] = bad
    assert max_abs_gap(prog, ref, rows=4) == math.inf
    assert max_abs_gap(torch.full((10, 3), 1e-9), ref, rows=4) < 1e-8


def _broken(checks):
    return [k for k, c in checks.items() if not c["value"] <= c["limit"]]


@pytest.mark.parametrize("name", sorted(CELL_FAULTS))
def test_control_is_not_correct(manifest, name):
    """The control at the configurations' widths (N = L = 500), a short
    recording: at least one compared number breaks its limit."""
    size = dict(SIZES[name])
    cell = tiny_cell(manifest, name, N=500, L=500, **size)
    pm = run.import_program()
    data = sampler.sample(cell.config, cell.traffic["T"], 11, "cpu")
    entry = run.entry_class(cell.traffic["entry"])(pm, cell, data, 11,
                                                   torch.device("cpu"))
    if cell.traffic["entry"] == "fit":
        from benchmark.entries.fit import fit_seed

        entry.kept = {"fit_seed": fit_seed(11, entry.keep_index)}
    numbers = entry.compare(entry.control(rm.TF32))
    checks = {k: {"value": numbers[k], "limit": v}
              for k, v in cell.limits.items()}
    assert _broken(checks), checks


@pytest.mark.parametrize("name,fault", [
    (n, f) for n, fs in CELL_FAULTS.items() for f in fs])
def test_a_planted_fault_is_not_correct(manifest, name, fault):
    """A run driven as the benchmark drives it, without its look for a
    card, with the timed path broken underneath: ``correct`` is false."""
    cell = tiny_cell(manifest, name, **SIZES[name])
    pm = run.import_program()
    with faults.planted(fault, pm):
        res = run.run_cell(cell, manifest, 2 ** 31 + 7, 0.0, 0, "cpu",
                           time.perf_counter())
    assert res["correct"] is False, res["checks"]
    assert _broken(res["checks"])


def test_faults_are_removed_again(manifest):
    pm = run.import_program()
    from poor_man_gplvm_tpu_torch.models import base
    from poor_man_gplvm_tpu_torch.ops import hmm

    before = (base._PoissonFamily.m_step, hmm._loglik,
              base._GPLVMCommon.fit_em)
    for fault in faults.FAULTS:
        with faults.planted(fault, pm):
            pass
    assert (base._PoissonFamily.m_step, hmm._loglik,
            base._GPLVMCommon.fit_em) == before
