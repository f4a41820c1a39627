"""The ``sweep`` cell: its manifest entries and files, its six per-layer
readers on synthetic spans and traces, the grid's work counts by hand,
and its check against the control and the faults of ``faults_sweep.py``,
on the CPU with the grid cut to 2 x 2 configurations x 2 chains."""

from __future__ import annotations

import math
import time
import types

import pytest
import torch

from benchmark import faults_sweep, roofline, roofline_grid, run, sampler
from benchmark.config import Cell, metric_reader
from benchmark.entries import sweep as entry_sweep
from benchmark.reference import model as rm
from poor_man_gplvm_tpu_torch.utils import profiling

from _cells import tiny_cell

READERS = ("adam_steps_per_em_iter.sweep", "adam_live_pct.sweep",
           "adam_ms_per_em_iter.sweep", "scan_batch_roofline.sweep",
           "mfu.sweep", "device_idle_pct.sweep")
LIMITS = ("lml_first_rel", "change_rel", "lml_last_rel", "lml_final_rel",
          "marg_final_gap")
MS = 1_000_000  # ns


def test_the_cell_its_configuration_traffic_and_limits(manifest):
    cell = Cell.load("sweep", manifest)
    cfg = cell.config
    assert cfg.name == "poisson-jump-grid64-n500-l500"
    assert (cfg.n_neuron, cfg.n_latent, cfg.n_dyn) == (500, 500, 2)
    assert (cfg.family, cfg.link, cfg.matmul_precision,
            cfg.scan_precision) == ("poisson", "softplus", "highest",
                                    "highest")
    ranges, n_repeat = entry_sweep.grid_spec(cfg)
    assert ranges == {"movement_variance": [0.5, 1.0, 2.0, 4.0],
                      "p_move_to_jump": [0.005, 0.01, 0.02, 0.05],
                      "p_jump_to_move": [0.01], "param_prior_std": [1.0]}
    assert n_repeat == 4
    t = cell.traffic
    assert (t["entry"], t["T"], t["n_iter"], t["m_maxiter"], t["m_tol"],
            t["m_step_size"]) == ("sweep", 10_000, 3, 100, 1e-6, 0.01)
    assert (t["warmup_calls"], t["sampled_calls"], t["trace_calls"]) == \
        (1, 4, 1)
    assert set(cell.limits) == set(LIMITS) and cell.chips == 1
    e2e = {m["name"] for m in cell.metrics(manifest, 0)}
    assert e2e == {"fit_s_per_iter", "setup_s"}
    assert {m["name"] for m in cell.metrics(manifest, 1)} == set(READERS)


def _span(name, sid, parent, top, start_ms, end_ms, **attrs):
    s = profiling.Span(name, sid, parent, top, attrs)
    s.start_ns, s.end_ns = start_ms * MS, end_ms * MS
    return s


def _sweeps(counters=True):
    """Two traced sweep calls of 3 EM iterations, 64 runs."""
    out = []
    for k, t0 in enumerate((0, 2000)):
        top = 100 * k + 1
        out.append(_span("sweep.init", top + 1, top, top, t0, t0 + 30))
        for i in range(3):
            a = t0 + 40 + 400 * i
            out += [_span("sweep.statistics", top + 10 + i, top, top, a,
                          a + 10),
                    _span("sweep.m_step", top + 20 + i, top, top, a + 10,
                          a + 310 + 10 * k)]
        c = {"adam_steps": 240, "adam_run_steps": 240 * 48} if counters \
            else {}
        out.append(_span("sweep", top, None, top, t0, t0 + 1300, n_iter=3,
                         n_runs=64, counters=c))
    return out


class _Trace:
    def __init__(self, kernels, busy_s, window_s):
        self.kernels, self.busy_s, self.window_s = kernels, busy_s, window_s

    def kernel_seconds(self, pattern):
        import re

        rx = re.compile(pattern)
        return sum(s for n, (s, _) in self.kernels.items() if rx.search(n))


def _ctx(manifest, calls=2, trace=None):
    cell = Cell.load("sweep", manifest)
    mvs = [mv for mv in (0.5, 1.0, 2.0, 4.0) for _ in range(16)]
    return types.SimpleNamespace(
        cell=cell, config=cell.config, traced_calls=calls,
        traced_work=calls * 192, trace=trace,
        info={"runs": 64, "n_iter": 3, "n_basis": 77,
              "movement_variances": mvs})


def _read(name, ctx, spans, monkeypatch):
    monkeypatch.setattr(profiling, "spans", lambda: list(spans))
    return metric_reader(name)(ctx)


@pytest.mark.parametrize("name, want", [
    ("adam_steps_per_em_iter.sweep", 480 / 6),
    ("adam_live_pct.sweep", 100.0 * 48 / 64),
    ("adam_ms_per_em_iter.sweep", (900 + 930) / 6),
])
def test_program_readers_read_the_spans(manifest, monkeypatch, name, want):
    got = _read(name, _ctx(manifest), _sweeps(), monkeypatch)
    assert got == pytest.approx(want, rel=1e-12)


def test_device_readers_read_the_trace(manifest, monkeypatch):
    kernels = {"void filter_cfg_kernel<2>": [0.15, 6],
               "void smoother_cfg_kernel<2>": [0.17, 6],
               "sm80_xmma_gemm": [0.5, 400]}
    ctx = _ctx(manifest, trace=_Trace(kernels, 1.2, 2.6))
    spans = _sweeps()
    bound = roofline_grid.e_step_bound_s(
        10_000, 500, 2, tuple(ctx.info["movement_variances"]))
    got = _read("scan_batch_roofline.sweep", ctx, spans, monkeypatch)
    assert got == pytest.approx(100.0 * bound * 3 * 2 / 0.32, rel=1e-12)
    ops = 2 * roofline_grid.call_ops(10_000, 500, 500, 2, 77,
                                     ctx.info["movement_variances"], 3,
                                     240 * 48)
    got = _read("mfu.sweep", ctx, spans, monkeypatch)
    assert got == pytest.approx(
        100.0 * ops / (2.6 * roofline.PEAK_OPS_PER_S), rel=1e-12)
    got = _read("device_idle_pct.sweep", ctx, spans, monkeypatch)
    assert got == pytest.approx(100.0 * (1 - 1.2 / 2.6), rel=1e-12)


@pytest.mark.parametrize("name", READERS)
def test_readers_give_none_without_what_they_read(manifest, monkeypatch,
                                                  name):
    """A device reader without a trace, and a reader of the program's
    spans and counters without them (a program without the sweep's spans:
    none, or not one top-level span per traced call; or no recorder)."""
    trace = _Trace({"filter_cfg_kernel": [0.1, 3]}, 0.5, 1.0)
    if name.split(".")[0] in ("scan_batch_roofline", "mfu",
                              "device_idle_pct"):
        assert _read(name, _ctx(manifest), _sweeps(), monkeypatch) is None
    if name.split(".")[0] in ("scan_batch_roofline", "device_idle_pct"):
        return
    for spans in ([], _sweeps()[:-1]):
        assert _read(name, _ctx(manifest, trace=trace), spans,
                     monkeypatch) is None
    monkeypatch.delattr(profiling, "spans")
    assert metric_reader(name)(_ctx(manifest, trace=trace)) is None


def test_grid_counts_by_hand():
    T, L, N, nb = 10_000, 500, 500, 77
    mvs = (1.0, 1.0, 4.0)
    o1, b1 = roofline.smoother_work(T, L, 2, 1.0, T * L)
    o4, b4 = roofline.smoother_work(T, L, 2, 4.0, T * L)
    assert roofline_grid.e_step_work(T, L, 2, mvs) == (2 * o1 + o4,
                                                       2 * b1 + b4)
    # a wider band is more operations, the same bytes
    assert o4 > o1 and b4 == b1 == 4 * 2 * T * L
    assert roofline_grid.e_step_bound_s(T, L, 2, mvs) == pytest.approx(
        3 * b1 / roofline.PEAK_BYTES_PER_S)
    adam = 4.0 * L * nb * N
    want = 2 * (3 * (4.0 * T * N * L + 2.0 * L * nb * N) + 2 * o1 + o4) + \
        adam * (3 * 2 + 100)
    assert roofline_grid.call_ops(T, N, L, 2, nb, mvs, 2, 100) == \
        pytest.approx(want, rel=1e-15)


@pytest.fixture
def small_grid(monkeypatch):
    """The cell's grid cut to 2 x 2 configurations x 2 chains."""
    def spec(cfg, bench_dir=None):
        return ({"movement_variance": [0.5, 2.0],
                 "p_move_to_jump": [0.01, 0.05],
                 "p_jump_to_move": [cfg.p_jump_to_move],
                 "param_prior_std": [cfg.param_prior_std]}, 2)

    monkeypatch.setattr(entry_sweep, "grid_spec", spec)


def _broken(checks):
    return [k for k, c in checks.items()
            if not (math.isfinite(c["value"]) and c["value"] <= c["limit"])]


def test_a_tiny_run_is_correct_and_reads_its_metrics(manifest, small_grid):
    cell = tiny_cell(manifest, "sweep", 300, N=20, L=24)
    res = run.run_cell(cell, manifest, 2 ** 31 + 3, 0.0, 0, "cpu",
                       time.perf_counter())
    assert res["correct"] is True, res["checks"]
    assert set(res["metrics"]) == {"fit_s_per_iter", "setup_s"}
    assert res["attempted"] >= 1 and list(res)[-1] == "checks"


#: at this size every M-step runs to Adam's cap at the cell's tolerance,
#: so no run stops for the fault to keep moving: a looser one stops them
FAULT_TRAFFIC = {"stopped_runs_moving": {"m_tol": 1e-3}}


@pytest.mark.parametrize("fault", faults_sweep.FAULTS)
def test_a_planted_fault_is_not_correct(manifest, small_grid, fault):
    cell = tiny_cell(manifest, "sweep", 300, N=20, L=24,
                     **FAULT_TRAFFIC.get(fault, {}))
    pm = run.import_program()
    with faults_sweep.planted(fault, pm):
        res = run.run_cell(cell, manifest, 2 ** 31 + 7, 0.0, 0, "cpu",
                           time.perf_counter())
    assert res["correct"] is False, res["checks"]
    assert _broken(res["checks"])


def test_the_control_is_not_correct(manifest, small_grid):
    """The control at the configuration's widths (N = L = 500), a short
    recording: at least one compared number breaks its limit."""
    cell = tiny_cell(manifest, "sweep", 200, N=500, L=500)
    pm = run.import_program()
    data = sampler.sample(cell.config, 200, 11, "cpu")
    entry = run.entry_class("sweep")(pm, cell, data, 11,
                                     torch.device("cpu"))
    numbers = entry.compare(entry.control(rm.TF32))
    checks = {k: {"value": numbers[k], "limit": v}
              for k, v in cell.limits.items()}
    assert _broken(checks), checks


def test_faults_are_removed_again():
    from poor_man_gplvm_tpu_torch.ops import mstep
    from poor_man_gplvm_tpu_torch.parallel import sweep

    pm = run.import_program()
    names = ("get_loglikelihood_ma_all", "sweep_fit_poisson_jump", "_e_step")
    before = [mstep.make_adam_runner_batch] + [getattr(sweep, n)
                                               for n in names]
    for fault in faults_sweep.FAULTS:
        with faults_sweep.planted(fault, pm):
            pass
    assert [mstep.make_adam_runner_batch] + [getattr(sweep, n)
                                             for n in names] == before
