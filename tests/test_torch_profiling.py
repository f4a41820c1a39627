"""The port's span-and-counter recorder (``utils/profiling.py``) and the
spans and counters placed on the fit's and the decode's paths.

No JAX here, so that the file also runs on the card's machine
(``python -m pytest --noconftest tests/test_torch_profiling.py``; its
``cuda`` test needs the card).
"""

import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from poor_man_gplvm_tpu_torch import GaussianGPLVMJump1D  # noqa: E402
from poor_man_gplvm_tpu_torch.ops import parallel_scan as ps  # noqa: E402
from poor_man_gplvm_tpu_torch.utils import profiling  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
KW = dict(n_latent_bin=9, movement_variance=1.0, tuning_lengthscale=3.0)
N = 5


@pytest.fixture(autouse=True)
def _fresh_spans():
    profiling.reset()
    yield
    profiling.reset()


def _model(device="cpu", engine="cuda_parallel"):
    return GaussianGPLVMJump1D(N, inference_engine=engine, device=device,
                               noise_std=1.0, **KW)


def _data(T, device="cpu"):
    _, y = _model(device).sample(T, generator=torch.Generator().manual_seed(1))
    return y


def test_span_off_records_nothing_and_enters_no_record_function(monkeypatch):
    def boom(*a, **k):
        raise AssertionError("record_function entered while tracing is off")

    monkeypatch.setattr(profiling._tprof, "record_function", boom)
    assert not profiling._tprof._is_profiler_enabled
    before = profiling.counters()
    with profiling.span("off.a", x=1) as rec:
        with profiling.span("off.b") as inner:
            pass
    assert rec is None and inner is None
    # one shared no-op context, whatever the name
    assert profiling.span("off.c") is profiling.span("off.d")
    assert profiling.spans() == []
    assert profiling.counters() == before


def test_spans_nest_with_parent_and_top_ids():
    seen = {}

    def other_thread():
        with profiling.recording(), profiling.span("t.thread") as s:
            seen["thread"] = s

    with profiling.recording():
        with profiling.span("t.top", kind="call") as top:
            profiling.count("t.items", 3)
            with profiling.span("t.mid") as mid:
                with profiling.span("t.leaf", k=2) as leaf:
                    profiling.host_sync("t_site")
                th = threading.Thread(target=other_thread)
                th.start()
                th.join(timeout=30)
            assert not th.is_alive()
        with profiling.span("t.second") as second:
            pass
    assert (top.parent, top.top) == (None, top.id)
    assert (mid.parent, mid.top) == (top.id, top.id)
    assert (leaf.parent, leaf.top) == (mid.id, top.id)
    assert leaf.attrs == {"k": 2} and top.attrs["kind"] == "call"
    # a top-level span holds the counters' deltas over its extent
    assert top.attrs["counters"] == {"t.items": 3, "host_syncs": 1,
                                     "host_syncs.t_site": 1}
    assert "counters" not in mid.attrs and "counters" not in leaf.attrs
    assert second.parent is None and second.top == second.id != top.id
    assert second.attrs["counters"] == {}
    # another thread's span is its own top-level span
    th_span = seen["thread"]
    assert th_span.parent is None and th_span.top == th_span.id
    assert top.start_ns <= mid.start_ns <= leaf.start_ns <= leaf.end_ns \
        <= mid.end_ns <= top.end_ns
    # recorded in the order they ended
    names = [s.name for s in profiling.spans()]
    assert names.index("t.leaf") < names.index("t.mid") < \
        names.index("t.top") < names.index("t.second")
    assert set(names) == {"t.top", "t.mid", "t.leaf", "t.thread",
                          "t.second"}


def test_spans_past_the_cap_are_counted_as_dropped(monkeypatch):
    monkeypatch.setattr(profiling, "MAX_SPANS", 2)
    before = profiling.counters().get("spans_dropped", 0)
    with profiling.recording():
        for _ in range(5):
            with profiling.span("t.many") as rec:
                pass
    assert len(profiling.spans()) == 2 and rec.end_ns >= rec.start_ns
    assert profiling.counters()["spans_dropped"] - before == 3


def test_span_times_match_the_profilers_events():
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with profiling.span("t.outer") as outer:
            time.sleep(0.002)
            with profiling.span("t.inner") as inner:
                time.sleep(0.003)
    events = {e.name(): e for e in prof.profiler.kineto_results.events()
              if e.name() in ("t.outer", "t.inner")}
    assert set(events) == {"t.outer", "t.inner"}
    for rec in (outer, inner):
        ev = events[rec.name]
        assert abs(rec.start_ns - ev.start_ns()) < 500_000, rec
        assert abs(rec.end_ns - ev.end_ns()) < 500_000, rec
    assert inner.parent == outer.id


def test_trace_summary_names_an_idle_gap_by_its_span():
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    from benchmark import trace as tr

    if torch.cuda.is_available():  # the card's context, made outside
        torch.cuda.synchronize()
    traced = tr.Traced()
    with traced:
        with profiling.span("t.host_wait"):
            time.sleep(0.05)
    gaps = traced.summary().gaps
    assert max(gaps, key=gaps.get) == "t.host_wait"
    assert gaps["t.host_wait"] >= 0.04


def test_h2d_counting_rule():
    assert profiling.counts_as_h2d(torch.ones(3), "cuda")
    assert profiling.counts_as_h2d(np.ones(3), torch.device("cuda", 0))
    assert profiling.counts_as_h2d([1.0, 2.0], "cuda:0")
    assert not profiling.counts_as_h2d(torch.ones(3), "cpu")
    assert not profiling.counts_as_h2d(np.ones(3), "cpu")
    before = profiling.counters()
    out = profiling.to_device(np.ones((4, 3)), "cpu", torch.float32)
    assert out.dtype == torch.float32 and out.shape == (4, 3)
    assert profiling.counters() == before


def _spy_solve(monkeypatch):
    passes = []
    solve = ps._solve

    def spy(*args, **kwargs):
        out = solve(*args, **kwargs)
        passes.append(out[1])
        return out

    monkeypatch.setattr(ps, "_solve", spy)
    return passes


def _syncs(counters):
    return {k: v for k, v in counters.items() if k.startswith("host_syncs")}


@pytest.mark.parametrize("n_iter", [3, 4])
def test_fit_host_syncs_by_site(monkeypatch, n_iter):
    """A fused lean fit on 'cuda_parallel''s CPU path: the fixed-point
    reads equal the passes ``_solve`` returned; the other sites are the
    known guard reads.  No per-iteration clock is read."""
    y = _data(300)
    m = _model()
    passes = _spy_solve(monkeypatch)
    clock = []
    perf_counter = time.perf_counter
    monkeypatch.setattr(time, "perf_counter",
                        lambda: clock.append(1) or perf_counter())
    with profiling.recording():
        res = m.fit_em(y, n_iter=n_iter, output_mode="lean", verboase=False,
                       generator=torch.Generator().manual_seed(0))
    monkeypatch.undo()
    assert clock == []
    assert len(res["log_marginal_l"]) == n_iter
    tops = [s for s in profiling.spans() if s.parent is None]
    fit = [s for s in tops if s.name == "fit_em"]
    assert len(fit) == 1 and fit[0].attrs["n_iter"] == n_iter
    assert fit[0].attrs["fused"] is True
    assert len(passes) == 2 * n_iter  # a forward and a backward solve each
    want = {
        "host_syncs.solve": sum(passes),
        "host_syncs.band": n_iter,  # one band per E-step: W read once
        "host_syncs.ridge_solve": n_iter,
        "host_syncs.uniform_rows": 1,  # the transition, built once
        "host_syncs.nan_guard": 2,  # iterations 0 and n_iter - 1
        "host_syncs.segment_diag": 2,
        "host_syncs.segment_lml": 1,
    }
    if n_iter > 3:  # fused iterations after the first read their seed
        want["host_syncs.warm_start"] = n_iter - 3
    want["host_syncs"] = sum(want.values())
    assert _syncs(fit[0].attrs["counters"]) == want
    # nothing is copied to a card on the CPU
    assert "h2d_bytes" not in fit[0].attrs["counters"]
    names = [s.name for s in profiling.spans() if s.top == fit[0].id]
    for phase in ("fit.m_step", "fit.e_step", "fit.collect"):
        assert names.count(phase) == n_iter
    assert names.count("fit.init_posterior") == 1


def test_decode_host_syncs_by_site(monkeypatch):
    y = _data(300)
    m = _model()
    passes = _spy_solve(monkeypatch)
    before = profiling.counters().get("host_syncs.uniform_rows", 0)
    with profiling.recording():
        res = m.decode_latent(y)
    assert np.isfinite(res["log_marginal_final"])
    (top,) = [s for s in profiling.spans() if s.parent is None]
    assert top.name == "decode_latent" and len(passes) == 2
    want = {"host_syncs.solve": sum(passes), "host_syncs.band": 1,
            "host_syncs.log_marginal": 1}
    want["host_syncs"] = sum(want.values())
    assert _syncs(top.attrs["counters"]) == want
    # the transition (memoised on the model) is built before the dispatch,
    # outside the call's span: its one read
    assert profiling.counters()["host_syncs.uniform_rows"] - before == 1


def test_profile_keeps_its_keys_from_the_spans():
    y = _data(300)
    res = _model().fit_em(y, n_iter=3, verboase=False, profile=True,
                          generator=torch.Generator().manual_seed(0))
    prof = res["profile"]
    assert set(prof) == {"m_step", "e_step", "collect", "scan_passes"}
    assert len(prof["m_step"]) == len(prof["e_step"]) == \
        len(prof["collect"]) == 3
    assert all(t >= 0.0 for k in ("m_step", "e_step", "collect")
               for t in prof[k])
    assert len(prof["scan_passes"]) == 3 and min(prof["scan_passes"][0]) >= 1
    (fit,) = [s for s in profiling.spans() if s.name == "fit_em"]
    assert fit.attrs["fused"] is False  # profile runs the host loop
    # inside an enclosing span too
    profiling.reset()
    with profiling.recording(), profiling.span("t.caller"):
        res = _model().fit_em(y, n_iter=2, verboase=False, profile=True)
    assert len(res["profile"]["m_step"]) == len(res["profile"]["collect"]) \
        == 2
    # outside profile=True and a profiler, nothing is recorded
    profiling.reset()
    _model().fit_em(y, n_iter=3, verboase=False)
    assert profiling.spans() == []


def test_phase_timer_is_a_view_over_spans():
    timer = profiling.PhaseTimer()
    for _ in range(2):
        with timer("t.phase"):
            time.sleep(0.001)
    s = timer.summary()["t.phase"]
    assert s["n"] == 2 and s["total"] >= 0.002
    recs = [r for r in profiling.spans() if r.name == "t.phase"]
    assert [r.seconds for r in recs] == timer.times["t.phase"]


@pytest.mark.cuda
def test_fit_h2d_bytes_are_its_posterior_weights_and_basis():
    """On the card: a small fit copies its CPU generator's 624 MT19937
    words (its initial posterior is drawn on the card from them), its
    weights and basis, the transition's two small tensors and each band's
    channel index, and nothing else."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    T = 3000
    y = _data(T, "cuda")
    before = profiling.counters()
    m = _model("cuda", engine="auto")
    with profiling.recording():
        m.fit_em(y, n_iter=3, output_mode="lean", verboase=False,
                 generator=torch.Generator().manual_seed(0))
    torch.cuda.synchronize()
    after = profiling.counters()
    delta = {k: v - before.get(k, 0) for k, v in after.items()}
    L, nb = KW["n_latent_bin"], m.n_basis
    bands = delta.get("host_syncs.band", 0)
    assert bands >= 3
    assert delta["init_draw.card"] == T * L
    want = (624 + nb * N + L * nb) * 4 + 4 + 2 * 2 * 4 + bands * 8
    assert delta["h2d_bytes"] == want
    assert delta["h2d_copies"] == 3 + 2 + bands
    (fit,) = [s for s in profiling.spans() if s.name == "fit_em"]
    assert fit.attrs["counters"]["h2d_bytes"] == want - (nb * N + L * nb) * 4
    assert fit.attrs["cuda_mallocs"] >= 0
