"""The readers of the program's spans and counters (``benchmark/spans.py``
and the seven ``metrics/`` files that use it) on a synthetic span list."""

from __future__ import annotations

import types

import pytest

from benchmark import config
from poor_man_gplvm_tpu_torch.utils import profiling

MS = 1_000_000  # ns


def _span(name, sid, parent, top, start_ms, end_ms, **attrs):
    s = profiling.Span(name, sid, parent, top, attrs)
    s.start_ns, s.end_ns = start_ms * MS, end_ms * MS
    return s


def _fits():
    """Two traced fits of 20 iterations, each after its model's basis."""
    out = []
    for k, t0 in enumerate((0, 1000)):
        b, f = 10 * k + 1, 10 * k + 2
        out += [
            _span("model.basis", b, None, b, t0, t0 + 60,
                  counters={"h2d_bytes": 999}),
            _span("fit.init_posterior", f + 1, f, f, t0 + 70, t0 + 770),
            _span("fit.m_step", f + 2, f, f, t0 + 780, t0 + 790),
            _span("fit_em", f, None, f, t0 + 65, t0 + 900, n_iter=20,
                  fused=True,
                  counters={"h2d_bytes": 200_000_000 + k,
                            "host_syncs": 100 + 10 * k}),
        ]
    return out


def _decodes():
    out = []
    for k, t0 in enumerate((0, 300, 600)):
        d = 10 * k + 1
        out += [
            _span("smooth.engine_gate", d + 1, d, d, t0 + 1, t0 + 3),
            _span("decode_latent", d, None, d, t0, t0 + 215,
                  counters={"host_syncs": 6 + k}, cuda_mallocs=k),
        ]
    return out


def _ctx(calls, work):
    return types.SimpleNamespace(traced_calls=calls, traced_work=work)


def _read(name, ctx, spans, monkeypatch):
    monkeypatch.setattr(profiling, "spans", lambda: list(spans))
    return config.metric_reader(name)(ctx)


@pytest.mark.parametrize("name, want", [
    ("init_posterior_ms_per_fit", 700.0),
    ("basis_ms_per_fit", 60.0),
    ("h2d_mb_per_fit", 200.0000005),
    ("host_syncs_per_iter.fit", 210 / 40),
])
def test_fit_readers_divide_by_fits_and_iterations(monkeypatch, name, want):
    got = _read(name, _ctx(2, 40), _fits(), monkeypatch)
    assert got == pytest.approx(want, rel=1e-12)


@pytest.mark.parametrize("name, want", [
    ("host_syncs_per_call.decode", 21 / 3),
    ("gate_ms_per_call.decode", 2.0),
    ("device_allocs_per_call.decode", 1.0),
])
def test_decode_readers_divide_by_calls(monkeypatch, name, want):
    got = _read(name, _ctx(3, 3_000_000), _decodes(), monkeypatch)
    assert got == pytest.approx(want, rel=1e-12)


@pytest.mark.parametrize("name", [
    "init_posterior_ms_per_fit", "basis_ms_per_fit", "h2d_mb_per_fit",
    "host_syncs_per_iter.fit", "host_syncs_per_call.decode",
    "gate_ms_per_call.decode", "device_allocs_per_call.decode"])
def test_readers_give_none_unless_one_top_span_per_traced_call(
        monkeypatch, name):
    spans = _fits() + _decodes()
    n = 3 if name.endswith(".decode") else 2  # the top-level spans
    for calls in (n - 1, n + 1, 0):
        assert _read(name, _ctx(calls, 40), spans, monkeypatch) is None
    # a program without the recorder: nothing to read, nothing raised
    monkeypatch.delattr(profiling, "spans")
    assert config.metric_reader(name)(_ctx(2, 40)) is None


def test_allocs_need_the_card(monkeypatch):
    spans = _decodes()
    for s in spans:
        s.attrs.pop("cuda_mallocs", None)
    assert _read("device_allocs_per_call.decode", _ctx(3, 3), spans,
                 monkeypatch) is None


def test_the_seven_entries_in_the_manifest(manifest):
    added = {m["name"]: m for m in manifest["per_layer"]
             if m["source"] in ("program_span", "program_counter")
             and m["name"] not in ("pscan_launches_per_call.decode",
                                   "pscan_launches_per_iter.fit")}
    assert set(added) == {
        "init_posterior_ms_per_fit", "basis_ms_per_fit", "h2d_mb_per_fit",
        "host_syncs_per_iter.fit", "host_syncs_per_call.decode",
        "gate_ms_per_call.decode", "device_allocs_per_call.decode"}
    for name, m in added.items():
        cell = "ns-decode" if name.endswith(".decode") else "gauss-fit"
        assert m["workloads"] == [cell] and m["better"] == "lower"
