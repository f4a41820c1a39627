"""BENCHMARK.json against the benchmark's contract, and every piece it
names found by name; a cell added as new files and a new entry alone is
picked up and runs."""

from __future__ import annotations

import importlib
import json
import re
import shutil
import time

import pytest

from benchmark import config, run
from benchmark.config import BENCH_DIR, ROOT, Cell

from _cells import tiny_cell

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
KEYS = {
    "top": {"command", "paths", "run_seconds", "configs", "workloads",
            "end_to_end", "per_layer"},
    "configs": {"name", "source", "file", "reduced", "why"},
    "workloads": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves"},
}


def _line(text):
    return isinstance(text, str) and 1 <= len(text) <= 200 and \
        "\n" not in text and "\t" not in text


def test_manifest_keys_names_and_units(manifest):
    assert set(manifest) == KEYS["top"]
    assert manifest["command"] == ["python3", "benchmark/run.py"]
    assert manifest["paths"] == ["benchmark"]
    assert isinstance(manifest["run_seconds"], int)
    assert 1 <= manifest["run_seconds"] <= 51
    names = []
    for section in ("configs", "workloads", "end_to_end", "per_layer"):
        for entry in manifest[section]:
            extra = set(entry) - KEYS[section]
            assert extra <= ({"workloads"} if section in
                             ("end_to_end", "per_layer") else set()), entry
            assert KEYS[section] <= set(entry), entry
            assert NAME.match(entry["name"]), entry["name"]
            if "unit" in entry:
                assert UNIT.match(entry["unit"]), entry["unit"]
                assert entry["better"] in ("lower", "higher")
            for key in ("why", "source", "layer"):
                if key in entry and section != "end_to_end":
                    assert _line(entry[key]), (key, entry[key])
            names.append((section, entry["name"]))
    for section in ("configs", "workloads"):
        got = [n for s, n in names if s == section]
        assert len(got) == len(set(got))
    metric_names = [n for s, n in names if s in ("end_to_end", "per_layer")]
    assert len(metric_names) == len(set(metric_names))
    assert len(json.dumps(manifest)) <= 64 * 1024


def test_end_to_end_rules(manifest):
    e2e = {m["name"]: m for m in manifest["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in e2e.values():
        assert 0.01 <= m["bound"] <= 0.25, m
        assert m["source"] in ("host_clock", "device_trace")
    for cell in manifest["workloads"]:
        mine = [m for m in manifest["end_to_end"]
                if cell["name"] in m.get("workloads", [cell["name"]])]
        assert "setup_s" in [m["name"] for m in mine]
        assert len(mine) >= 2
        assert any(cell["name"] in m.get("workloads", [cell["name"]])
                   for m in manifest["per_layer"])
        assert cell["chips"] == 1


def test_per_layer_metrics_move_a_reported_metric(manifest):
    e2e = {m["name"]: m for m in manifest["end_to_end"]}
    layers = {}
    for m in manifest["per_layer"]:
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        moved = e2e[m["moves"]]
        for cell in m["workloads"]:
            assert cell in moved.get("workloads", [cell]), (m["name"], cell)
        if "roofline" in m["name"] or "mfu" in m["name"]:
            assert m["unit"] == "%"
        layers.setdefault(m["layer"], []).append(m["name"])
    assert len(layers) >= 5


@pytest.mark.parametrize("kind", ["configs", "workloads", "metrics"])
def test_every_piece_found_by_name(manifest, kind):
    if kind == "configs":
        for c in manifest["configs"]:
            path = ROOT / c["file"]
            assert path.is_file() and BENCH_DIR in path.parents
            d = json.loads(path.read_text())
            assert d["reduced"] == c["reduced"]
            assert len(d["source"]) <= 200
            config.ModelConfig.load(c["name"])
    elif kind == "workloads":
        for w in manifest["workloads"]:
            cell = Cell.load(w["name"], manifest)
            assert cell.config.name == w["config"]
            importlib.import_module(
                f"benchmark.entries.{cell.traffic['entry']}")
            assert cell.limits and all(v > 0 for v in cell.limits.values())
    else:
        for m in manifest["end_to_end"] + manifest["per_layer"]:
            assert callable(config.metric_reader(m["name"]))


def test_a_cell_added_as_new_files_is_picked_up(manifest, tmp_path):
    """A new mix and a new cell: two new files and one new entry, no edit
    of a file that is there."""
    bench = tmp_path / "benchmark"
    shutil.copytree(BENCH_DIR, bench,
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    before = {p: p.read_bytes() for p in bench.rglob("*") if p.is_file()}
    (bench / "traffic" / "decode-closed-tiny.json").write_text(json.dumps(
        {"entry": "decode", "loop": "closed", "T": 1200, "warmup_calls": 1,
         "sampled_calls": 2, "trace_calls": 1}))
    (bench / "workloads" / "tiny-decode.json").write_text(json.dumps(
        {"limits": Cell.load("ns-decode", manifest).limits}))
    added = dict(manifest, workloads=manifest["workloads"] + [{
        "name": "tiny-decode", "config": "poisson-jump-n500-l500",
        "traffic": "decode-closed-tiny", "chips": 1,
        "why": "a tiny decode added as files alone"}])
    for m in added["end_to_end"]:
        if "ns-decode" in m.get("workloads", []):
            m["workloads"] = m["workloads"] + ["tiny-decode"]
    assert all(before[p] == p.read_bytes() for p in before)
    cell = Cell.load("tiny-decode", added, bench_dir=bench)
    assert cell.traffic["T"] == 1200
    small = tiny_cell(added, "ns-decode", 1200)
    cell = Cell(cell.name, small.config, cell.traffic, cell.limits,
                cell.chips, cell.spec)
    res = run.run_cell(cell, added, 5, 0.0, 0, "cpu", time.perf_counter(),
                       bench_dir=bench)
    assert set(res["metrics"]) == {"decode_bins_per_s", "decode_p95_ms",
                                   "setup_s"}
    assert res["attempted"] >= 1 and list(res)[-1] == "checks"
