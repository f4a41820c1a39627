"""What a run may load and where it may start: no JAX and no JAX package
(compared by whole top-level names), no run without a card, and no run
without the program in its own checkout."""

from __future__ import annotations

import ast
import json
import os
import shutil
import subprocess
import sys

from benchmark import run
from benchmark.config import BENCH_DIR, ROOT


def test_forbidden_modules_compares_whole_top_level_names():
    mods = {"poor_man_gplvm_tpu_torch": 1, "poor_man_gplvm_tpu_torch.ops": 1,
            "jaxtyping": 1, "jax.numpy": 1, "poor_man_gplvm_tpu.ops": 1,
            "flax": 1, "numpy": 1}
    assert run.forbidden_modules(mods) == ["flax", "jax.numpy",
                                          "poor_man_gplvm_tpu.ops"]


def test_reference_imports_nothing_of_the_program_or_jax():
    for path in (BENCH_DIR / "reference").glob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            for n in names:
                assert n.split(".")[0] not in (
                    "jax", "jaxlib", "flax", "poor_man_gplvm_tpu",
                    "poor_man_gplvm_tpu_torch"), (path.name, n)


def test_a_run_loads_no_jax():
    """Every module under benchmark/ and a whole tiny run on the CPU, in a
    fresh process: nothing JAX's or the JAX package's is loaded."""
    code = f"""
import importlib, json, pkgutil, sys, time, dataclasses
sys.path.insert(0, {str(ROOT)!r})
sys.path.insert(0, {str(BENCH_DIR / 'tests')!r})
import benchmark
for m in pkgutil.walk_packages(benchmark.__path__, 'benchmark.'):
    if '.tests' not in m.name:
        importlib.import_module(m.name)
from benchmark import run
from benchmark.config import load_manifest
from _cells import tiny_cell
man = load_manifest()
res = run.run_cell(tiny_cell(man, 'gauss-fit', 300, n_iter=3), man, 1, 0.0,
                   1, 'cpu', time.perf_counter())
print(json.dumps(run.forbidden_modules()))
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


def test_no_card_no_result():
    """A run that finds no CUDA card fails and does not fall back to the
    CPU; it prints nothing on standard output."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", "gauss-fit",
         "--seed", str(2 ** 31 + 5), "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, timeout=300, cwd=ROOT, env=env)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "no result" in out.stderr


def test_without_the_program_no_run(tmp_path):
    """A directory that holds only BENCHMARK.json and the benchmark's files
    does not run: the program is not in that checkout."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(BENCH_DIR, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    code = ("import sys; sys.path.insert(0, '.');"
            "from benchmark import run; run.import_program()")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, cwd=tmp_path)
    assert out.returncode != 0
    assert "ImportError" in out.stderr or "ModuleNotFoundError" in out.stderr
