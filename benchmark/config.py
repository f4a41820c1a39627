"""The benchmark's manifest: ``BENCHMARK.json`` and the files it names.

Every piece is found by name: a configuration in ``configs/<config>.json``,
a traffic mix in ``traffic/<traffic>.json``, a cell's limits in
``workloads/<cell>.json`` and a per-layer metric's reader in
``metrics/<metric>.py``.  Adding a cell, a configuration, a mix or a metric
adds files and entries; no file here changes.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path

from benchmark.reference import model as rm

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent
MANIFEST = ROOT / "BENCHMARK.json"


def load_manifest(path=MANIFEST):
    with open(path) as f:
        return json.load(f)


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """A configuration file: the program's class and constructor arguments,
    the precisions it runs at, and what the reference needs of it."""

    name: str
    model: str
    args: dict
    matmul_precision: str
    scan_precision: str
    family: str  # 'poisson' or 'gaussian'
    link: str  # 'softplus' or 'linear'
    mean_count: float
    n_dyn: int

    @classmethod
    def load(cls, name, bench_dir=BENCH_DIR):
        with open(bench_dir / "configs" / f"{name}.json") as f:
            d = json.load(f)
        return cls(name, d["model"], dict(d["args"]), d["matmul_precision"],
                   d["scan_precision"], d["family"], d["link"],
                   float(d["sampler"]["mean_count"]), int(d["n_dyn"]))

    def __getattr__(self, key):
        args = self.__dict__.get("args", {})
        if key in args:
            return args[key]
        raise AttributeError(key)

    @property
    def noise_std(self):
        return self.args.get("noise_std")

    @property
    def n_latent(self):
        return self.args["n_latent_bin"]

    def basis(self):
        return rm.tuning_basis(self.n_latent, self.tuning_lengthscale,
                               self.explained_variance_threshold_basis)


@dataclasses.dataclass(frozen=True)
class Cell:
    """One workload: its configuration, its traffic mix and its limits."""

    name: str
    config: ModelConfig
    traffic: dict
    limits: dict
    chips: int
    spec: dict

    @classmethod
    def load(cls, name, manifest=None, bench_dir=BENCH_DIR):
        manifest = load_manifest() if manifest is None else manifest
        spec = next((w for w in manifest["workloads"] if w["name"] == name),
                    None)
        if spec is None:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json")
        with open(bench_dir / "traffic" / f"{spec['traffic']}.json") as f:
            traffic = json.load(f)
        with open(bench_dir / "workloads" / f"{name}.json") as f:
            limits = json.load(f)["limits"]
        return cls(name, ModelConfig.load(spec["config"], bench_dir), traffic,
                   limits, int(spec["chips"]), spec)

    def metrics(self, manifest, trace):
        """The cell's metric entries of BENCHMARK.json: end-to-end ones
        (``trace`` 0) or per-layer ones (``trace`` 1)."""
        key = "per_layer" if trace else "end_to_end"
        return [m for m in manifest[key]
                if self.name in m.get("workloads", [self.name])]


def metric_reader(name, bench_dir=BENCH_DIR):
    """The ``read(ctx)`` function of ``metrics/<name>.py``."""
    path = bench_dir / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"benchmark_metric_{name.replace('.', '_').replace('-', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
