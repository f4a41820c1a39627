"""Build and load the hand-written CUDA kernels (``csrc/*.cu``).

Each source is compiled with ``nvcc`` for ``sm_90a`` into a shared library
of its own, with a plain C interface, and loaded with ``ctypes`` — no
PyTorch headers, so a build takes seconds, not minutes.  The libraries go
into ``build/torch_kernels/`` at the repository root and their file names
carry a hash of the source and the shared headers, so a changed source
rebuilds and an unchanged one is reused.  Nothing is built at import time:
a library is built at its first launch, or by ``build_all``, which starts
one ``nvcc`` per missing library at once (``chip_smoke.py`` calls it to
time the build).

Libraries:

* ``scan_kernels``: K1/K2, the sequential filter and smoother, one thread
  block per sequence of a batch;
* ``parallel_scan``: K3/K4, the parallel-in-time filter and smoother passes
  in the three recursion-dot precisions (K5), and ``joint_acc`` (3xTF32
  ``wgmma`` on the tensor cores);
* ``bf16_gemm``: the emission and M-step products at the lower matmul
  precisions ('high', 'default'), bf16 ``wgmma`` with f32 sums
  (``ops/precision.py``);
* ``mt19937``: a fit's random initial posterior drawn on the card from a
  CPU ``torch.Generator``'s own MT19937 stream, and normalised
  (``ops/rng.py``);
* ``adam_poisson``: one trip of the batched Adam runner on the Poisson
  M-step objective, the objective, its gradient and the update in one pass
  (``ops/mstep.py``);
* ``binning``: the ingestion layer's spike binner (``csrc/binning.cpp``),
  host code, built by the host's C++ compiler (``g++``, or ``$CXX``) in the
  same way and loaded by ``data/native.py``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

__all__ = [
    "BUILD_DIR",
    "SOURCES",
    "build_all",
    "load",
    "load_parallel_scan",
    "load_scan_kernels",
]

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
SOURCES = {
    "scan_kernels": CSRC / "scan_kernels.cu",
    "parallel_scan": CSRC / "parallel_scan.cu",
    "bf16_gemm": CSRC / "bf16_gemm.cu",
    "mt19937": CSRC / "mt19937.cu",
    "adam_poisson": CSRC / "adam_poisson.cu",
    "binning": CSRC / "binning.cpp",
}
#: the libraries built by the host's C++ compiler, not nvcc
HOST_LIBS = ("binning",)
HEADERS = (CSRC / "scan_common.cuh", CSRC / "hopper_common.cuh")
BUILD_DIR = _PKG.parent / "build" / "torch_kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_vp, _ci, _cl, _cf = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                      ctypes.c_float)
#: (restype, argtypes) of every exported function, per library
_SIGNATURES = {
    "scan_kernels": {
        "pmg_filter_scan": [_vp] * 11 + [_cl] * 5 + [_ci] * 6 + [_vp],
        "pmg_smoother_scan": [_vp] * 11 + [_cl] * 6 + [_ci] * 6 + [_vp],
        "pmg_scan_band_resident": [_ci] * 4,
        "pmg_smoother_push_scan": [_vp] * 9 + [_ci] * 6 + [_vp],
        "pmg_smoother_push_smem": [_ci] * 6,
    },
    "parallel_scan": {
        "pmg_pfilter_pass": [_vp] * 11 + [_ci] * 10 + [_vp],
        "pmg_psmooth_pass": [_vp] * 13 + [_ci] * 10 + [_vp],
        "pmg_pscan_resident": [_ci] * 6,
        "pmg_joint_acc": [_vp] * 4 + [_ci] * 6 + [_vp],
    },
    "bf16_gemm": {
        "pmg_bf16_gemm": [_vp] * 3 + [_cl] * 13 + [_ci] * 4 + [_cl]
        + [_vp] * 3,
    },
    "mt19937": {
        "pmg_mt_draw": [_vp, _ci, _cl, _cf, _vp, _vp, _vp],
        "pmg_mt_normalise": [_vp, _vp, _cl, _ci, _cf, _cf, _vp],
    },
    "adam_poisson": {
        "pmg_adam_poisson_trip": [_vp] * 5 + [_cl] + [_vp] * 7 + [_ci] * 5
        + [_cf, _vp],
        "pmg_adam_poisson_finish": [_vp] * 2 + [_ci] * 2 + [_vp] * 8
        + [_ci, _vp, _cl, _vp],
    },
    "binning": {
        "bin_sliding": [_vp, _vp, _cl, ctypes.c_double, ctypes.c_double,
                        _cl, _cl, _vp],
        "bin_overlapping": [_vp, _vp, _cl, ctypes.c_double, ctypes.c_double,
                            ctypes.c_double, _cl, _cl, _vp],
    },
}
HOST_FLAGS = ("-O3", "-shared", "-fPIC")

_libs = {}
#: ptxas report (registers, shared memory, spills) of each library built
#: by this process
build_log = {}


def _nvcc():
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


def _so_path(name):
    h = hashlib.sha256(SOURCES[name].read_bytes())
    for header in () if name in HOST_LIBS else HEADERS:
        h.update(header.read_bytes())
    return BUILD_DIR / f"{name}_{h.hexdigest()[:16]}.so"


def _command(name, out):
    """The compiler command that builds library ``name`` into ``out``."""
    if name in HOST_LIBS:
        return [os.environ.get("CXX", "g++"), *HOST_FLAGS, "-o", out,
                str(SOURCES[name])]
    return [_nvcc(), *NVCC_FLAGS, "-o", out, str(SOURCES[name])]


def build_all(names=None):
    """Compile every library in ``names`` (default: all) that is not built
    yet, one compiler process per source, all started together; raise if
    any fails.  Each library is written atomically (a reader never sees a
    partial .so)."""
    names = list(SOURCES) if names is None else list(names)
    jobs = []
    try:
        for name in names:
            out = _so_path(name)
            if out.exists():
                continue
            out.parent.mkdir(parents=True, exist_ok=True)
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=out.parent)
            os.close(fd)
            proc = subprocess.Popen(
                _command(name, tmp),
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            )
            jobs.append((name, out, tmp, proc))
        failed = []
        for name, out, tmp, proc in jobs:
            text, _ = proc.communicate()
            if proc.returncode != 0:
                failed.append(f"{_command(name, tmp)[0]} failed on "
                              f"{SOURCES[name].name} (exit "
                              f"{proc.returncode}):\n{text}")
                continue
            os.replace(tmp, out)
            build_log[name] = text
        if failed:
            raise RuntimeError("\n".join(failed))
    finally:
        for _, _, tmp, proc in jobs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            if os.path.exists(tmp):
                os.remove(tmp)


def load(name):
    """Build (if needed) and load library ``name``; returns the
    ``ctypes.CDLL`` with every exported function's types declared."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    build_all([name])
    lib = ctypes.CDLL(str(_so_path(name)))
    for fn, argtypes in _SIGNATURES[name].items():
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = None if name in HOST_LIBS else _ci
    _libs[name] = lib
    return lib


def load_scan_kernels():
    """The K1/K2 library."""
    return load("scan_kernels")


def load_parallel_scan():
    """The K3/K4/K5 and joint_acc library."""
    return load("parallel_scan")
