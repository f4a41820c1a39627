"""Build and load the hand-written CUDA kernels (``csrc/*.cu``).

The sources are compiled with ``nvcc`` for ``sm_90a`` into a shared library
with a plain C interface and loaded with ``ctypes`` — no PyTorch headers,
so a build takes seconds, not minutes.  The library goes into
``build/torch_kernels/`` at the repository root and its file name carries
a hash of the source, so a changed source rebuilds and an unchanged one is
reused.  Nothing is built at import time: ``load_scan_kernels`` runs at the
first launch (or when called directly, as ``chip_smoke.py`` does to time
the build).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

__all__ = ["load_scan_kernels", "BUILD_DIR", "SCAN_SOURCE"]

_PKG = Path(__file__).resolve().parents[1]
SCAN_SOURCE = _PKG / "csrc" / "scan_kernels.cu"
BUILD_DIR = _PKG.parent / "build" / "torch_kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_lib = None
#: ptxas report (registers, shared memory, spills) of the last build
build_log = ""


def _nvcc():
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


def _compile(src: Path, out: Path) -> str:
    out.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=out.parent)
    os.close(fd)
    try:
        proc = subprocess.run(
            [_nvcc(), *NVCC_FLAGS, "-o", tmp, str(src)],
            capture_output=True, text=True, check=False,
        )
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed on {src.name} (exit {proc.returncode}):\n"
                f"{proc.stdout}{proc.stderr}"
            )
        os.replace(tmp, out)  # atomic: a reader never sees a partial .so
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return proc.stdout + proc.stderr


def load_scan_kernels():
    """Compile (if needed) and load the K1/K2 library; returns the
    ``ctypes.CDLL`` with argument types declared."""
    global _lib, build_log
    if _lib is not None:
        return _lib
    digest = hashlib.sha256(SCAN_SOURCE.read_bytes()).hexdigest()[:16]
    so = BUILD_DIR / f"scan_kernels_{digest}.so"
    if not so.exists():
        build_log = _compile(SCAN_SOURCE, so)
    lib = ctypes.CDLL(str(so))
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.pmg_filter_scan.argtypes = [vp] * 7 + [ci] * 4 + [vp]
    lib.pmg_filter_scan.restype = ci
    lib.pmg_smoother_scan.argtypes = [vp] * 7 + [ci] * 4 + [vp]
    lib.pmg_smoother_scan.restype = ci
    lib.pmg_scan_tlat_resident.argtypes = [ci, ci]
    lib.pmg_scan_tlat_resident.restype = ci
    _lib = lib
    return lib
