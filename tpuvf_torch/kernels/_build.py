"""Build and load the hand-written CUDA kernels (``tpuvf_torch/csrc``).

The kernels have a plain C interface and are compiled with ``nvcc`` into a
shared library under ``tpuvf_torch/_build/`` (git-ignored) at first use, then
loaded with ctypes.  The library is rebuilt when it is missing or older than
its source.  A failed build raises; nothing falls back to another path.

Nothing here runs at import: the CPU tests import every module, and a CPU
machine has no ``nvcc``.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
SOURCE = _PKG / "csrc" / "resample.cu"
BUILD_DIR = _PKG / "_build"
LIBRARY = BUILD_DIR / "libtpuvf_resample.so"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")

_lib = None
build_seconds = None  # wall time of the last build in this process, if any


def nvcc_path() -> str:
    """nvcc from CUDA_HOME, PATH, or the toolkit's default install prefix."""
    home = os.environ.get("CUDA_HOME")
    if home and (Path(home) / "bin" / "nvcc").exists():
        return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH); "
                       "the CUDA kernels cannot be built")


def build() -> Path:
    """Compile SOURCE into LIBRARY (atomically replaced)."""
    global build_seconds
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", tmp, str(SOURCE)]
    t0 = time.perf_counter()
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n"
                f"{proc.stdout}{proc.stderr}")
        os.replace(tmp, LIBRARY)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    build_seconds = time.perf_counter() - t0
    return LIBRARY


def _stale() -> bool:
    return (not LIBRARY.exists()
            or LIBRARY.stat().st_mtime < SOURCE.stat().st_mtime)


def load() -> ctypes.CDLL:
    """The kernel library, built first if missing or stale."""
    global _lib
    if _lib is not None:
        return _lib
    if _stale():
        build()
    lib = ctypes.CDLL(str(LIBRARY))
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    for fn in (lib.resample_rows_f32, lib.resample_cols_f32):
        # in, out, i0, i1, w0, w1, planes, size_in, size_a, size_b, stream
        fn.argtypes = [ptr] * 6 + [i32] * 4 + [ptr]
        fn.restype = i32
    _lib = lib
    return lib
