"""Build and load the hand-written CUDA kernels (``tpuvf_torch/csrc``).

Every ``csrc/*.cu`` source has a plain C interface.  `build` compiles each
source to an object with its own ``nvcc -c`` (all started together, so the
build takes as long as the slowest source), then links the objects with one
``nvcc -shared`` into a single library under ``tpuvf_torch/_build/``
(git-ignored; `set_build_dir`, which
``runtime.device.enable_executable_cache`` calls, picks another
directory), which `load` opens with ctypes.  The sources include the
shared device header ``csrc/yuv420.cuh`` (found beside them, no ``-I``
needed).  The library is rebuilt when it is missing or older than any source
or header.  A failed build raises; nothing falls back to another path.

The kernels in the library, each with its wrapper:

- K1 ``resample_rows_f32`` and K1b ``resample_cols_f32`` (``resample.cu``,
  wrappers in ``kernels/resample.py``): the separable 2-tap sampler;
- K2 ``emit_u8`` / ``emit_f32`` (``emit.cu``, ``kernels/emit.py``): the
  fused emit, yuv->rgb -> letterbox border -> colour adjustments -> quantize;
- K3 ``lut3d_trilinear_f32`` (``lut.cu``, ``kernels/lut.py``): the
  trilinear 3D-LUT lookup with its quantizing epilogue;
- K4 ``composite_fold`` (``composite.cu``, ``kernels/composite.py``):
  vfcompositor's per-pixel blend fold of the pad draws over the background;
- K5 ``deinterlace_u8`` (RGB in) and ``deinterlace_yuv420_u8`` (4:2:0 in)
  (``deinterlace.cu``, ``kernels/deinterlace.py``): vfdeinterlace's whole
  body, texture -> bob / weave / greedy-H -> RGBA8 or 4:2:0 out;
- K6 ``overlay_blend_u8`` (RGB) and ``overlay_yuv420_u8`` (4:2:0)
  (``overlay.cu``, ``kernels/overlay.py``): vfoverlay's whole body, the
  input's RGB -> the rect blend of the premultiplied image -> RGBA8 or
  4:2:0 out.

`SIGNATURES` gives each exported function's ctypes argument types; a source
that exports a function must list it there.

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
SOURCE_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
LIBRARY = BUILD_DIR / "libtpuvf_kernels.so"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC")


def set_build_dir(path=None) -> Path:
    """Build and load the library under `path` (default: the package's
    ``_build``); -> the directory.  A library already loaded stays."""
    global BUILD_DIR, LIBRARY
    BUILD_DIR = Path(path) if path is not None else _PKG / "_build"
    LIBRARY = BUILD_DIR / LIBRARY.name
    return BUILD_DIR


_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_EMIT_ARGS = (
    # src, u, v, is_rgba, out, out_f32, height, width, matrix_index
    [_P, _P, _P, _I, _P, _I, _I, _I, _I]
    # border rows, border cols, border colour r, g, b, a
    + [_P, _P, _F, _F, _F, _F]
    # params, frame_index, tx, ty, px, py, gates (-1: no adjustments), stream
    + [_P, _P, _P, _P, _P, _P, _I, _P])
SIGNATURES = {
    # in, out, i0, i1, w0, w1, planes, in_h, out_h, width, stream
    "resample_rows_f32": [_P] * 6 + [_I] * 4 + [_P],
    # in, out, k, w0, w1, stage, planes, height, in_w, out_w, pitch, stream
    "resample_cols_f32": [_P] * 6 + [_I] * 5 + [_P],
    "emit_u8": _EMIT_ARGS,
    "emit_f32": _EMIT_ARGS,
    # src, src_f32, u, v, out, out_f32, height, width
    "emit_vector_path": [_P, _I, _P, _P, _P, _I, _I, _I],
    # in, table, size, pixels, out, quantize, stream
    "lut3d_trilinear_f32": [_P, _P, _I, _I, _P, _I, _P],
    # in, out, size, pixels, quantize
    "lut3d_path": [_P, _P, _I, _I, _I],
    # params (host FoldParams), out, stream
    "composite_fold": [_P, _P, _P],
    # src, src_f32, width, x
    "composite_draw_vector_path": [_P, _I, _I, _I],
    # cur, prev, out, out_u, out_v, threshold, height, width, method, tff,
    # matrix_out, stream
    "deinterlace_u8": [_P] * 6 + [_I] * 5 + [_P],
    # y, u, v, 8 chroma taps, prev, out, out_u, out_v, tex, threshold,
    # height, width, method, tff, matrix_in, matrix_out, stream
    "deinterlace_yuv420_u8": [_P] * 17 + [_I] * 6 + [_P],
    # src, out, height, width, ov, x0, x1, y0, y1, alpha, stream
    "overlay_blend_u8": [_P, _P, _I, _I, _P] + [_I] * 4 + [_P, _P],
    # y, u, v, 8 chroma taps, out_y, out_u, out_v, height, width, ov, x0, x1,
    # y0, y1, alpha, matrix_in, matrix_out, stream
    "overlay_yuv420_u8": [_P] * 14 + [_I, _I, _P] + [_I] * 4 + [_P, _I, _I,
                                                                _P],
}

_lib = None
build_seconds = None  # wall time of the last build in this process, if any


def sources() -> list:
    """Every CUDA source of the package, sorted by name."""
    return sorted(SOURCE_DIR.glob("*.cu"))


def headers() -> list:
    """Every device header the sources include, sorted by name."""
    return sorted(SOURCE_DIR.glob("*.cuh"))


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


def _run_all(cmds) -> None:
    """Start every command at once; raise on the first that failed."""
    procs = [(cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                    stderr=subprocess.STDOUT, text=True))
             for cmd in cmds]
    failed = []
    for cmd, proc in procs:
        out, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"nvcc failed ({proc.returncode}): {' '.join(cmd)}"
                          f"\n{out}")
    if failed:
        raise RuntimeError("\n".join(failed))


def build() -> Path:
    """Compile every source and link LIBRARY (atomically replaced)."""
    global build_seconds
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs = [Path(tmp) / f"{src.stem}.o" for src in sources()]
        _run_all([[nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
                  for src, obj in zip(sources(), objs)])
        lib_tmp = Path(tmp) / LIBRARY.name
        _run_all([[nvcc, *NVCC_FLAGS, "-shared", "-o", str(lib_tmp),
                   *map(str, objs)]])
        os.replace(lib_tmp, LIBRARY)
    build_seconds = time.perf_counter() - t0
    return LIBRARY


def _stale() -> bool:
    if not LIBRARY.exists():
        return True
    built = LIBRARY.stat().st_mtime
    return any(src.stat().st_mtime > built
               for src in sources() + headers())


def load() -> ctypes.CDLL:
    """The kernel library, built first if missing or stale."""
    global _lib
    if _lib is not None:
        return _lib
    if _stale():
        build()
    lib = ctypes.CDLL(str(LIBRARY))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    _lib = lib
    return lib
