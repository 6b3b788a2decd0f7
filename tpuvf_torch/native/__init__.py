"""The host-side JPEG codec, C++ built with g++ at first use (port of
``tpuvf.native``'s JPEG part).

``jpeg.cc`` (decoder: baseline, extended sequential and progressive
Huffman, 8-bit, sampling up to 2x2) and ``jpegenc.cc`` (baseline JFIF
4:2:0 encoder, Annex-K tables, IJG quality scaling) are copies of tpuvf's
sources, compiled with tpuvf's flags (``CXXFLAGS``) so that on one machine
the encoder's bytes equal tpuvf's.  `build` links them into
``tpuvf_torch/_build/libtpuvf_jpeg.so`` (git-ignored) when the library is
missing or older than a source: under a file lock, to a temporary name that
is renamed into place, so processes that build at once never load a
half-written file.  A failed build raises.  Nothing builds at import.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
from pathlib import Path

_DIR = Path(__file__).resolve().parent
SOURCES = ("jpeg.cc", "jpegenc.cc")
BUILD_DIR = _DIR.parent / "_build"
LIBRARY = BUILD_DIR / "libtpuvf_jpeg.so"
CXXFLAGS = ("-O3", "-march=native", "-fPIC", "-std=c++17", "-Wall")

_lib = None


def _stale() -> bool:
    if not LIBRARY.exists():
        return True
    built = LIBRARY.stat().st_mtime
    return any((_DIR / s).stat().st_mtime > built for s in SOURCES)


def build() -> Path:
    """Compile the library if it is missing or older than its sources."""
    if not _stale():
        return LIBRARY
    import fcntl

    cxx = os.environ.get("CXX") or shutil.which("g++")
    if not cxx:
        raise RuntimeError("g++ not found: the JPEG codec cannot be built")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / ".jpeg.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if _stale():  # another process may have built it while we waited
            tmp = LIBRARY.with_name(f"{LIBRARY.name}.tmp.{os.getpid()}")
            proc = subprocess.run(
                [cxx, *CXXFLAGS, "-shared", "-o", str(tmp),
                 *(str(_DIR / s) for s in SOURCES)],
                capture_output=True, text=True)
            if proc.returncode != 0:
                tmp.unlink(missing_ok=True)
                raise RuntimeError(f"g++ failed ({proc.returncode}) building "
                                   f"{LIBRARY.name}:\n{proc.stderr}")
            os.replace(tmp, LIBRARY)
    return LIBRARY


def load() -> ctypes.CDLL:
    """The JPEG library, built first if missing or stale."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        u8p = ctypes.POINTER(ctypes.c_uint8)
        i32p = ctypes.POINTER(ctypes.c_int32)
        lib.vf_jpeg_decode.argtypes = [u8p, ctypes.c_int64, u8p, i32p, i32p]
        lib.vf_jpeg_decode.restype = ctypes.c_int
        lib.vf_jpeg_encode.argtypes = [u8p, ctypes.c_int32, ctypes.c_int32,
                                       ctypes.c_int32, u8p, ctypes.c_int64]
        lib.vf_jpeg_encode.restype = ctypes.c_int64
        _lib = lib
    return _lib

