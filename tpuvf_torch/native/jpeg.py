"""JPEG decode (baseline + progressive) and baseline encode through the
port's native library (``jpeg.cc``, ``jpegenc.cc``); port of
``tpuvf.native.jpeg``."""

from __future__ import annotations

import ctypes

import numpy as np

from tpuvf_torch import native


class JpegError(ValueError):
    pass


_ERRORS = {
    1: "not a JPEG", 2: "bad marker stream", 3: "truncated/invalid segment",
    4: "unsupported precision/component count", 5: "sampling beyond 2x2",
    6: "lossless/arithmetic/hierarchical JPEG unsupported",
    7: "missing SOF before SOS", 8: "no scan data",
}


def _u8p(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def decode(data: bytes) -> np.ndarray:
    """JPEG bytes -> (H, W, 4) uint8 RGBA (alpha = 255)."""
    f = native.load().vf_jpeg_decode
    buf = np.frombuffer(data, np.uint8)
    w, h = ctypes.c_int32(0), ctypes.c_int32(0)
    rc = f(_u8p(buf), len(data), None, ctypes.byref(w), ctypes.byref(h))
    if rc != 0:
        raise JpegError(_ERRORS.get(rc, f"decode error {rc}"))
    out = np.empty((h.value, w.value, 4), np.uint8)
    rc = f(_u8p(buf), len(data), _u8p(out), ctypes.byref(w), ctypes.byref(h))
    if rc != 0:
        raise JpegError(_ERRORS.get(rc, f"decode error {rc}"))
    return out


def encode(rgba: np.ndarray, quality: int = 85) -> bytes:
    """(H, W, 4) uint8 RGBA -> baseline JFIF bytes (4:2:0, Annex-K
    tables, IJG quality scaling; jpegenc.cc)."""
    f = native.load().vf_jpeg_encode
    rgba = np.ascontiguousarray(rgba, np.uint8)
    if rgba.ndim != 3 or rgba.shape[2] != 4:
        raise JpegError(f"encode expects (H, W, 4) RGBA, got {rgba.shape}")
    h, w = rgba.shape[:2]
    n = -1
    for cap in (w * h * 4 + (1 << 16), w * h * 12 + (1 << 16)):
        # the second, worst-case buffer only for pathological content
        out = np.empty(cap, np.uint8)
        n = f(_u8p(rgba), w, h, int(quality), _u8p(out), cap)
        if n != -1:
            break
    if n < 0:
        raise JpegError(f"encode error {n}")
    return out[:n].tobytes()
