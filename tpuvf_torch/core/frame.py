"""Host byte layouts <-> canonical planes (port of ``tpuvf.core.frame``).

Host frames are numpy arrays in the native memory layout of each format
(what a mapped GstVideoFrame would contain):

  BGRA / RGBA : (H, W, 4) uint8 in memory byte order
  NV12        : dict {"y": (H, W), "uv": (ch, 2*cw)}      (UV interleaved)
  I420        : dict {"y": (H, W), "u": (ch, cw), "v": (ch, cw)}

On the device every frame is a dict of canonical uint8 planes
(``formats.canonical_planes``): {"rgba": (4, H, W)} or {"y", "u", "v"}.
Byte-order conversion happens on the host at the pipeline edge only; inside a
pipeline frames stay planar uint8 tensors, as in tpuvf.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from tpuvf_torch.core.formats import (
    PACKED_YUV_FORMATS,
    RGB_FORMATS,
    VideoFormat,
    chroma_dims_420,
)
from tpuvf_torch.core.spec import FrameSpec

# channel permutation mapping host byte order -> canonical R,G,B,A
_RGB_PERMS = {VideoFormat.RGBA: (0, 1, 2, 3), VideoFormat.BGRA: (2, 1, 0, 3)}

_PACKED_422_TODO = (
    "packed 4:2:2 (UYVY/YUY2) host repack is not ported yet "
    "(ROADMAP.md Queue 1: packed 4:2:2)")


def host_to_planes(data, spec: FrameSpec) -> Dict[str, np.ndarray]:
    """Convert a host-layout frame to canonical planes (numpy)."""
    fmt, w, h = spec.format, spec.width, spec.height
    if fmt in RGB_FORMATS:
        arr = np.ascontiguousarray(data, dtype=np.uint8)
        if arr.shape != (h, w, 4):
            raise ValueError(f"{fmt} host frame must be (H, W, 4), got {arr.shape}")
        perm = _RGB_PERMS[fmt]
        return {"rgba": np.ascontiguousarray(arr[..., list(perm)].transpose(2, 0, 1))}
    if fmt == VideoFormat.NV12:
        cw, ch = chroma_dims_420(w, h)
        y = np.ascontiguousarray(data["y"], dtype=np.uint8)
        uvr = np.asarray(data["uv"], dtype=np.uint8).reshape(ch, cw, 2)
        return {"y": y, "u": np.ascontiguousarray(uvr[..., 0]),
                "v": np.ascontiguousarray(uvr[..., 1])}
    if fmt == VideoFormat.I420:
        return {
            "y": np.ascontiguousarray(data["y"], dtype=np.uint8),
            "u": np.ascontiguousarray(data["u"], dtype=np.uint8),
            "v": np.ascontiguousarray(data["v"], dtype=np.uint8),
        }
    if fmt in PACKED_YUV_FORMATS:
        raise NotImplementedError(_PACKED_422_TODO)
    raise ValueError(f"unknown format {fmt}")


def planes_to_host(planes: Dict[str, np.ndarray], spec: FrameSpec):
    """Convert canonical planes (numpy) back to the host byte layout."""
    fmt, w, h = spec.format, spec.width, spec.height
    if fmt in RGB_FORMATS:
        rgba = np.asarray(planes["rgba"]).transpose(1, 2, 0)
        if fmt == VideoFormat.BGRA:
            rgba = rgba[..., [2, 1, 0, 3]]
        return np.ascontiguousarray(rgba)
    if fmt == VideoFormat.NV12:
        cw, ch = chroma_dims_420(w, h)
        uv = np.empty((ch, 2 * cw), np.uint8)
        uv[:, 0::2] = planes["u"]
        uv[:, 1::2] = planes["v"]
        return {"y": np.asarray(planes["y"]), "uv": uv}
    if fmt == VideoFormat.I420:
        return {k: np.asarray(planes[k]) for k in ("y", "u", "v")}
    if fmt in PACKED_YUV_FORMATS:
        raise NotImplementedError(_PACKED_422_TODO)
    raise ValueError(f"unknown format {fmt}")


def to_device(planes: Dict[str, np.ndarray], device) -> Dict[str, torch.Tensor]:
    """Canonical numpy planes -> uint8 tensors on `device` (one copy each)."""
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
            for k, v in planes.items()}


def to_host(planes: Dict[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    """Device planes -> numpy (waits for the device)."""
    return {k: v.cpu().numpy() for k, v in planes.items()}
