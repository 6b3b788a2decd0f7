"""3D LUT loaders: .cube text files and PNG grid LUTs (port of
``tpuvf.io.lut``; the port cannot import it, since any ``tpuvf`` import loads
jax).

Reproduces the reference's parsers exactly:
- .cube (metalvideofilterrenderer.m:68-162): LUT_3D_SIZE 2..64, skips
  TITLE/DOMAIN_MIN/DOMAIN_MAX/LUT_1D_SIZE lines and '#' comments, and lines
  with fewer than three numbers or a bad float; reads size^3 'R G B' float
  triplets in r-fastest order.
- PNG (metalvideofilterrenderer.m:166-305): LUT size s is found by
  s^3 == width*height (s in 2..256); the image is a grid of s x s slices,
  slicesPerRow = width // s; slice b holds (r horizontal, g vertical), each
  byte / 255.

Returns a (S, S, S, 3) float32 array indexed [b][g][r], the 3D texture
layout the trilinear sampler reads.
"""

from __future__ import annotations

import numpy as np

from tpuvf_torch.io import png


class LutError(ValueError):
    pass


def load_cube(path: str) -> np.ndarray:
    size = 0
    entries = []
    with open(path, "r", errors="replace") as fh:
        for line in fh:
            p = line.strip()
            if not p or p.startswith("#"):
                continue
            if p.startswith("LUT_3D_SIZE"):
                try:
                    size = int(p[len("LUT_3D_SIZE"):].split()[0])
                except (ValueError, IndexError):
                    raise LutError(f"bad LUT_3D_SIZE line in {path}")
                if size < 2 or size > 64:
                    raise LutError(f"invalid LUT size {size} in {path}")
                continue
            if p.startswith(("TITLE", "DOMAIN_MIN", "DOMAIN_MAX",
                             "LUT_1D_SIZE")):
                continue
            if size > 0 and len(entries) < size ** 3:
                parts = p.split()
                if len(parts) >= 3:
                    try:
                        entries.append((float(parts[0]), float(parts[1]),
                                        float(parts[2])))
                    except ValueError:
                        continue
    if size == 0 or len(entries) != size ** 3:
        raise LutError(
            f"incomplete .cube LUT {path}: expected "
            f"{size ** 3 if size else '?'} entries, got {len(entries)}")
    data = np.asarray(entries, np.float32)
    return data.reshape(size, size, size, 3)  # [b][g][r]


def load_png_lut(path: str) -> np.ndarray:
    with open(path, "rb") as fh:
        rgba = png.decode_premultiplied(fh.read())
    img_h, img_w = rgba.shape[:2]
    total = img_w * img_h
    size = 0
    for s in range(2, 257):
        if s ** 3 == total:
            size = s
            break
    if size == 0:
        raise LutError(f"cannot determine LUT size from {img_w}x{img_h} PNG")
    slices_per_row = img_w // size
    if slices_per_row == 0:
        raise LutError(f"LUT PNG too narrow ({img_w} < {size})")
    lut = np.zeros((size, size, size, 3), np.float32)
    for b in range(size):
        sx = (b % slices_per_row) * size
        sy = (b // slices_per_row) * size
        lut[b] = rgba[sy:sy + size, sx:sx + size, :3].astype(np.float32) / 255.0
    return lut


def load(path: str) -> np.ndarray:
    """Dispatch on extension like the renderer (m:320-340)."""
    low = path.lower()
    if low.endswith(".cube"):
        return load_cube(path)
    if low.endswith(".png"):
        return load_png_lut(path)
    raise LutError(f"unsupported LUT file type: {path}")
