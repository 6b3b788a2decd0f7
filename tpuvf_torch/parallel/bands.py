"""Row bands for spatial (sp) sharding (port of ``tpuvf.parallel.spctx``).

Under ``Pipeline.run_batched(mesh=..., sp_axis=...)`` every plane of a
sharded stage is cut into `count` bands of equal rows along axis -2, band
``s`` on the mesh device ``(dp shard, s)``.  tpuvf traces each stage as a
per-shard program under ``shard_map`` and lets its stencils exchange halos
with ``ppermute``; the port runs the stages in lock-step over the bands
instead (every band finishes stage k before any band starts stage k+1), so
a stage reads its neighbours' rows of stage k-1's output directly:

- a row-local or stencil stage is handed its band plus the rows its whole
  vertical reach needs on its *interior* sides (`window`, gathered from as
  many neighbours as the reach spans), runs its unchanged kernel there and
  keeps its band's rows (`Band.trim`).  At the frame's top and bottom a
  band takes no halo, so the kernel's own clamp is the frame's clamp; a
  replicated edge row would not be, for stacked stencils;
- a stage with frame-global row structure (a resampling over H, a
  rotation) is handed every row (`all_rows`) and computes only its band's
  output rows;
- coordinate tables (vignette and grain rows, letterbox masks, an overlay
  rect) are the frame's, sliced to the band (`shard_rows`) or computed at
  its frame rows (`global_rows`), so every field keeps global rows; the
  frame's height, where a frame-edge clamp fires (tpuvf's
  ``spctx.total_rows``), is the band's `in_height` and `out_height`.

A band is an argument of the element's band build, not a context: the
element plans its tables for the band's rows at build time.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

ALL = None  # a reach of every row: the stage gathers the whole frame


def band_rows(height: int, count: int, index: int) -> tuple:
    """(lo, hi): rows of band `index` of `count` equal bands of `height`."""
    if height % count:
        raise ValueError(f"{height} rows do not split into {count} bands")
    rows = height // count
    return index * rows, (index + 1) * rows


def plane_rows(lo: int, hi: int, plane_height: int, frame_height: int):
    """Frame rows [lo, hi) -> (lo, hi) of a plane with `plane_height` rows
    (4:2:0 chroma: half; everything else: the frame's).  Band edges are
    even, so a half-height plane's rows are exact; the frame's last row maps
    to the plane's."""
    def one(r):
        return plane_height if r == frame_height else (
            r * plane_height // frame_height)

    return one(lo), one(hi)


@dataclass(frozen=True)
class Band:
    """Band `index` of a stage: the output rows [lo, hi) of a frame of
    `out_height` rows, computed from the input rows [in_lo, in_hi) of a
    frame of `in_height` rows (the band plus its halo, or every row)."""

    index: int
    lo: int
    hi: int
    in_lo: int
    in_hi: int
    in_height: int
    out_height: int

    @property
    def rows(self) -> int:
        return self.hi - self.lo

    @property
    def in_rows(self) -> int:
        return self.in_hi - self.in_lo

    def trim(self, planes: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """Planes over the input window's rows (an element whose output has
        the input's rows) -> the band's rows, contiguous."""
        out = {}
        for k, x in planes.items():
            # a full-height plane, or a 4:2:0 chroma plane (even edges)
            div = 1 if x.shape[-2] == self.in_rows else 2
            a, b = (self.lo - self.in_lo) // div, (self.hi - self.in_lo) // div
            out[k] = x[..., a:b, :].contiguous()
        return out


def plan_bands(out_height: int, in_height: int, count: int,
               reach: Optional[int]) -> List[Band]:
    """The `count` bands of a stage: each band's output rows, and the input
    rows its build reads: the band's rows widened by `reach` rows on each
    interior side (an element whose output has its input's rows), or every
    input row for `reach` ALL."""
    bands = []
    for s in range(count):
        lo, hi = band_rows(out_height, count, s)
        if reach is ALL:
            in_lo, in_hi = 0, in_height
        else:
            if in_height != out_height:
                raise ValueError("a stage with a halo keeps its rows")
            if reach % 2:
                raise ValueError(f"a halo is an even number of rows, got "
                                 f"{reach}")
            in_lo, in_hi = max(0, lo - reach), min(in_height, hi + reach)
        bands.append(Band(s, lo, hi, in_lo, in_hi, in_height, out_height))
    return bands


# -- moving rows between bands ------------------------------------------------


def window(pieces: Sequence[torch.Tensor], lo: int, hi: int,
           device) -> torch.Tensor:
    """Rows [lo, hi) of the plane whose bands are `pieces` (equal rows each,
    in order), gathered onto `device` from as many bands as they span; a
    contiguous tensor."""
    rows = pieces[0].shape[-2]
    if not 0 <= lo <= hi <= rows * len(pieces):
        raise ValueError(f"rows [{lo}, {hi}) leave a plane of "
                         f"{rows * len(pieces)} rows")
    parts = []
    for k, p in enumerate(pieces):
        a, b = max(lo, k * rows), min(hi, (k + 1) * rows)
        if a < b:
            parts.append(p[..., a - k * rows:b - k * rows, :].to(device))
    if len(parts) == 1:
        return parts[0].contiguous()
    return torch.cat(parts, dim=-2)


def all_rows(pieces: Sequence[torch.Tensor], device) -> torch.Tensor:
    """Every band's rows joined into the frame's plane on `device` (tpuvf's
    ``spctx.all_rows``, an all-gather over the sp axis)."""
    return window(pieces, 0, pieces[0].shape[-2] * len(pieces), device)


def pad_rows_halo(pieces: Sequence[torch.Tensor], index: int, lo: int,
                  hi: int, device) -> torch.Tensor:
    """Band `index` with `lo` rows above and `hi` below (tpuvf's
    ``spctx.pad_rows_halo``): interior sides take the neighbours' rows,
    from as many bands as the halo spans; the frame's top and bottom
    replicate the frame's edge row (clamp to edge, what a single stencil
    does on one device)."""
    rows = pieces[0].shape[-2]
    total = rows * len(pieces)
    a, b = index * rows, (index + 1) * rows
    body = window(pieces, max(0, a - lo), min(total, b + hi), device)
    top = lo - (a - max(0, a - lo))
    bottom = hi - (min(total, b + hi) - b)
    parts = []
    if top:
        parts.append(body[..., :1, :].expand(
            *body.shape[:-2], top, body.shape[-1]))
    parts.append(body)
    if bottom:
        parts.append(body[..., -1:, :].expand(
            *body.shape[:-2], bottom, body.shape[-1]))
    return torch.cat(parts, dim=-2) if len(parts) > 1 else body


def split_rows(x: torch.Tensor, devices: Sequence) -> List[torch.Tensor]:
    """A plane (rows on axis -2) -> its len(devices) equal bands, band s
    contiguous on devices[s]."""
    lo_hi = [band_rows(x.shape[-2], len(devices), s)
             for s in range(len(devices))]
    return [x[..., lo:hi, :].to(dev).contiguous()
            for (lo, hi), dev in zip(lo_hi, devices)]


# -- frame-global tables sliced to a band -------------------------------------


def shard_rows(x, band: Band, axis: int = -2):
    """The band's output rows of a frame-height table (numpy or torch; rows
    on `axis`), tpuvf's ``spctx.shard_rows``: a coordinate field, a border
    mask, keeps the frame's rows."""
    if x.shape[axis] != band.out_height:
        raise ValueError(f"table of {x.shape[axis]} rows, frame of "
                         f"{band.out_height}")
    index = [slice(None)] * x.ndim
    index[axis] = slice(band.lo, band.hi)
    return x[tuple(index)]


def global_rows(band: Band, window: bool = False) -> np.ndarray:
    """float32 frame rows of the band's output rows, or of its input window
    (tpuvf's ``spctx.global_rows``): the rows a coordinate field of the
    band is computed at."""
    lo, hi = (band.in_lo, band.in_hi) if window else (band.lo, band.hi)
    return np.arange(lo, hi, dtype=np.float32)
