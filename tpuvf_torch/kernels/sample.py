"""Texture-sampler geometry as 2-tap tables (port of the numpy planners of
``tpuvf.kernels.sample``).

The reference scales/converts by sampling input planes with a
normalized-coordinate Metal sampler (metalconvertscale_shaders.h:48-148):
half-texel centers (s = t*size - 0.5), clamp-to-edge addressing, bilinear or
nearest filtering.  tpuvf encodes one axis of that as a dense (out, in)
weight matrix (`sample_matrix`, copied here unchanged) and contracts it on
the MXU.  Every row of that matrix has at most two nonzeros, so the port
keeps only those: `plan_taps` turns the matrix into per-output-row
(i0, i1, w0, w1) tables that the resample kernels read
(``kernels/resample.py``).  The weights are the matrix's own float32 values,
so the sampler computes exactly the dense product's terms.

Letterboxing (add-borders) becomes all-zero taps plus a coverage mask
(_computeViewportWithAddBorders, metalconvertscalerenderer.m:137-166: the
viewport is always centered, so only the scale factors matter).
"""

from __future__ import annotations

import numpy as np

LINEAR = "linear"
NEAREST = "nearest"


def texcoords(out_size: int, scale: float = 1.0) -> np.ndarray:
    """Normalized texcoords of output pixel centers along one axis.

    Output pixel p center in NDC maps through a centered quad of half-extent
    `scale` (metalconvertscalerenderer.m:149-166).  For scale=1 this is the
    plain (p + 0.5)/out mapping of a full-screen quad; pixels outside the
    quad get out-of-[0,1] coords (masked separately).
    """
    t = (np.arange(out_size, dtype=np.float64) + 0.5) / out_size  # in [0,1]
    if scale != 1.0:
        # quad occupies [0.5 - scale/2, 0.5 + scale/2] of the output axis
        t = (t - 0.5) / scale + 0.5
    return t


def coverage_mask(out_size: int, scale: float) -> np.ndarray:
    """Bool mask of output pixels whose centers fall inside the quad."""
    t = texcoords(out_size, scale)
    return (t >= 0.0) & (t <= 1.0)


def sample_matrix(
    t: np.ndarray,
    in_size: int,
    filter: str = LINEAR,
    mask: np.ndarray | None = None,
) -> np.ndarray:
    """Dense (len(t), in_size) sampling matrix for normalized texcoords `t`.

    linear : Metal linear sampler — s = t*in - 0.5; weights (1-f, f) on
             floor(s), floor(s)+1 with clamp-to-edge index clamping.
    nearest: Metal nearest sampler — texel floor(t*in), clamped.

    Rows where mask is False (outside the letterbox quad) are all-zero.
    """
    out_size = len(t)
    w = np.zeros((out_size, in_size), np.float32)
    rows = np.arange(out_size)
    if mask is None:
        mask = np.ones(out_size, bool)
    if filter == NEAREST:
        idx = np.clip(np.floor(t * in_size).astype(np.int64), 0, in_size - 1)
        w[rows[mask], idx[mask]] = 1.0
        return w
    if filter != LINEAR:
        raise ValueError(f"unknown filter {filter!r}")
    s = t * in_size - 0.5
    x0 = np.floor(s)
    f = (s - x0).astype(np.float32)
    i0 = np.clip(x0.astype(np.int64), 0, in_size - 1)
    i1 = np.clip(x0.astype(np.int64) + 1, 0, in_size - 1)
    np.add.at(w, (rows[mask], i0[mask]), (1.0 - f)[mask])
    np.add.at(w, (rows[mask], i1[mask]), f[mask])
    return w


def plan_taps(
    t: np.ndarray,
    in_size: int,
    filter: str = LINEAR,
    mask: np.ndarray | None = None,
):
    """Per-output-row 2-tap table of `sample_matrix(t, in_size, filter, mask)`.

    Returns numpy (i0, i1, w0, w1): int32 input indices and float32 weights
    with ``out[r] = w0[r]*in[i0[r]] + w1[r]*in[i1[r]]``, read straight off
    the matrix's nonzeros (ascending index order):

    - two nonzeros   -> (a, b, w[r,a], w[r,b]);
    - one nonzero    -> (i, i, w[r,i], 0): clamp-merged edge taps, NEAREST
      rows, and LINEAR rows whose fraction is exactly 0;
    - no nonzero     -> (0, 0, 0, 0): rows masked out by the letterbox.
    """
    w = sample_matrix(t, in_size, filter, mask)
    nz = w != 0.0
    count = nz.sum(axis=1)
    rows = np.arange(w.shape[0])
    first = np.argmax(nz, axis=1)
    last = in_size - 1 - np.argmax(nz[:, ::-1], axis=1)
    i0 = np.where(count > 0, first, 0)
    i1 = np.where(count == 2, last, i0)
    w0 = np.where(count > 0, w[rows, i0], np.float32(0.0)).astype(np.float32)
    w1 = np.where(count == 2, w[rows, i1], np.float32(0.0)).astype(np.float32)
    return i0.astype(np.int32), i1.astype(np.int32), w0, w1


COL_TILE = 256  # output columns of one K1b tile (csrc/resample.cu kColTile)
MAX_PITCH = 1024  # widest span K1b stages in shared memory, floats (kMaxPitch)


def plan_col_bands(table, tile: int = COL_TILE):
    """The band plan of a `plan_taps` table for the column resampler (K1b):
    tpuvf's `blockband_plan` (``tpuvf/kernels/sample.py:112``) read off the
    taps instead of the dense matrix.

    Returns numpy (span, k0, k1):

    - span: int32 (ceil(n_out / tile), 2), the input columns [lo, hi) that
      the live taps (nonzero weights) of each tile of `tile` output columns
      read; (0, 0) for a tile without one (masked by the letterbox);
    - k0, k1: int32 (n_out,), the taps' indices with every dead tap (weight
      0) pointed at its tile's lo, so each index a tile reads lies in its
      span (an empty tile's at 0).  A dead tap adds 0 * in[k], which equals
      the plain version's 0 * in[i] for the finite planes the sampler reads.
    """
    i0, i1, w0, w1 = (np.asarray(a) for a in table)
    n = len(i0)
    n_tiles = -(-n // tile)
    tile_of = np.arange(n) // tile
    live0, live1 = w0 != 0, w1 != 0
    idx = np.concatenate([i0[live0], i1[live1]]).astype(np.int64)
    owner = np.concatenate([tile_of[live0], tile_of[live1]])
    lo = np.full(n_tiles, np.iinfo(np.int64).max)
    hi = np.full(n_tiles, -1)
    np.minimum.at(lo, owner, idx)
    np.maximum.at(hi, owner, idx)
    live = hi >= 0
    lo = np.where(live, lo, 0)
    hi = np.where(live, hi + 1, 0)
    k0 = np.where(live0, i0, lo[tile_of])
    k1 = np.where(live1, i1, lo[tile_of])
    return (np.stack([lo, hi], 1).astype(np.int32), k0.astype(np.int32),
            k1.astype(np.int32))


def stage_plan(span: np.ndarray, in_size: int, max_pitch: int = MAX_PITCH):
    """K1b's path for each tile of a band plan -> (stage, pitch).

    A tile with live taps whose span, widened to 16-byte boundaries
    [lo4, hi4) (lo down and hi up to a multiple of 4 floats, hi at most
    `in_size`), is at most `max_pitch` floats wide is staged in shared
    memory: stage[t] = (lo4, hi4 - lo4).  Any other tile takes the direct
    gather from device memory: stage[t] = (0, 0); those are a span wider
    than the staging budget (an extreme downscale) and a tile without live
    taps.  pitch: the widest staged row, rounded up to 4 floats (0 when no
    tile is staged)."""
    lo = span[:, 0].astype(np.int64)
    hi = span[:, 1].astype(np.int64)
    lo4 = lo & ~3
    hi4 = np.minimum((hi + 3) & ~3, in_size)
    staged = (hi > lo) & (hi4 - lo4 <= max_pitch)
    width = np.where(staged, hi4 - lo4, 0)
    pitch = -(-int(width.max(initial=0)) // 4) * 4
    return (np.stack([np.where(staged, lo4, 0), width], 1).astype(np.int32),
            pitch)


def letterbox_scales(in_w: int, in_h: int, out_w: int, out_h: int):
    """Centered aspect-fit quad scales (metalconvertscalerenderer.m:148-160)."""
    src_aspect = in_w / in_h
    dst_aspect = out_w / out_h
    if src_aspect > dst_aspect:
        return 1.0, dst_aspect / src_aspect  # pillarbox top/bottom bars
    return src_aspect / dst_aspect, 1.0  # letterbox left/right bars
