"""The pixels of a frame that a consumer reads, as row bands: the region an
upload copies (``runtime/compiled.py`` `CompiledStep.upload_rows`,
``core/frame.py`` `HostLayout.spans`).

A region is None (every pixel of the frame) or a tuple of bands ``(y0, y1,
x0, x1)``: the rows [y0, y1) each read from column x0 up to x1, sorted by
row, their rows disjoint, none empty; ``()`` reads nothing.  A band holds
one span of columns: where a band's rows read two runs of columns, the band
takes both and what lies between (`uncovered`), so a region is a superset
of what is read, never less.
"""

from __future__ import annotations

from typing import Iterable, Optional, Tuple

Band = Tuple[int, int, int, int]
Region = Optional[Tuple[Band, ...]]


def _normal(bands: Iterable[Band]) -> Tuple[Band, ...]:
    """Bands whose rows may overlap -> a region: the rows split at every
    band's edges, each piece the span from the least x0 to the greatest x1
    of the bands over it, neighbours with one span merged."""
    bands = [b for b in bands if b[1] > b[0] and b[3] > b[2]]
    edges = sorted({y for b in bands for y in b[:2]})
    out = []
    for ya, yb in zip(edges, edges[1:]):
        over = [b for b in bands if b[0] <= ya and b[1] >= yb]
        if not over:
            continue
        x0, x1 = min(b[2] for b in over), max(b[3] for b in over)
        if out and out[-1][1] == ya and out[-1][2:] == (x0, x1):
            out[-1] = (out[-1][0], yb, x0, x1)
        else:
            out.append((ya, yb, x0, x1))
    return tuple(out)


def uncovered(rect, covers) -> Tuple[Band, ...]:
    """The pixels of `rect` (x0, y0, x1, y1) outside every rect of
    `covers`: in each run of rows where the same covers lie across the
    whole run, the span from the first pixel no cover holds to the last."""
    px0, py0, px1, py1 = rect
    if px1 <= px0 or py1 <= py0:
        return ()
    clipped = [(max(x0, px0), max(y0, py0), min(x1, px1), min(y1, py1))
               for x0, y0, x1, y1 in covers]
    clipped = [c for c in clipped if c[2] > c[0] and c[3] > c[1]]
    edges = sorted({py0, py1} | {y for c in clipped for y in (c[1], c[3])})
    bands = []
    for ya, yb in zip(edges, edges[1:]):
        spans = sorted((c[0], c[2]) for c in clipped
                       if c[1] <= ya and c[3] >= yb)
        first = last = None
        x = px0  # the first column no span before it holds
        for s0, s1 in spans + [(px1, px1)]:
            if s0 > x:
                first = x if first is None else first
                last = s0
            x = max(x, s1)
        if first is not None:
            bands.append((ya, yb, first, last))
    return _normal(bands)


def shift(region: Region, dx: int, dy: int) -> Region:
    """The region moved by (dx, dy)."""
    if region is None:
        return None
    return tuple((y0 + dy, y1 + dy, x0 + dx, x1 + dx)
                 for y0, y1, x0, x1 in region)


def widen(region: Region, reach: int, width: int, height: int,
          even: bool) -> Region:
    """What a consumer of `region` reads of its input, a width x height
    frame: `reach` more pixels on each side of every band (a stencil's
    halo, across rows and columns alike), with `even` rounded out to even
    rows and columns (a chroma sample of 4:2:0 or 4:2:2 covers two), within
    the frame; None where that is the whole frame."""
    if region is None:
        return None

    def lo(v):
        v = max(v - reach, 0)
        return v - v % 2 if even else v

    def hi(v, size):
        v = v + reach
        v = v + v % 2 if even else v
        return min(v, size)

    out = _normal((lo(y0), hi(y1, height), lo(x0), hi(x1, width))
                  for y0, y1, x0, x1 in region)
    return None if out == ((0, height, 0, width),) else out


def contains(held: Region, need: Region) -> bool:
    """Whether every pixel of `need` lies in `held`."""
    if held is None:
        return True
    if need is None:
        return False
    for y0, y1, x0, x1 in need:
        y = y0
        for h0, h1, hx0, hx1 in held:
            if h0 <= y < h1:
                if hx0 > x0 or hx1 < x1:
                    return False
                y = h1
                if y >= y1:
                    break
        if y < y1:
            return False
    return True
