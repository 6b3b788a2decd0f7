"""YUV4MPEG2 (.y4m) stream reader/writer (port of ``tpuvf.io.y4m``) — the
interchange format the GStreamer ecosystem reads with `y4mdec` and writes
with `y4menc`.

Stream layout: one `YUV4MPEG2` header line with space-separated tagged
params (W idth, H eight, F rate num:den, I nterlacing p/t/b/m, A spect
num:den, C olorspace), then per frame a `FRAME[ params]\\n` line followed
by raw planar data.

Colorspace mapping into the framework's formats:
- C420 / C420jpeg / C420mpeg2 / C420paldv -> I420 (the chroma-siting
  suffix only differs in sample positions, which raw-plane consumers —
  like GStreamer's y4mdec -> I420 path — ignore)
- C422 (planar, half-width full-height chroma) -> UYVY macro-pixels at
  the host edge (the framework's 4:2:2 layout)
- Cmono -> I420 with flat 128 chroma
- C444 is rejected (no 4:4:4 format in the element set; converting would
  silently resample)

The writer emits I420 as `C420mpeg2` (what GStreamer's y4menc produces).
"""

from __future__ import annotations

import numpy as np

_C420 = ("420", "420jpeg", "420mpeg2", "420paldv")


class Y4MError(ValueError):
    pass


def _parse_ratio(tok, what):
    try:
        num, den = tok.split(":")
        return int(num), int(den)
    except Exception:
        raise Y4MError(f"bad y4m {what} '{tok}'")


def parse_header(line: bytes) -> dict:
    """`YUV4MPEG2 ...` line -> {width, height, fps (num, den), par,
    interlacing ('p'/'t'/'b'/'m'), colorspace (e.g. '420mpeg2')}."""
    text = line.decode("ascii", "replace").rstrip("\n")
    parts = text.split(" ")
    if parts[0] != "YUV4MPEG2":
        raise Y4MError(f"not a YUV4MPEG2 stream: {text[:40]!r}")
    hdr = {"fps": (30, 1), "par": (1, 1), "interlacing": "p",
           "colorspace": "420"}
    for tok in parts[1:]:
        if not tok:
            continue
        tag, val = tok[0], tok[1:]
        if tag == "W":
            hdr["width"] = int(val)
        elif tag == "H":
            hdr["height"] = int(val)
        elif tag == "F":
            hdr["fps"] = _parse_ratio(val, "frame rate")
        elif tag == "A":
            par = _parse_ratio(val, "aspect")
            if par[0] > 0 and par[1] > 0:  # 0:0 = unknown, keep 1:1
                hdr["par"] = par
        elif tag == "I":
            if val not in ("p", "t", "b", "m"):
                raise Y4MError(f"bad y4m interlacing '{val}'")
            hdr["interlacing"] = val
        elif tag == "C":
            hdr["colorspace"] = val
        elif tag == "X":
            pass  # extension comment
        else:
            raise Y4MError(f"unknown y4m header tag '{tok}'")
    if "width" not in hdr or "height" not in hdr:
        raise Y4MError("y4m header missing W or H")
    return hdr


def frame_bytes(hdr: dict) -> int:
    w, h, cs = hdr["width"], hdr["height"], hdr["colorspace"]
    if cs in _C420:
        if w % 2 or h % 2:
            raise Y4MError(f"C420 needs even dimensions, got {w}x{h}")
        return w * h + 2 * (w // 2) * (h // 2)
    if cs == "422":
        if w % 2:
            raise Y4MError(f"C422 needs even width, got {w}")
        return w * h + 2 * (w // 2) * h
    if cs == "mono":
        return w * h
    raise Y4MError(f"unsupported y4m colorspace C{cs}")


class Reader:
    """Indexed .y4m reader: parses the header eagerly, scans FRAME marker
    offsets lazily (FRAME lines may carry variable-length params)."""

    def __init__(self, path: str):
        self.path = path
        with open(path, "rb") as fh:
            line = fh.readline(4096)
            self.header = parse_header(line)
            self._data_start = fh.tell()
        self._frame_size = frame_bytes(self.header)
        self._offsets: list | None = None

    def _index(self) -> list:
        if self._offsets is None:
            import os

            size = os.path.getsize(self.path)
            offsets = []
            with open(self.path, "rb") as fh:
                fh.seek(self._data_start)
                while True:
                    line = fh.readline(4096)
                    if not line:
                        break
                    if not line.startswith(b"FRAME"):
                        raise Y4MError(
                            f"expected FRAME marker at byte "
                            f"{fh.tell() - len(line)}")
                    if fh.tell() + self._frame_size > size:
                        break  # truncated final frame (e.g. a file still
                        # being written): expose only complete frames
                    offsets.append(fh.tell())
                    fh.seek(self._frame_size, 1)
            self._offsets = offsets
        return self._offsets

    def num_frames(self) -> int:
        return len(self._index())

    def read_frame(self, index: int):
        """-> host frame in the framework layout: {'y','u','v'} for 420
        (and mono, with flat chroma), (H, 2W) packed UYVY for 422."""
        offs = self._index()
        with open(self.path, "rb") as fh:
            fh.seek(offs[index])
            raw = np.frombuffer(fh.read(self._frame_size), np.uint8)
        if raw.size != self._frame_size:
            raise Y4MError(f"truncated frame {index}")
        w, h = self.header["width"], self.header["height"]
        cs = self.header["colorspace"]
        if cs == "mono":
            flat = np.full(((h + 1) // 2, (w + 1) // 2), 128, np.uint8)
            return {"y": raw.reshape(h, w).copy(), "u": flat,
                    "v": flat.copy()}
        y = raw[: w * h].reshape(h, w)
        if cs in _C420:
            cw, ch = w // 2, h // 2
            u = raw[w * h: w * h + cw * ch].reshape(ch, cw)
            v = raw[w * h + cw * ch:].reshape(ch, cw)
            return {"y": y.copy(), "u": u.copy(), "v": v.copy()}
        # C422 -> UYVY macro-pixels (U Y0 V Y1)
        cw = w // 2
        u = raw[w * h: w * h + cw * h].reshape(h, cw)
        v = raw[w * h + cw * h:].reshape(h, cw)
        out = np.empty((h, 2 * w), np.uint8)
        out[:, 0::4] = u
        out[:, 1::4] = y[:, 0::2]
        out[:, 2::4] = v
        out[:, 3::4] = y[:, 1::2]
        return out


def stream_header(width: int, height: int, fps=(30, 1), par=(1, 1),
                  interlacing: str = "p") -> bytes:
    if width % 2 or height % 2:
        raise Y4MError(
            f"y4m C420 output needs even dimensions, got {width}x{height}")
    return (f"YUV4MPEG2 W{width} H{height} F{fps[0]}:{fps[1]} "
            f"I{interlacing} A{par[0]}:{par[1]} C420mpeg2\n").encode()


def encode_frame(planes: dict) -> bytes:
    """I420 host planes {'y','u','v'} -> FRAME marker + raw data."""
    return b"FRAME\n" + b"".join(
        np.ascontiguousarray(planes[k]).tobytes() for k in ("y", "u", "v"))
