"""PNG codec (pure Python + zlib + numpy), port of ``tpuvf.io.png``.

Decoder: 8/16-bit, color types 0/2/3/4/6, filters 0-4, non-interlaced and
Adam7-interlaced streams; decode output is always (H, W, 4) uint8 RGBA, and
`decode_premultiplied` premultiplies RGB by alpha as the reference's
CGBitmapContext decode does.  The per-row unfilter is tpuvf's numpy path
(tpuvf also has a C++ one).  Encoder: filter 0 rows in one IDAT at zlib
level 9 (optionally Adam7), byte for byte tpuvf's.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"

# channels per pixel by PNG color type
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}


class PngError(ValueError):
    pass


def _paeth(a, b, c):
    p = a.astype(np.int32) + b.astype(np.int32) - c.astype(np.int32)
    pa = np.abs(p - a)
    pb = np.abs(p - b)
    pc = np.abs(p - c)
    out = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
    return out.astype(np.uint8)


def _unfilter(raw: np.ndarray, height: int, stride: int, bpp: int) -> np.ndarray:
    """Undo per-row filtering. raw is (height, 1+stride) bytes."""
    out = np.zeros((height, stride), np.uint8)
    prev = np.zeros(stride, np.uint8)
    for y in range(height):
        ftype = raw[y, 0]
        line = raw[y, 1:].copy()
        if ftype == 0:
            pass
        elif ftype == 2:  # Up
            line = (line.astype(np.int32) + prev).astype(np.uint8)
        elif ftype in (1, 3, 4):
            # filters with left-pixel dependency: sequential over x in
            # bpp-wide vector steps
            line32 = line.astype(np.int32)
            for x in range(0, stride, bpp):
                seg = slice(x, x + bpp)
                left = out[y, x - bpp:x].astype(np.int32) if x else np.zeros(bpp, np.int32)
                up = prev[seg].astype(np.int32)
                ul = prev[x - bpp:x].astype(np.int32) if x else np.zeros(bpp, np.int32)
                if ftype == 1:  # Sub
                    val = line32[seg] + left
                elif ftype == 3:  # Average
                    val = line32[seg] + ((left + up) >> 1)
                else:  # Paeth
                    val = line32[seg] + _paeth(
                        left.astype(np.uint8), up.astype(np.uint8),
                        ul.astype(np.uint8),
                    )
                out[y, seg] = (val & 0xFF).astype(np.uint8)
            prev = out[y]
            continue
        else:
            raise PngError(f"unknown filter type {ftype} on row {y}")
        out[y] = line
        prev = out[y]
    return out


# Adam7 pass layout: (x_start, y_start, x_step, y_step)
_ADAM7 = (
    (0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4),
    (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2),
)


def _decode_adam7(raw: np.ndarray, width: int, height: int, nch: int,
                  bps: int) -> np.ndarray:
    """Deinterlace an Adam7 stream: 7 independently-filtered sub-images
    scattered onto the output grid.  Returns (H, W, nch*bps) bytes."""
    bpp = nch * bps
    out = np.zeros((height, width, bpp), np.uint8)
    pos = 0
    for x0, y0, xs, ys in _ADAM7:
        pw = (width - x0 + xs - 1) // xs
        ph = (height - y0 + ys - 1) // ys
        if pw <= 0 or ph <= 0:
            continue
        stride = pw * bpp
        need = ph * (1 + stride)
        sub = raw[pos: pos + need]
        if len(sub) < need:
            raise PngError("truncated Adam7 pass data")
        pos += need
        rows = _unfilter(sub.reshape(ph, 1 + stride), ph, stride, bpp)
        out[y0::ys, x0::xs] = rows.reshape(ph, pw, bpp)
    return out


def decode(data: bytes) -> np.ndarray:
    """PNG bytes -> (H, W, 4) uint8 RGBA."""
    if data[:8] != _SIGNATURE:
        raise PngError("not a PNG file")
    pos = 8
    ihdr = None
    palette = None
    trns = None
    idat = bytearray()
    while pos + 8 <= len(data):
        (length,), ctype = struct.unpack(">I", data[pos:pos + 4]), data[pos + 4:pos + 8]
        chunk = data[pos + 8:pos + 8 + length]
        pos += 12 + length
        if ctype == b"IHDR":
            ihdr = struct.unpack(">IIBBBBB", chunk)
        elif ctype == b"PLTE":
            palette = np.frombuffer(chunk, np.uint8).reshape(-1, 3)
        elif ctype == b"tRNS":
            trns = np.frombuffer(chunk, np.uint8)
        elif ctype == b"IDAT":
            idat.extend(chunk)
        elif ctype == b"IEND":
            break
    if ihdr is None:
        raise PngError("missing IHDR")
    width, height, depth, color_type, comp, filt, interlace = ihdr
    if interlace not in (0, 1):
        raise PngError(f"unknown interlace method {interlace}")
    if comp or filt:
        raise PngError("unsupported compression/filter method")
    if color_type not in _CHANNELS:
        raise PngError(f"unsupported color type {color_type}")
    if depth not in (8, 16) and not (color_type == 3 and depth in (1, 2, 4, 8)):
        raise PngError(f"unsupported bit depth {depth}")

    nch = _CHANNELS[color_type]
    raw = np.frombuffer(zlib.decompress(bytes(idat)), np.uint8)

    if color_type == 3 and depth < 8:
        if interlace:
            raise PngError("interlaced sub-byte palette PNG not supported")
        # unpack sub-byte palette indices
        bits_per_row = width * depth
        stride = (bits_per_row + 7) // 8
        raw = raw.reshape(height, 1 + stride)
        rows = _unfilter(raw, height, stride, 1)
        bits = np.unpackbits(rows, axis=1)[:, : width * depth]
        idx = bits.reshape(height, width, depth)
        weights = (1 << np.arange(depth - 1, -1, -1)).astype(np.uint8)
        pix = (idx * weights).sum(axis=2).astype(np.uint8)
        channels = pix[..., None]
    else:
        bytes_per_sample = depth // 8
        bpp = nch * bytes_per_sample
        if interlace:
            channels = _decode_adam7(raw, width, height, nch, bytes_per_sample)
        else:
            stride = width * bpp
            raw = raw[: height * (1 + stride)].reshape(height, 1 + stride)
            channels = _unfilter(raw, height, stride, bpp).reshape(
                height, width, nch * bytes_per_sample)
        if depth == 16:
            channels = channels.reshape(height, width, nch, 2)[..., 0]
        else:
            channels = channels.reshape(height, width, nch)

    out = np.zeros((height, width, 4), np.uint8)
    if color_type == 0:  # gray
        out[..., :3] = channels
        out[..., 3] = 255
    elif color_type == 2:  # rgb
        out[..., :3] = channels
        out[..., 3] = 255
    elif color_type == 3:  # palette
        if palette is None:
            raise PngError("palette image missing PLTE")
        idx = channels[..., 0]
        out[..., :3] = palette[idx]
        if trns is not None:
            alpha = np.full(len(palette), 255, np.uint8)
            alpha[: len(trns)] = trns
            out[..., 3] = alpha[idx]
        else:
            out[..., 3] = 255
    elif color_type == 4:  # gray + alpha
        out[..., :3] = channels[..., :1]
        out[..., 3] = channels[..., 1]
    else:  # rgba
        out[:] = channels
    return out


def decode_premultiplied(data: bytes) -> np.ndarray:
    """Decode + premultiply RGB by alpha, mirroring the reference's
    CGBitmapContext kCGImageAlphaPremultipliedLast decode path
    (metaloverlayrenderer.m:218-231)."""
    rgba = decode(data).astype(np.float32)
    a = rgba[..., 3:4] / 255.0
    rgba[..., :3] = np.round(rgba[..., :3] * a)
    return rgba.astype(np.uint8)


def encode(rgba: np.ndarray, color_type: int | None = None,
           interlace: bool = False) -> bytes:
    """(H, W, 3|4) or (H, W) uint8 -> PNG bytes (filter 0 rows, one IDAT;
    optionally Adam7 interlaced)."""
    arr = np.asarray(rgba, np.uint8)
    if arr.ndim == 2:
        arr = arr[..., None]
    h, w, nch = arr.shape
    if color_type is None:
        color_type = {1: 0, 2: 4, 3: 2, 4: 6}[nch]
    if interlace:
        parts = []
        for x0, y0, xs, ys in _ADAM7:
            sub = arr[y0::ys, x0::xs]
            if sub.shape[0] == 0 or sub.shape[1] == 0:
                continue
            ph, pw = sub.shape[:2]
            rows = np.concatenate(
                [np.zeros((ph, 1), np.uint8), sub.reshape(ph, pw * nch)],
                axis=1)
            parts.append(rows.tobytes())
        compressed = zlib.compress(b"".join(parts), 9)
    else:
        rows = np.concatenate(
            [np.zeros((h, 1), np.uint8), arr.reshape(h, w * nch)], axis=1
        )
        compressed = zlib.compress(rows.tobytes(), 9)

    def chunk(ctype: bytes, payload: bytes) -> bytes:
        body = ctype + payload
        return struct.pack(">I", len(payload)) + body + struct.pack(
            ">I", zlib.crc32(body) & 0xFFFFFFFF
        )

    ihdr = struct.pack(">IIBBBBB", w, h, 8, color_type, 0, 0,
                       1 if interlace else 0)
    return (
        _SIGNATURE
        + chunk(b"IHDR", ihdr)
        + chunk(b"IDAT", compressed)
        + chunk(b"IEND", b"")
    )


def read(path: str) -> np.ndarray:
    with open(path, "rb") as fh:
        return decode(fh.read())


def write(path: str, rgba: np.ndarray) -> None:
    with open(path, "wb") as fh:
        fh.write(encode(rgba))
