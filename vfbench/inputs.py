"""Inputs made from the seed: the frame pool, the overlay image, the
property schedules and the frames whose output the check reads.

One general generator reads every traffic mix (``vfbench/traffic/*.json``):

- ``loop``: "batched" (``Pipeline.run_batched``, closed loop) or "live"
  (``Pipeline.run_live``, open loop on the output clock);
- ``rate``: the sources' frame rate, which is the output clock's;
- ``batch_size``: frames a batch of the batched loop;
- ``pool``: distinct host frames a source, pushed in a cycle;
- ``sample``: frames whose output the check compares, drawn from the seed
  evenly over the batch slots and the pool frames;
- ``host_threads``: the intra-op threads of the process's host copies
  (``torch.set_num_threads``), what the deployment gives the program;
- ``controls``: property schedules, each ``{"element", "property",
  "shape": "triangle", "from", "to", "period_s", "integer"?}``: a value
  that goes from ``from`` to ``to`` and back every ``period_s`` seconds of
  the output clock.
"""

from __future__ import annotations

import math
import mmap
import struct
import zlib

import numpy as np

HUGE_PAGE = 2 << 20

# host frame layout of each source format: [(plane key or None, shape)]
def plane_shapes(fmt: str, width: int, height: int) -> list:
    if fmt in ("BGRA", "RGBA"):
        return [(None, (height, width, 4))]
    ch, cw = (height + 1) // 2, (width + 1) // 2
    if fmt == "NV12":
        return [("y", (height, width)), ("uv", (ch, 2 * cw))]
    if fmt == "I420":
        return [("y", (height, width)), ("u", (ch, cw)), ("v", (ch, cw))]
    raise ValueError(f"vfbench: no host layout for source format {fmt!r}")


def frame_bytes(fmt: str, width: int, height: int) -> int:
    return sum(math.prod(s) for _, s in plane_shapes(fmt, width, height))


def host_array(shape) -> np.ndarray:
    """A zeroed uint8 host array on its own anonymous mapping, advised to
    huge pages where the kernel offers them, every page touched now: what a
    decoder's frame pool is.  The host copies that read or write it then
    run at the same speed from the first frame on (a first touch in the
    window costs a page fault a page)."""
    n = math.prod(shape)
    m = mmap.mmap(-1, n + HUGE_PAGE)
    if hasattr(mmap, "MADV_HUGEPAGE"):
        m.madvise(mmap.MADV_HUGEPAGE)
    buf = np.frombuffer(m, np.uint8)
    off = (-buf.ctypes.data) % HUGE_PAGE
    arr = buf[off:off + n].reshape(shape)
    arr.fill(0)
    return arr


def frame_pool(sources: dict, pool: int, seed: int, device) -> dict:
    """{source name: [pool host frames]}, uniform random bytes from a
    generator on `device` seeded with `seed`, one call a source, copied into
    a `host_array`.  The same seed on the same device gives the same
    frames."""
    import torch

    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    out = {}
    for name in sorted(sources):
        s = sources[name]
        n = frame_bytes(s["format"], s["width"], s["height"])
        flat = host_array((pool, n))
        torch.from_numpy(flat).copy_(torch.randint(
            0, 256, (pool, n), dtype=torch.uint8, generator=gen,
            device=device))
        frames = []
        for row in flat:
            parts, off = {}, 0
            for key, shape in plane_shapes(s["format"], s["width"],
                                           s["height"]):
                size = math.prod(shape)
                parts[key] = row[off:off + size].reshape(shape)
                off += size
            frames.append(parts[None] if None in parts else parts)
        out[name] = frames
    return out


def schedule_value(ctl: dict, rate: float, k: int):
    """A control's value at output frame k."""
    if ctl.get("shape", "triangle") != "triangle":
        raise ValueError(f"vfbench: unknown schedule shape {ctl['shape']!r}")
    lo, hi = float(ctl["from"]), float(ctl["to"])
    period = float(ctl["period_s"])
    phase = (k / rate) % period / period
    v = lo + (hi - lo) * (1.0 - abs(1.0 - 2.0 * phase))
    return int(math.floor(v + 0.5)) if ctl.get("integer") else v


def frame_values(traffic: dict, k: int) -> dict:
    """{"<property>": value} of every control at output frame k."""
    return {c["property"]: schedule_value(c, traffic["rate"], k)
            for c in traffic.get("controls", ())}


def sample_period(traffic: dict) -> int:
    """Frames k and k + period share a batch slot and a pool frame: the
    least common multiple of the batch size (1 for the live loop) and the
    pool."""
    return math.lcm(int(traffic.get("batch_size", 1)), int(traffic["pool"]))


def sample_frames(seed: int, n: int, traffic: dict) -> list:
    """The frame indices of 0..n-1 whose output the check compares, drawn
    from the seed: ``sample`` frames spread evenly over the residues modulo
    `sample_period` (every slot of the batch graph and every pool frame, at
    least one frame each), the first and the last frame always among them;
    sorted."""
    period = sample_period(traffic)
    per = max(1, int(traffic["sample"]) // period)
    rng = np.random.default_rng([int(seed) & 0xFFFFFFFF, int(seed) >> 32, 1])
    out = {0, n - 1}
    for r in range(min(period, n)):
        ks = np.arange(r, n, period)
        out.update(int(k) for k in rng.choice(ks, size=min(per, ks.size),
                                              replace=False))
    return sorted(out)


def overlay_image(ov: dict) -> np.ndarray:
    """The overlay's straight-alpha (h, w, 4) uint8 image: one colour."""
    img = np.empty((ov["height"], ov["width"], 4), np.uint8)
    img[...] = np.asarray(ov["rgba"], np.uint8)
    return img


def write_png(path, rgba: np.ndarray) -> str:
    """A minimal 8-bit RGBA PNG (one IDAT, filter 0 rows)."""
    h, w = rgba.shape[:2]

    def chunk(tag, data):
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

    raw = b"".join(b"\x00" + rgba[y].tobytes() for y in range(h))
    with open(path, "wb") as fh:
        fh.write(b"\x89PNG\r\n\x1a\n"
                 + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 6, 0, 0, 0))
                 + chunk(b"IDAT", zlib.compress(raw)) + chunk(b"IEND", b""))
    return str(path)
