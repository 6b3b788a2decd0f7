"""Host byte layouts <-> canonical planes (port of ``tpuvf.core.frame``).

Host frames are numpy arrays in the native memory layout of each format
(what a mapped GstVideoFrame would contain):

  BGRA / RGBA : (H, W, 4) uint8 in memory byte order
  NV12        : dict {"y": (H, W), "uv": (ch, 2*cw)}      (UV interleaved)
  I420        : dict {"y": (H, W), "u": (ch, cw), "v": (ch, cw)}
  UYVY / YUY2 : (H, 2*W) uint8 macro-pixel rows (U Y0 V Y1 / Y0 U Y1 V)

On the device every frame is a dict of canonical uint8 planes
(``formats.canonical_planes``): {"rgba": (4, H, W)} or {"y", "u", "v"}.

Two forms of the repack:

- `host_to_planes` / `planes_to_host` repack numpy arrays on the host.
  They are the plain versions, for the tests and for host frames handed to
  a sink outside a run.
- `host_layout` / `from_host_layout` permute torch tensors on whatever
  device they lie: the RGBA/BGRA ``(H, W, 4)`` swizzle, NV12's uv
  interleave, I420's three planes as they are, the 4:2:2 byte interleave.
  With them a readback is one device-to-host copy of host bytes per piece
  into a (pinned) host buffer (`HostLayout.readback`) and an upload one
  host-to-device copy followed by the split on the device
  (`HostLayout.upload`).  tpuvf repacks on the host
  (its ``native/repack.cc``) because a minor axis of 4 is costly on a TPU;
  nothing in the semantics needs that.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

from tpuvf_torch.core.formats import (
    PACKED_YUV_FORMATS,
    RGB_FORMATS,
    VideoFormat,
    chroma_dims_420,
    chroma_dims_422,
)
from tpuvf_torch.core.spec import FrameSpec
from tpuvf_torch.runtime.observability import trace

# channel permutation mapping host byte order -> canonical R,G,B,A
_RGB_PERMS = {VideoFormat.RGBA: (0, 1, 2, 3), VideoFormat.BGRA: (2, 1, 0, 3)}
# byte slots of (u, y0, v, y1) in a 4:2:2 macro-pixel
_422_SLOTS = {VideoFormat.UYVY: (0, 1, 2, 3), VideoFormat.YUY2: (1, 0, 3, 2)}


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
        raw = np.ascontiguousarray(data, dtype=np.uint8)
        if raw.shape != (h, 2 * w):
            raise ValueError(f"{fmt} host frame must be (H, 2W) bytes, got {raw.shape}")
        cw, _ = chroma_dims_422(w, h)
        quads = raw.reshape(h, cw, 4)
        su, sy0, sv, sy1 = _422_SLOTS[fmt]
        y = np.empty((h, w), np.uint8)
        y[:, 0::2] = quads[..., sy0]
        y[:, 1::2] = quads[..., sy1]
        return {"y": y, "u": np.ascontiguousarray(quads[..., su]),
                "v": np.ascontiguousarray(quads[..., sv])}
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
        cw, _ = chroma_dims_422(w, h)
        y = np.asarray(planes["y"])
        raw = np.empty((h, cw, 4), np.uint8)
        su, sy0, sv, sy1 = _422_SLOTS[fmt]
        raw[..., su], raw[..., sv] = planes["u"], planes["v"]
        raw[..., sy0], raw[..., sy1] = y[:, 0::2], y[:, 1::2]
        return raw.reshape(h, 4 * cw)
    raise ValueError(f"unknown format {fmt}")


# -- the host layout as torch tensors, on the planes' device -------------------


def host_pieces(spec: FrameSpec) -> List[Tuple[str | None, Tuple[int, ...]]]:
    """The host layout's arrays in memory order: [(dict key, or None for a
    bare array, shape)]."""
    fmt, w, h = spec.format, spec.width, spec.height
    if fmt in RGB_FORMATS:
        return [(None, (h, w, 4))]
    if fmt in PACKED_YUV_FORMATS:
        return [(None, (h, 2 * w))]
    cw, ch = chroma_dims_420(w, h)
    if fmt == VideoFormat.NV12:
        return [("y", (h, w)), ("uv", (ch, 2 * cw))]
    if fmt == VideoFormat.I420:
        return [("y", (h, w)), ("u", (ch, cw)), ("v", (ch, cw))]
    raise ValueError(f"unknown format {fmt}")


def host_layout(planes: Dict[str, torch.Tensor], spec: FrameSpec) -> List[torch.Tensor]:
    """Canonical uint8 planes -> the host layout's arrays (`host_pieces`'
    order and shapes), computed on the planes' device; `planes_to_host`
    bitwise."""
    fmt = spec.format
    if fmt in RGB_FORMATS:
        rgba = planes["rgba"]
        return [torch.stack([rgba[c] for c in _RGB_PERMS[fmt]], dim=-1)]
    if fmt == VideoFormat.NV12:
        u, v = planes["u"], planes["v"]
        return [planes["y"], torch.stack((u, v), dim=-1).reshape(u.shape[0], -1)]
    if fmt == VideoFormat.I420:
        return [planes["y"], planes["u"], planes["v"]]
    if fmt in PACKED_YUV_FORMATS:
        y = planes["y"]
        slots = [None] * 4
        su, sy0, sv, sy1 = _422_SLOTS[fmt]
        slots[su], slots[sv] = planes["u"], planes["v"]
        slots[sy0], slots[sy1] = y[:, 0::2], y[:, 1::2]
        return [torch.stack(slots, dim=-1).reshape(y.shape[0], -1)]
    raise ValueError(f"unknown format {fmt}")


def from_host_layout(pieces: List[torch.Tensor], spec: FrameSpec) -> Dict[str, torch.Tensor]:
    """The host layout's arrays (`host_pieces`) -> canonical uint8 planes,
    computed on their device; `host_to_planes` bitwise."""
    fmt = spec.format
    if fmt in RGB_FORMATS:
        (x,) = pieces
        return {"rgba": torch.stack([x[..., c] for c in _RGB_PERMS[fmt]], dim=0)}
    if fmt == VideoFormat.NV12:
        y, uv = pieces
        uvr = uv.reshape(uv.shape[0], -1, 2)
        return {"y": y, "u": uvr[..., 0].contiguous(),
                "v": uvr[..., 1].contiguous()}
    if fmt == VideoFormat.I420:
        return dict(zip(("y", "u", "v"), pieces))
    if fmt in PACKED_YUV_FORMATS:
        (raw,) = pieces
        quads = raw.reshape(raw.shape[0], -1, 4)
        su, sy0, sv, sy1 = _422_SLOTS[fmt]
        y = torch.stack((quads[..., sy0], quads[..., sy1]), dim=-1)
        return {"y": y.reshape(raw.shape[0], -1), "u": quads[..., su].contiguous(),
                "v": quads[..., sv].contiguous()}
    raise ValueError(f"unknown format {fmt}")


class HostLayout:
    """The host byte layout of one spec as one flat buffer: its pieces lie
    back to back in `host_pieces`' order.  `readback` and `upload` move one
    frame through such a buffer, pinned when the device is a GPU, so the
    copies are asynchronous (`upload_many` several frames through one).
    `upload` takes a fresh buffer each call
    (PyTorch's caching host allocator reuses a freed pinned block only
    after the copies recorded on it are done); `readback` writes into a
    buffer of the caller's (`buffer`), which the caller must not reuse
    before the copies are done and the payload is consumed."""

    def __init__(self, spec: FrameSpec, shape=None):
        """`shape`: one bare array of this shape in place of the spec's
        pieces (a vfvideosink's window buffer)."""
        self.spec = spec
        pieces = host_pieces(spec) if shape is None else [(None, shape)]
        self.keys = [k for k, _ in pieces]
        self.shapes = [s for _, s in pieces]
        self.sizes = [int(np.prod(s)) for s in self.shapes]
        self.nbytes = sum(self.sizes)

    def buffer(self, pinned: bool) -> torch.Tensor:
        """A fresh flat host buffer for one frame of this layout."""
        return torch.empty(self.nbytes, dtype=torch.uint8, pin_memory=pinned)

    def _views(self, flat):
        out, off = [], 0
        for shape, n in zip(self.shapes, self.sizes):
            out.append(flat[off:off + n].view(shape))
            off += n
        return out

    def payload(self, flat: torch.Tensor, copy: bool = False):
        """The host frame: numpy views of the flat host buffer, or with
        `copy` arrays of their own (for a consumer that keeps them)."""
        if copy:
            flat = flat.clone()  # torch's copy runs on several threads
        arrays = [v.numpy() for v in self._views(flat)]
        if self.keys == [None]:
            return arrays[0]
        return dict(zip(self.keys, arrays))

    def readback(self, pieces: List[torch.Tensor], flat: torch.Tensor):
        """Enqueue the copy of `pieces` (on any device, shapes as this
        layout's) into the host buffer `flat` (`buffer`'s size, pinned for
        pieces on a GPU); -> `flat`.  On a GPU the copies are non-blocking:
        read the buffer after the stream's event."""
        if flat.numel() != self.nbytes:
            raise ValueError(f"readback: buffer of {flat.numel()} bytes, "
                             f"layout {self.nbytes}")
        for view, piece in zip(self._views(flat), pieces):
            if tuple(piece.shape) != tuple(view.shape):
                raise ValueError(f"readback: piece {tuple(piece.shape)}, "
                                 f"layout {tuple(view.shape)}")
            view.copy_(piece, non_blocking=True)
        return flat

    def upload(self, host_frame, device) -> List[torch.Tensor]:
        """One host frame -> its pieces on `device` (`upload_many`)."""
        return self.upload_many([host_frame], device)[0]

    def upload_many(self, host_frames, device) -> List[List[torch.Tensor]]:
        """Host frames -> each frame's pieces on `device`: one host copy
        into a fresh buffer for all of them (pinned on a GPU), one copy to
        the device, non-blocking, then views of it.  Each part is a span
        (`_alloc`, `_fill_rows`, ``tpuvf_torch.upload.copy``), seen by a
        profiler only: no run loop calls this."""
        flat = self._alloc(len(host_frames), device)
        self._fill_rows(flat, host_frames)
        with trace("tpuvf_torch.upload.copy"):
            rows = flat.to(device, non_blocking=True)
        return [self._views(row) for row in rows]

    def upload_into(self, host_frames, out: torch.Tensor, edge=None,
                    index=None) -> torch.Tensor:
        """Host frames -> the rows of `out`, a (len(host_frames), nbytes)
        device buffer (a compiled step's fixed inputs): one host copy into
        a fresh buffer (pinned on a GPU), one non-blocking copy; -> `out`.
        Each part is a span (`_alloc`, `_fill_rows`,
        ``tpuvf_torch.upload.copy``) adding to `edge`, a
        `PipelineStats.edge_seconds`, where given; `index` rides in the
        spans' profiler args."""
        host = self._alloc(len(host_frames), out.device, edge, index)
        if out.shape != host.shape or out.dtype != torch.uint8:
            raise ValueError(f"upload_into: {len(host_frames)} frames into "
                             f"{tuple(out.shape)} {out.dtype}")
        self._fill_rows(host, host_frames, edge, index)
        with trace("tpuvf_torch.upload.copy", edge, index):
            return out.copy_(host, non_blocking=True)

    def _alloc(self, n: int, device, edge=None, index=None) -> torch.Tensor:
        """A fresh (n, nbytes) host buffer, pinned for a GPU `device` (span
        ``tpuvf_torch.upload.alloc``)."""
        with trace("tpuvf_torch.upload.alloc", edge, index):
            return torch.empty((n, self.nbytes), dtype=torch.uint8,
                               pin_memory=device.type == "cuda")

    def _fill_rows(self, host: torch.Tensor, host_frames, edge=None,
                   index=None) -> None:
        """Each host frame into its row of `host` (span
        ``tpuvf_torch.upload.fill``)."""
        with trace("tpuvf_torch.upload.fill", edge, index):
            for row, host_frame in zip(host, host_frames):
                self._fill(row, host_frame)

    def _fill(self, row: torch.Tensor, host_frame) -> None:
        """Copy one host frame's arrays into the flat host buffer `row`."""
        parts = [host_frame] if self.keys == [None] else [
            host_frame[k] for k in self.keys]
        for view, arr, shape in zip(self._views(row), parts, self.shapes):
            arr = np.ascontiguousarray(arr, dtype=np.uint8)
            bare_ok = self.keys != [None] or arr.shape == tuple(shape)
            if arr.size != view.numel() or not bare_ok:
                raise ValueError(
                    f"{self.spec.format} host frame: expected {shape}, "
                    f"got {arr.shape}")
            if not arr.flags.writeable:  # torch wraps writable arrays only
                arr = arr.copy()
            # torch's copy runs on several threads
            view.copy_(torch.from_numpy(arr).view(view.shape))


def to_device(planes: Dict[str, np.ndarray], device) -> Dict[str, torch.Tensor]:
    """Canonical numpy planes -> uint8 tensors on `device` (one copy each)."""
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
            for k, v in planes.items()}


def to_host(planes: Dict[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    """Device planes -> numpy (waits for the device)."""
    return {k: v.cpu().numpy() for k, v in planes.items()}
