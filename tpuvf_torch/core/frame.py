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

import ctypes
import os
import weakref
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


def _piece_grids(spec: FrameSpec) -> List[Tuple[int, int, int]]:
    """Each host piece's sampling of the frame's pixels, in `host_pieces`'
    order: (rows, columns) of pixels a sample covers, and its bytes."""
    fmt = spec.format
    if fmt in RGB_FORMATS:
        return [(1, 1, 4)]
    if fmt in PACKED_YUV_FORMATS:
        return [(1, 2, 4)]  # a macro-pixel: two pixels' U Y0 V Y1
    if fmt == VideoFormat.NV12:
        return [(1, 1, 1), (2, 2, 2)]
    if fmt == VideoFormat.I420:
        return [(1, 1, 1), (2, 2, 1), (2, 2, 1)]
    raise ValueError(f"unknown format {fmt}")


def _copy_rows_h2d(dst: torch.Tensor, src: torch.Tensor) -> None:
    """Rows of page-locked host bytes `src` -> `dst`'s on the card (2-D
    uint8 views of one shape whose rows are contiguous), enqueued on the
    current stream as one ``cudaMemcpy2DAsync`` (``csrc/copy.cu``), where
    torch's copy of a strided host view would gather it on the host."""
    from tpuvf_torch.kernels import _build

    rows, width = dst.shape
    err = _build.load().copy_rows_h2d(
        dst.data_ptr(), dst.stride(0), src.data_ptr(), src.stride(0), width,
        rows, torch.cuda.current_stream(dst.device).cuda_stream)
    if err:
        raise RuntimeError(f"CUDA error {err} from a strided upload of "
                           f"{rows} rows of {width} bytes")


def copy_d2h(copies, stream) -> None:
    """[(host view, device piece)], each piece contiguous and of its view's
    shape, each view contiguous in page-locked host memory -> the copies
    enqueued on `stream` (a ``torch.cuda.Stream``) by one call into
    ``csrc/copy.cu``, a ``cudaMemcpyAsync`` a piece.  Unlike torch's
    copy_, it records no event for torch's host allocator: the caller keeps
    the views' memory until the copies are done (``Pipeline._ring_buffer``
    keeps it as long as its ring)."""
    from tpuvf_torch.kernels import _build

    if not copies:
        return
    ptrs = np.empty((3, len(copies)), np.int64)
    for i, (view, piece) in enumerate(copies):
        ptrs[:, i] = (view.data_ptr(), piece.data_ptr(),
                      piece.numel() * piece.element_size())
    err = _build.load().copy_d2h(ptrs[0].ctypes.data, ptrs[1].ctypes.data,
                                 ptrs[2].ctypes.data, len(copies),
                                 stream.cuda_stream)
    if err:
        raise RuntimeError(f"CUDA error {err} from the readback of "
                           f"{len(copies)} pieces")


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


def _root(arr: np.ndarray) -> np.ndarray:
    """The last numpy array down `arr`'s chain of bases: the array that
    owns the memory, or the one that wraps a foreign buffer (an mmap)."""
    while isinstance(arr.base, np.ndarray):
        arr = arr.base
    return arr


def _cuda_register(ptr: int, nbytes: int) -> int:
    """cudaHostRegister(ptr, nbytes, default flags) -> its error code, the
    error read off where it was refused (`_clear_cuda_error`)."""
    err = int(torch.cuda.cudart().cudaHostRegister(ptr, nbytes, 0))
    if err:
        _clear_cuda_error(err)
    return err


def _cuda_unregister(ptr: int) -> None:
    err = int(torch.cuda.cudart().cudaHostUnregister(ptr))
    if err:
        _clear_cuda_error(err)


def _clear_cuda_error(err: int) -> None:
    """A refused runtime call leaves `err` as the CUDA runtime's last error,
    which torch's next launch check would raise as its own: read it off
    with cudaGetLastError (torch binds none) in the runtime torch loaded,
    found, never loaded, by its soname.  Where there is none such (a static
    runtime), raise `err` here instead."""
    name = f"libcudart.so.{torch.version.cuda.split('.')[0]}"
    try:
        lib = ctypes.CDLL(name, mode=os.RTLD_NOLOAD | os.RTLD_LAZY)
    except OSError:
        raise RuntimeError(f"CUDA error {err} from a host (un)registration,"
                           f" and no {name} loaded to clear it") from None
    lib.cudaGetLastError.argtypes = []
    lib.cudaGetLastError.restype = ctypes.c_int
    lib.cudaGetLastError()


def _is_pinned(root: np.ndarray) -> bool:
    return torch.from_numpy(root).is_pinned()


# a root seen in one upload; copied from directly (page-locked: registered
# here where it is in `_held`, else by its owner); never used
_SEEN, _DIRECT, _REFUSED = range(3)


class HostRegistry:
    """The host memory of a pipeline's sources that a GPU copies from
    directly: a source that hands out frames from a recurring pool (a
    decoder's frame pool) has the pool page-locked once, so its frames go
    to the device by DMA with no host copy into pinned memory.

    A frame's arrays are traced to their roots (`_root`).  A root counts
    once in an upload (`covers`), however many of its frames the upload
    takes, and is admitted when a later upload brings the same live root
    again; identity is kept by a weak reference, never by address, so a
    fresh array a frame is never registered and is not kept alive.  An
    admitted root already page-locked (`pinned`: its owner registered it,
    or torch's pinned tensors) is used as it is and never unregistered; any
    other is registered (`register(ptr, nbytes)` -> a CUDA error code) and
    held strongly until it is unregistered.  One budget holds every
    source's roots: `CAP_FRAMES` frames of each layout that an upload
    brought here and that still lives (a pipeline's sources keep one
    layout each), so a source's admission never has to unregister the pool
    of another source that fits its own share.  To admit a root beyond the
    budget, the least recently used ones, none of the current upload's,
    are unregistered after synchronising `device`, and a root that still
    does not fit waits for a later upload.  A root stays on the fill path
    when it is read-only, not one contiguous block, larger than the budget
    or refused by the registration (not tried again).  `release`
    unregisters every root registered here."""

    CAP_FRAMES = 64

    def __init__(self, device, register=_cuda_register,
                 unregister=_cuda_unregister, pinned=_is_pinned):
        self.device = torch.device(device)
        self._register = register
        self._unregister = unregister
        self._pinned = pinned
        # id(root) -> [weakref, state, the last upload that brought it]
        self._roots: Dict[int, list] = {}
        self._held: Dict[int, np.ndarray] = {}  # id -> root registered here
        self._layouts = weakref.WeakSet()  # the budget's layouts
        self._uploads = 0

    def covers(self, frames, layout: "HostLayout", edge=None,
               index=None) -> List[bool]:
        """Whether each of one upload's `frames` (each a frame's arrays in
        `layout`'s order and shapes) lies in memory the device reads
        directly, admitting the roots an earlier upload brought (span
        ``tpuvf_torch.upload.alloc``)."""
        self._uploads += 1
        self._layouts.add(layout)
        found = [self._frame_roots(arrays, layout) for arrays in frames]
        again = []
        for key, root in {id(r): r for rs in found for r in rs or ()}.items():
            entry = self._roots.get(key)
            if entry is None or entry[0]() is not root:
                self._roots[key] = [self._ref(key, root), _SEEN, self._uploads]
            else:  # marked as this upload's before any admission makes room
                entry[2] = self._uploads
                again.append((key, root, entry))
        for key, root, entry in again:
            if entry[1] == _SEEN:
                with trace("tpuvf_torch.upload.alloc", edge, index):
                    entry[1] = self._admit(key, root)
        return [rs is not None and all(
            self._roots[id(r)][1] == _DIRECT for r in rs)
            for rs in found]

    @staticmethod
    def _frame_roots(arrays, layout: "HostLayout"):
        """A frame's roots, or None where an array is not uint8 in its
        layout shape, contiguous and writable."""
        roots = []
        for arr, shape in zip(arrays, layout.shapes):
            if not (isinstance(arr, np.ndarray) and arr.dtype == np.uint8
                    and arr.shape == tuple(shape) and arr.flags.c_contiguous
                    and arr.flags.writeable):
                return None
            roots.append(_root(arr))
        return roots

    def _ref(self, key: int, root: np.ndarray):
        roots = self._roots

        def forget(ref):
            entry = roots.get(key)
            if entry is not None and entry[0] is ref:
                del roots[key]

        return weakref.ref(root, forget)

    def budget(self) -> int:
        """Bytes the registered roots may hold in all (class doc)."""
        return self.CAP_FRAMES * sum(lay.nbytes for lay in self._layouts)

    def _admit(self, key: int, root: np.ndarray) -> int:
        """A root brought again -> its state."""
        cap = self.budget()
        if (not root.flags.writeable or not root.flags.c_contiguous
                or root.nbytes > cap):
            return _REFUSED
        if self._pinned(root):
            return _DIRECT
        if not self._make_room(cap - root.nbytes):
            return _SEEN
        if self._register(root.ctypes.data, root.nbytes):
            return _REFUSED
        self._held[key] = root
        return _DIRECT

    def _make_room(self, limit: int) -> bool:
        """Unregister the least recently used registered roots, none of the
        current upload's, until at most `limit` bytes stay registered;
        False where that cannot be done."""
        total = sum(root.nbytes for root in self._held.values())
        old = sorted((self._roots[key][2], key) for key in self._held
                     if self._roots[key][2] < self._uploads)
        gone = []
        for _, key in old:
            if total <= limit:
                break
            gone.append(key)
            total -= self._held[key].nbytes
        if total > limit:
            return False
        if gone:
            self._sync()
        for key in gone:
            self._roots[key][1] = _SEEN
            self._unregister(self._held.pop(key).ctypes.data)
        return True

    def _sync(self) -> None:
        """Wait for every copy the device may still make from a root."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def release(self) -> None:
        """Unregister every root registered here, once the device has
        finished every copy (the copy streams' too), and forget them all."""
        if self._held:
            self._sync()
        held, self._held = self._held, {}
        self._roots.clear()
        for root in held.values():
            self._unregister(root.ctypes.data)


class HostLayout:
    """The host byte layout of one spec as one flat buffer: its pieces lie
    back to back in `host_pieces`' order.  `readback` and `upload` move one
    frame through such a buffer, pinned when the device is a GPU, so the
    copies are asynchronous (`upload_many` several frames through one).
    `upload` and `upload_many` take a fresh buffer each call (PyTorch's
    caching host allocator reuses a freed pinned block only after the
    copies recorded on it are done); `upload_into` does too, except for a
    frame whose arrays lie in memory a `HostRegistry` registered, which it
    copies to the device straight from the source's arrays.  `readback`
    writes into a buffer of the caller's (`buffer`), which the caller must
    not reuse before the copies are done and the payload is consumed."""

    def __init__(self, spec: FrameSpec, shape=None):
        """`shape`: one bare array of this shape in place of the spec's
        pieces (a vfvideosink's window buffer)."""
        self.spec = spec
        pieces = host_pieces(spec) if shape is None else [(None, shape)]
        self.keys = [k for k, _ in pieces]
        self.shapes = [s for _, s in pieces]
        self.sizes = [int(np.prod(s)) for s in self.shapes]
        self.nbytes = sum(self.sizes)
        self._grids = _piece_grids(spec) if shape is None else None

    def spans(self, region):
        """A region of the frame's pixels (``core/region.py``; None: all)
        -> the bytes of the layout that hold it, None for all: ((piece,
        row0, row1, byte0, byte1), ...), the rows [row0, row1) of the
        piece's rows from byte0 up to byte1, a span a band and piece."""
        if region is None:
            return None
        out = []
        for piece, (rs, cs, size) in enumerate(self._grids):
            rows = self.shapes[piece][0]
            pitch = self.sizes[piece] // rows
            for y0, y1, x0, x1 in region:
                out.append((piece, y0 // rs, min(-(-y1 // rs), rows),
                            x0 // cs * size, min(-(-x1 // cs) * size, pitch)))
        return tuple(out)

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
        read the buffer after the stream's event.  One call is one frame's
        copies, torch's copy_ a piece: the mesh's loop calls it per frame
        (``Pipeline._readback``); the other loops copy a batch's pieces by
        `copy_d2h`, a call a chunk of frames
        (``Pipeline._readback_batch``)."""
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
                    index=None, registry: HostRegistry = None,
                    spans=None) -> Tuple[int, int]:
        """Host frames -> the rows of `out`, a (len(host_frames), nbytes)
        device buffer (a compiled step's fixed inputs), every copy
        non-blocking on the current stream: a frame whose arrays lie in
        page-locked memory `registry` admitted (`HostRegistry.covers`)
        straight into its row, array by array, or where `spans` (one a
        frame: `spans`' result, None for all) gives the frame's spans,
        span by span (a span narrower than its piece's rows on a GPU as
        one strided copy, `_copy_rows_h2d`; the row's other bytes keep
        what they held); the others whole, through one host copy into a
        fresh buffer (pinned on a GPU) and one copy (one a row when some
        frames went straight).  -> (how many frames went straight, the
        bytes their spans left out).  Each part is a span (`_alloc` with
        the registration, `_fill_rows`, ``tpuvf_torch.upload.copy``)
        adding to `edge`, a `PipelineStats.edge_seconds`, where given;
        `index` rides in the spans' profiler args."""
        n = len(host_frames)
        if tuple(out.shape) != (n, self.nbytes) or out.dtype != torch.uint8:
            raise ValueError(f"upload_into: {n} frames into "
                             f"{tuple(out.shape)} {out.dtype}")
        parts = [self._parts(f) for f in host_frames]
        direct = ([False] * n if registry is None
                  else registry.covers(parts, self, edge, index))
        filled = [i for i in range(n) if not direct[i]]
        if filled:
            host = self._alloc(len(filled), out.device, edge, index)
            self._fill_rows(host, [host_frames[i] for i in filled], edge,
                            index)
        culled = 0
        with trace("tpuvf_torch.upload.copy", edge, index):
            if len(filled) == n:
                out.copy_(host, non_blocking=True)
                return 0, 0
            for i in range(n):
                if not direct[i]:
                    continue
                views = self._views(out[i])
                frame_spans = None if spans is None else spans[i]
                if frame_spans is None:
                    for view, arr in zip(views, parts[i]):
                        view.copy_(torch.from_numpy(arr), non_blocking=True)
                    continue
                for piece, r0, r1, b0, b1 in frame_spans:
                    dst = views[piece].view(self.shapes[piece][0], -1)
                    src = torch.from_numpy(parts[i][piece]).view(dst.shape)
                    dst, src = dst[r0:r1, b0:b1], src[r0:r1, b0:b1]
                    if out.is_cuda and b1 - b0 < dst.stride(0):
                        _copy_rows_h2d(dst, src)
                    else:
                        dst.copy_(src, non_blocking=True)
                    culled -= dst.numel()
                culled += self.nbytes
            for row, i in enumerate(filled):
                out[i].copy_(host[row], non_blocking=True)
        return n - len(filled), culled

    def _parts(self, host_frame) -> list:
        """A host frame's arrays in this layout's order."""
        if self.keys == [None]:
            return [host_frame]
        return [host_frame[k] for k in self.keys]

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
        for view, arr, shape in zip(self._views(row), self._parts(host_frame),
                                    self.shapes):
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
