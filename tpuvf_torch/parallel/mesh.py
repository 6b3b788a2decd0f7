"""Device mesh and the dp/sp batch runner (port of ``tpuvf.parallel.mesh``).

tpuvf scales a pipeline two ways, and the port keeps both and tpuvf's user
API (one host thread calls ``Pipeline.run_batched(mesh=..., sp_axis=...)``;
no process group):

- **dp** (data parallel): the frames of a batch split across devices, shard
  d taking the contiguous frames ``[d*b/dp, (d+1)*b/dp)`` (tpuvf's
  ``P('dp')`` on the batch axis).  Each shard carries its own state across
  batches and calls: right for stateless chains, and for stateful ones when
  the shards are independent streams.
- **sp** (spatial parallel): the plane rows of each frame split into bands
  across devices (``parallel.bands``).  tpuvf's ``shard_map`` with
  ``ppermute`` halos becomes stages run in lock-step over the bands, so a
  stencil reads its neighbours' rows of the previous stage's output.

A `Mesh` is an ordered ``{axis: size}`` over an array of ``torch.device``.
A device may appear more than once: ``make_mesh({"dp": 1, "sp": 4},
devices=["cpu"] * 4)`` is how the CPU tests run (the counterpart of tpuvf's
8 virtual host devices), and ``["cuda:0"] * 4`` how one card rehearses sp.
That is a test vehicle: the bands then share one device and buy nothing.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from tpuvf_torch.parallel import bands


class Mesh:
    """An ordered ``{axis: size}`` (`shape`, `axis_names`) over an object
    array of ``torch.device`` (`devices`, one axis per name)."""

    def __init__(self, devices: np.ndarray, axis_names: Sequence[str]):
        if devices.ndim != len(axis_names):
            raise ValueError(f"{devices.ndim}-d device array for axes "
                             f"{tuple(axis_names)}")
        self.devices = devices
        self.axis_names = tuple(axis_names)
        self.shape: Dict[str, int] = dict(zip(self.axis_names,
                                              devices.shape))

    def __repr__(self):
        return f"Mesh({self.shape}, {[str(d) for d in self.devices.flat]})"


def make_mesh(axes: Optional[Dict[str, int]] = None, devices=None) -> Mesh:
    """A Mesh from ``{'dp': n, 'sp': m}`` (tpuvf's ``make_mesh``): by default
    every device on dp.  `devices` defaults to the CUDA devices and raises
    without one; nothing falls back to the CPU (pass ``["cpu"] * n`` for
    that).  Raises when the mesh needs more devices than it is given."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("make_mesh: no CUDA device "
                               "(torch.cuda.is_available() is False); pass "
                               "devices=['cpu'] * n for a CPU mesh")
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devices = [torch.device(d) for d in devices]
    if axes is None:
        axes = {"dp": len(devices)}
    total = int(np.prod(list(axes.values())))
    if total > len(devices):
        raise ValueError(f"mesh {axes} needs {total} devices, have "
                         f"{len(devices)}")
    arr = np.empty(total, dtype=object)
    arr[:] = devices[:total]
    return Mesh(arr.reshape(tuple(axes.values())), tuple(axes.keys()))


@dataclass(frozen=True)
class Layout:
    """A mesh as the runner uses it: `dp` shards of `sp` bands, band s of
    shard d on ``devices[d][s]``.  Axes other than dp and sp replicate in
    tpuvf; the runner computes them once, on their index 0."""

    dp: int
    sp: int
    devices: Tuple[Tuple[torch.device, ...], ...]
    key: tuple  # the per-shard state's key: (sorted mesh shape, sp_axis)


def layout(mesh: Mesh, sp_axis: Optional[str],
           dp_axis: str = "dp") -> Layout:
    """The runner's view of `mesh` with rows over `sp_axis` (None, absent
    or of size 1: no row bands)."""
    if dp_axis not in mesh.shape:
        raise ValueError(
            f"mesh {dict(mesh.shape)} has no '{dp_axis}' axis — build it "
            f"with {{'{dp_axis}': 1, ...}} for sp-only sharding")
    live = sp_axis is not None and mesh.shape.get(sp_axis, 1) > 1
    arr = mesh.devices
    names = list(mesh.axis_names)
    order = [names.index(dp_axis)] + ([names.index(sp_axis)] if live else [])
    arr = np.moveaxis(arr, order, list(range(len(order))))
    arr = arr.reshape(arr.shape[:len(order)] + (-1,))[..., 0]
    if not live:
        arr = arr[:, None]
    devices = tuple(tuple(arr[d, s] for s in range(arr.shape[1]))
                    for d in range(arr.shape[0]))
    return Layout(arr.shape[0], arr.shape[1], devices,
                  (tuple(sorted(mesh.shape.items())), sp_axis))


def shard_frames(lay: Layout, batch_size: int, n: int) -> List[tuple]:
    """One batch over the dp shards (the split of tpuvf's
    ``parallel_batch_fn``): -> [(d, the batch's frames shard d takes)],
    shard d taking ``[d*b/dp, (d+1)*b/dp)`` in order, each shard's frames
    one sub-batch (one graph a shard, the twin of each shard's local scan).
    A short last batch (n < batch_size) is padded in tpuvf by repeating its
    last frame, with the carried state frozen across the phantom frames and
    their outputs dropped; here the phantom frames are not run, which
    leaves every shard's state where its last real frame left it, and a
    shard with no real frame is left out."""
    per = batch_size // lay.dp
    out = []
    for d in range(lay.dp):
        frames = list(range(d * per, min(n, (d + 1) * per)))
        if frames:
            out.append((d, frames))
    return out


# -- per-shard, per-band state ------------------------------------------------


def map_leaves(state, fn):
    """`state` with `fn` applied to each leaf (dicts, tuples and lists
    kept)."""
    if isinstance(state, dict):
        return {k: map_leaves(v, fn) for k, v in state.items()}
    if isinstance(state, (tuple, list)):
        return type(state)(map_leaves(v, fn) for v in state)
    return fn(state)


def _banded(leaf) -> bool:
    """tpuvf's leaf rule: a plane-shaped leaf (two axes or more) shards its
    rows under sp; everything else is replicated."""
    return isinstance(leaf, torch.Tensor) and leaf.dim() >= 2


def tile_state(state: Dict, lay: Layout,
               replicated=frozenset()) -> List[List[Dict]]:
    """One stream's state -> ``[shard][band]`` states (tpuvf's
    ``tile_state`` with the sp leaf rule): every shard starts from
    `state`; a plane-shaped leaf is cut into the bands' rows, except in the
    `replicated` elements (branches feeding an aggregator pad, which hold
    full rows on every band); every leaf lies on its band's device."""
    out = []
    for devs in lay.devices:
        shard = [{} for _ in devs]
        for name, st in (state or {}).items():
            for s, dev in enumerate(devs):
                def put(leaf, s=s, dev=dev):
                    if not isinstance(leaf, torch.Tensor):
                        return leaf
                    if _banded(leaf) and name not in replicated:
                        lo, hi = bands.band_rows(leaf.shape[-2], lay.sp, s)
                        leaf = leaf[..., lo:hi, :]
                    return leaf.to(dev).contiguous()

                shard[s][name] = map_leaves(st, put)
        out.append(shard)
    return out


def untile_state(shard: List[Dict], device,
                 replicated=frozenset()) -> Dict:
    """One shard's ``[band]`` states -> the stream's state on `device`:
    plane-shaped leaves joined from the bands' rows, everything else (and
    every leaf of a replicated element) band 0's."""
    def to(x):
        return x.to(device) if isinstance(x, torch.Tensor) else x

    out = {}
    for name, st in shard[0].items():
        if name in replicated or len(shard) == 1:
            out[name] = map_leaves(st, to)
            continue
        per_band = [leaves(b[name]) for b in shard]
        joined = [bands.all_rows([lv[k] for lv in per_band], device)
                  if _banded(leaf) else to(leaf)
                  for k, leaf in enumerate(per_band[0])]
        out[name] = _unflatten(st, joined)
    return out


def state_window(per_band: List, band: bands.Band, device):
    """Band `band`'s state for its input window: every plane-shaped leaf
    gathered over the window's rows from the bands' leaves (a previous
    frame's halo rows, as the planes'), every other leaf the band's own."""
    per_leaf = [leaves(b) for b in per_band]
    out = []
    for k, leaf in enumerate(per_leaf[band.index]):
        if _banded(leaf):
            pieces = [lv[k] for lv in per_leaf]
            lo, hi = bands.plane_rows(band.in_lo, band.in_hi,
                                      leaf.shape[-2] * len(pieces),
                                      band.in_height)
            leaf = bands.window(pieces, lo, hi, device)
        out.append(leaf)
    return _unflatten(per_band[band.index], out)


def leaves(state) -> list:
    """The leaves of `state`, in `map_leaves` order."""
    flat = []
    map_leaves(state, flat.append)
    return flat


def _unflatten(like, values: list):
    """`like` with its leaves replaced by `values`, in order."""
    it = iter(values)
    return map_leaves(like, lambda _: next(it))
