"""The row-sharded 9-tap blur with explicit halos (port of
``tpuvf.parallel.halo``, tpuvf's standalone prototype of the exchange).

The videofilter's separable blur reads 4 rows past a band's edge
(metalvideofilter_shaders.h:257-299).  With the rows split into bands, each
band takes 4 rows from its neighbours (`bands.pad_rows_halo`: clamp to the
frame's edge at its top and bottom), blurs locally, and keeps its rows.
"""

from __future__ import annotations

import numpy as np
import torch

from tpuvf_torch.kernels import filter as kfilter
from tpuvf_torch.parallel import bands


def sp_devices(mesh, sp_axis: str = "sp") -> list:
    """The devices along `sp_axis` (index 0 on every other axis)."""
    names = list(mesh.axis_names)
    arr = np.moveaxis(mesh.devices, names.index(sp_axis), 0)
    return list(arr.reshape(arr.shape[0], -1)[:, 0])


def sharded_blur9(img: torch.Tensor, mesh, sp_axis: str = "sp"):
    """Separable 9-tap Gaussian of float32 (..., H, W) with its rows split
    over `sp_axis`: horizontal taps band-local, vertical taps over a 4-row
    halo.  Bitwise equal to ``blur9(blur9(img, -1), -2)`` on one device;
    the result lies on `img`'s device."""
    devices = sp_devices(mesh, sp_axis)
    halo = 4
    pieces = [kfilter.blur9(p, axis=-1)
              for p in bands.split_rows(img, devices)]
    n = pieces[0].shape[-2]
    out = []
    for s, dev in enumerate(devices):
        padded = bands.pad_rows_halo(pieces, s, halo, halo, dev)
        acc = None
        for i, w in enumerate(kfilter.BLUR_WEIGHTS.tolist()):
            tap = padded[..., i:i + n, :] * w
            acc = tap if acc is None else acc + tap
        out.append(acc)
    return bands.all_rows(out, img.device)
