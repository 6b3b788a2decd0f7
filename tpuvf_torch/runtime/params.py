"""Carry a tpuvf element's parameters and state over to the port.

tpuvf elements hand their per-frame inputs around as numpy: `traced_params()`
gives float32 scalars plus the element's registered ``__buf/...`` weight
buffers (sampling matrices, border masks, the compositor's background),
videofilter's corner-packed 3D-LUT table ``"lut"`` and the compositor's
per-pad int32/float32 geometry, and `init_state()` gives numpy state such as
videofilter's uint32 frame counter.  `from_tpuvf` turns those
into what the port's `process` functions take on a device, and
`controllers_from_tpuvf` carries an element's property schedules
(`Element.control`), so one animation set up on a tpuvf element runs on
the port's as well.
"""

from __future__ import annotations

import numpy as np
import torch

from tpuvf_torch.parallel.mesh import leaves, map_leaves


_LUT_SCALES = {np.dtype(np.uint8): np.float32(1.0 / 255.0),
               np.dtype(np.uint16): np.float32(1.0 / 65535.0)}


def _lut_table(arr: np.ndarray) -> torch.Tensor:
    if arr.ndim != 2 or arr.shape[1] != 24:
        raise ValueError(f"lut: expected the corner-packed (S^3, 24) table, "
                         f"got {list(arr.shape)}")
    if arr.dtype == np.float32:
        return torch.from_numpy(np.ascontiguousarray(arr))
    if arr.dtype not in _LUT_SCALES:
        raise NotImplementedError(f"lut table of type {arr.dtype}")
    scaled = arr.astype(np.float32) * _LUT_SCALES[arr.dtype]
    return torch.from_numpy(np.ascontiguousarray(scaled, np.float32))


def from_tpuvf(params: dict, state, device, tiled: bool = False):
    """(tpuvf traced params, tpuvf state) -> (port params, port state).

    With `tiled`, `state` is the element's entry of tpuvf's mesh state
    (``Pipeline._mesh_state[1]``, ``tpuvf/parallel/mesh.py``
    ``tile_state``): every leaf has a leading dp axis, and a plane-shaped
    leaf holds the frame's rows (the bands' rows joined, as a global array
    of a row-sharded run holds them).  The port state is then a list, one
    whole-frame state per dp shard (``[]`` for an empty state), which
    ``Pipeline.load_mesh_state`` cuts into the port's bands.

    - float scalars become 0-dim float32 tensors on `device`;
    - ``__buf/...`` buffers are dropped: the port plans its taps and masks
      from the geometry at build time;
    - ``"lut"``, the (S^3, 24) corner table, becomes a float32 tensor on
      `device`: a float32 table unchanged; tpuvf's fixed-point uint8 or
      uint16 tables (its default storage) as corners * f32(1/255) or
      f32(1/65535).  tpuvf scales the fixed-point sum once after the
      trilinear blend, the port each corner before it, so a lookup through
      a carried fixed-point table may differ from tpuvf's by 1 LSB after
      quantization;
    - the compositor's pad parameters become host numbers, as its own
      `traced_params` gives them: ``pad.<name>.xpos``, ``ypos`` and
      ``operator`` (int32) Python ints, ``pad.<name>.alpha`` a Python float
      holding its float32 value.  Its ``__buf/bg`` background canvas is
      dropped with the other buffers (the port plans the background);
      ``fold.<name>.alpha``, the alpha of a vfoverlay folded into the
      compositor, is a Python float holding its float32 value as well;
    - integer state (the frame counter) becomes a 0-dim int64 tensor whose
      value is the uint32 counter, which the port increments modulo 2**32;
    - vfdeinterlace's state: ``prev``, tpuvf's tuple of four (H, W) uint8
      planes, becomes one (4, H, W) uint8 tensor on `device`, and
      ``has_prev`` a Python bool;
    - empty state (``()`` or ``{}``) stays empty.
    """
    out_params = {}
    for key, value in params.items():
        if key.startswith("__buf/"):
            continue
        arr = np.asarray(value)
        if key.startswith(("pad.", "fold.")) and arr.ndim == 0:
            if key.endswith(".alpha"):
                out_params[key] = float(np.float32(arr))
                continue
            if arr.dtype.kind in "ui":
                out_params[key] = int(arr)
                continue
        if key == "lut":
            out_params[key] = _lut_table(arr).to(device)
            continue
        if arr.ndim != 0 or arr.dtype.kind != "f":
            raise NotImplementedError(
                f"parameter {key!r} ({arr.dtype}{list(arr.shape)}) has no "
                f"port counterpart yet")
        out_params[key] = torch.tensor(float(np.float32(arr)),
                                       dtype=torch.float32, device=device)
    if tiled:
        flat = leaves(state)
        dp = len(np.asarray(flat[0])) if flat else 0
        return out_params, [
            _state_from_tpuvf(map_leaves(state, lambda a, d=d: np.asarray(
                a)[d]), device) for d in range(dp)]
    return out_params, _state_from_tpuvf(state, device)


def _state_from_tpuvf(state, device):
    if isinstance(state, dict):
        out_state = {}
        for key, value in state.items():
            arr = np.asarray(value)
            if key == "prev" and arr.dtype == np.uint8 and arr.ndim == 3:
                out_state[key] = torch.from_numpy(
                    np.ascontiguousarray(arr)).to(device)
                continue
            if key == "has_prev" and arr.ndim == 0 and arr.dtype == np.bool_:
                out_state[key] = bool(arr)
                continue
            if arr.ndim != 0 or arr.dtype.kind not in "ui":
                raise NotImplementedError(
                    f"state {key!r} ({arr.dtype}{list(arr.shape)}) has no "
                    f"port counterpart yet")
            out_state[key] = torch.tensor(int(arr) & 0xFFFFFFFF,
                                          dtype=torch.int64, device=device)
        return out_state
    return state


def controllers_from_tpuvf(tpuvf_element, element) -> None:
    """Attach each of the tpuvf element's property schedules to the port's
    `element` (`Element.control`): a sequence as a list of Python numbers
    (numpy scalars converted), a callable as it is.  tpuvf checked each
    sequence when it was attached, so none is checked again here."""
    for name, values in tpuvf_element._controllers.items():
        if not callable(values):
            values = [v.item() if isinstance(v, np.generic) else v
                      for v in values]
        element.control(name, values, allow_structure_change=True)
