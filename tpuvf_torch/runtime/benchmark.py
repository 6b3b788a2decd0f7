"""Benchmark helpers: batched steps and overhead-cancelling timing (port of
``tpuvf.runtime.benchmark``).

- `sync` waits for a result on its device;
- `make_batch_fn` runs a per-frame step over a leading batch axis, the
  carried state threaded through the frames in order (tpuvf scans the step
  in one XLA program; the port enqueues the steps back to back);
- `measure_fps` is the two-point slope: a small and a large batch timed
  (best of `reps`), their difference over the frame difference, which
  cancels a fixed per-call cost;
- `measure_device_us` reads the device's kernel time per frame from
  torch.profiler's CUDA events, where tpuvf reads a TPU trace;
- `random_planes_for_spec` makes canonical planes on a device, "cuda"
  unless the caller asks for "cpu".  tpuvf's split and quad link layouts
  are not ported (by design), so those requests raise.

A time from a CPU run is the CPU's, never the card's: `measure_device_us`
refuses planes that are not on a CUDA device.
"""

from __future__ import annotations

import time
from typing import Callable, Dict

import numpy as np
import torch


def _first_tensor(out) -> torch.Tensor:
    while not isinstance(out, torch.Tensor):
        out = next(iter(out.values())) if isinstance(out, dict) else out[0]
    return out


def sync(out):
    """Wait until `out` (a tensor, or dicts/sequences of them) is computed
    on its device; -> its first element, on the host."""
    leaf = _first_tensor(out)
    if leaf.device.type == "cuda":
        torch.cuda.synchronize(leaf.device)
    return leaf.reshape(-1)[:1].cpu().numpy()


def make_batch_fn(step: Callable):
    """step(frame_planes, state, params) -> (out_planes, state) ->
    batch_step(planes, state, params) -> (outs, state): planes and outs
    carry a leading batch axis, the state goes through the frames in
    order, and params are the same for every frame."""

    def batch_step(planes: Dict, state, params):
        n = len(next(iter(planes.values())))
        outs = []
        for b in range(n):
            out, state = step({k: v[b] for k, v in planes.items()}, state,
                              params)
            outs.append(out)
        return {k: torch.stack([o[k] for o in outs]) for k in outs[0]}, state

    return batch_step


def time_best(fn, *args, reps=4) -> float:
    """Best host-clock seconds of fn(*args) over `reps` calls, each waited
    for on its device."""
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        out, _ = fn(*args)
        sync(out)
        best = min(best, time.perf_counter() - t0)
    return best


def measure_fps(
    step: Callable,
    make_planes: Callable[[int], Dict],
    state0,
    params=None,
    batch_small: int = 4,
    batch_large: int = 16,
    reps: int = 4,
) -> dict:
    """Two-point throughput of a per-frame step (tpuvf's
    ``measure_fps``): `make_planes(n)` gives n frames' planes on the
    step's device; state0 and params are on it too."""
    fn = make_batch_fn(step)
    params = params if params is not None else {}
    planes_s = make_planes(batch_small)
    planes_l = make_planes(batch_large)
    sync(fn(planes_s, state0, params)[0])  # warm up (first-use build)
    sync(fn(planes_l, state0, params)[0])
    t_small = time_best(fn, planes_s, state0, params, reps=reps)
    t_large = time_best(fn, planes_l, state0, params, reps=reps)
    per_frame = (t_large - t_small) / (batch_large - batch_small)
    if per_frame <= 0:
        per_frame = t_large / batch_large
    return {
        "fps": 1.0 / per_frame,
        "ms_per_frame": per_frame * 1000.0,
        "t_small": t_small,
        "t_large": t_large,
        "batches": (batch_small, batch_large),
    }


def random_planes_for_spec(spec, batch, rng=None, split=False,
                           device="cuda") -> Dict[str, torch.Tensor]:
    """Random canonical uint8 planes of `spec` with a leading batch axis,
    on `device`.  `split` (tpuvf's column-phase or quad link layouts) is
    not ported and raises."""
    if split:
        raise NotImplementedError(
            f"random_planes_for_spec(split={split!r}): tpuvf's split and "
            f"quad link layouts are not ported; the port's planes are "
            f"canonical")
    from tpuvf_torch.runtime.device import get_device

    dev = get_device(device)
    rng = rng or np.random.default_rng(0)
    out = {}
    for p in spec.planes:
        shape = (batch,) + ((p.channels,) if p.channels > 1 else ()) + (
            p.height, p.width)
        out[p.name] = torch.from_numpy(
            rng.integers(0, 256, shape, dtype=np.uint8)).to(dev)
    return out


def measure_device_us(step, make_planes, state0, params=None,
                      n_frames: int = 30):
    """Device time per frame (us) of one step: the CUDA kernels' summed
    self time in torch.profiler over `n_frames` steps of the first frame
    of `make_planes(1)` (tpuvf's ``measure_device_us`` reads a TPU trace).
    -> {"us_per_frame", "fps_device"}, or None when the profiler recorded
    no device time.  Planes that are not on a CUDA device raise."""
    from torch.profiler import ProfilerActivity, profile

    planes = {k: v[0] for k, v in make_planes(1).items()}
    leaf = _first_tensor(planes)
    if leaf.device.type != "cuda":
        raise ValueError(f"measure_device_us needs planes on a CUDA device, "
                         f"got {leaf.device}")
    params = params if params is not None else {}
    for _ in range(4):
        out, _ = step(planes, state0, params)
    sync(out)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n_frames):
            out, _ = step(planes, state0, params)
        sync(out)
    total_us = sum(e.self_device_time_total for e in prof.key_averages())
    if total_us <= 0:
        return None
    us = total_us / n_frames
    return {"us_per_frame": us, "fps_device": 1e6 / us}
