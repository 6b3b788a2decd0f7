"""One run of one cell: set-up, the measured window, the check.

Set-up makes the frame pool from the seed, parses and builds the
configuration's launch description with the harness's sink, pushes the pool
through the ``appsrc`` sources in a cycle and warms up the cell's loop at
its own batch size or frame key, so that every CUDA graph is captured before
the window.  The window is one call of the program's loop:

- batched: ``Pipeline.run_batched(n, batch_size)``, n a multiple of the
  batch size sized from about a second of calibration calls so that the
  call lasts about ``seconds``; ``fps`` is the frames delivered over the
  call's wall time;
- live: ``Pipeline.run_live(rate * seconds)``; a frame's latency runs from
  its due time, ``t0 + k / rate`` with ``t0`` the first reading of the
  ``time_fn`` handed to ``run_live``, to its arrival at the sink.

After the window (memory read, the program's state freed) the reference
recomputes the frames the check reads and ``check`` compares them.
"""

from __future__ import annotations

import gc
import math
import shutil
import sys
import tempfile
import time
from types import SimpleNamespace

import numpy as np
import torch

from vfbench import check, inputs, roofline, sink as bench_sink, spec
from vfbench import trace as tracing
from vfbench.reference import Reference

COUNTERS = ("keys", "captures", "replays", "eager", "batch_captures",
            "batch_replays")
WARM_FRAMES = 16  # a batched warm-up: batch 0 eager, batch 1 captured
CALIBRATE_BATCHES = 8
CALIBRATE_S = 1.0


def log(msg: str) -> None:
    print(f"vfbench: {msg}", file=sys.stderr, flush=True)


def seed64(seed: int) -> int:
    """The seed as a generator takes it: its low 64 bits."""
    return int(seed) & 0xFFFFFFFFFFFFFFFF


def build(cell: spec.Cell, seed: int, device, tmp: str):
    """The pipeline, its pool and its sink, before any frame runs."""
    from tpuvf_torch.cli.launch import parse_pipeline

    ref, trf = cell.config["reference"], cell.traffic
    bench_sink.register()
    png = ""
    if ref.get("overlay"):
        png = inputs.write_png(f"{tmp}/overlay.png",
                               inputs.overlay_image(ref["overlay"]))
    pool = inputs.frame_pool(ref["sources"], trf["pool"], seed64(seed),
                             device)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
    rate = float(trf["rate"])
    fps = (f"{int(rate)}/1" if rate == int(rate)
           else f"{round(rate * 1000)}/1000")
    desc = cell.config["launch"].format(fps=fps, png=png)
    pipe = parse_pipeline(desc, device=str(device))
    for ctl in trf.get("controls", ()):
        pipe[ctl["element"]].control(
            ctl["property"],
            lambda k, c=ctl: inputs.schedule_value(c, trf["rate"], k))
    return pipe, pool


def feed(pipe, pool: dict, n: int) -> None:
    """Extend each appsrc's queue to n frames, the pool in a cycle."""
    for name, frames in pool.items():
        src = pipe[name]
        for k in range(len(src._queue), n):
            src.push(frames[k % len(frames)])


def rate_of(pipe, pool: dict, n: int, batch_size: int) -> float:
    """Frames a second of one `run_batched` call of n frames."""
    n = max(n, batch_size)
    feed(pipe, pool, n)
    t = time.perf_counter()
    pipe.run_batched(n, batch_size=batch_size)
    return n / (time.perf_counter() - t)


def counters(pipe) -> dict:
    c = pipe.compiled
    return {k: getattr(c, k) for k in COUNTERS}


def latencies_ms(arrivals: np.ndarray, t0: float, rate: float) -> np.ndarray:
    k = np.nonzero(~np.isnan(arrivals))[0]
    return (arrivals[k] - (t0 + k / rate)) * 1e3


def end_to_end(name: str, w) -> float | None:
    if name == "setup_s":
        return w.setup_s
    if name == "fps":
        return w.delivered / w.wall_s
    if name.startswith("latency_p") and name.endswith("_ms") and w.lat_ms.size:
        return float(np.percentile(w.lat_ms, float(name[9:-3])))
    return None


def run_cell(cell: spec.Cell, seed: int, seconds: float, trace_on: bool,
             device="cuda", t_start: float | None = None) -> dict:
    t_start = time.perf_counter() if t_start is None else t_start
    device = torch.device(device)
    cfg, trf = cell.config, cell.traffic
    ref = cfg["reference"]
    rate, batched = float(trf["rate"]), trf["loop"] == "batched"
    if trf.get("host_threads"):
        torch.set_num_threads(int(trf["host_threads"]))
    tmp = tempfile.mkdtemp(prefix="vfbench-")
    parts = {"start": time.perf_counter() - t_start}
    try:
        pipe, pool = build(cell, seed, device, tmp)
        parts["pool_parse"] = time.perf_counter() - t_start
        out = ref["output"]
        if batched:
            bs = int(trf["batch_size"])
            feed(pipe, pool, WARM_FRAMES)
            pipe.run_batched(WARM_FRAMES, batch_size=bs)
            # a first guess, then about CALIBRATE_S of replays, which also
            # grows the host allocator's pinned pool to its steady size
            est = rate_of(pipe, pool, CALIBRATE_BATCHES * bs, bs)
            est = rate_of(pipe, pool, int(est * CALIBRATE_S / bs) * bs, bs)
            n = max(bs, int(est * seconds / bs) * bs)
        else:
            n = max(2, int(round(rate * seconds)))
            feed(pipe, pool, WARM_FRAMES)
            pipe.run(WARM_FRAMES)
        parts["warm_up"] = time.perf_counter() - t_start
        feed(pipe, pool, n)
        sample = inputs.sample_frames(seed, n, trf)
        keep = {k: inputs.host_array((out["height"], out["width"], 4))
                for k in sample}
        sink = pipe["out"]
        sink.arm(n, keep)
        stats = pipe.stats
        edge0, dropped0 = dict(stats.edge_seconds), stats.frames_dropped
        count0 = counters(pipe)
        gc.collect()
        gc.freeze()
        first = []

        def time_fn():
            t = time.perf_counter()
            if not first:
                first.append(t)
            return t

        def sleep_fn(s):
            with torch.profiler.record_function("vfbench.sleep"):
                time.sleep(s)

        prof = None
        if trace_on:
            from torch.profiler import ProfilerActivity, profile

            acts = [ProfilerActivity.CPU]
            if device.type == "cuda":
                acts.append(ProfilerActivity.CUDA)
            prof = profile(activities=acts)
            prof.__enter__()
        setup_s = time.perf_counter() - t_start
        log("set-up s (cumulative): " + ", ".join(
            f"{k} {v:.3f}" for k, v in parts.items())
            + f", window {setup_s:.3f}")
        with torch.profiler.record_function("vfbench.window.open"):
            pass
        t0 = time.perf_counter()
        if batched:
            pipe.run_batched(n, batch_size=bs)
        else:
            pipe.run_live(n, time_fn=time_fn, sleep_fn=sleep_fn)
        wall = time.perf_counter() - t0
        with torch.profiler.record_function("vfbench.window.close"):
            pass
        reduced = None
        if prof is not None:
            prof.__exit__(None, None, None)
            evs = tracing.events(prof.profiler.kineto_results)
            reduced = tracing.reduce(evs, tracing.window_of(evs))
        peak = (torch.cuda.max_memory_allocated(device)
                if device.type == "cuda" else 0)
        edge = {k: v - edge0[k] for k, v in stats.edge_seconds.items()}
        dropped = stats.frames_dropped - dropped0
        cdelta = {k: v - count0[k] for k, v in counters(pipe).items()}
        received, arrivals = sink.received, sink.arrivals
        kept = set(sink.kept)
        gc.unfreeze()
        del pipe, sink, stats, prof
        gc.collect()
        if device.type == "cuda":
            torch.cuda.empty_cache()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    window = SimpleNamespace(
        setup_s=setup_s, wall_s=wall, delivered=received,
        lat_ms=(latencies_ms(arrivals, first[0], rate) if first
                else np.zeros(0)))
    tally = check.Tally()
    # every frame is delivered or dropped by the live loop's QoS
    tally.missing = max(0, n - received - dropped)
    reference = Reference(device)
    for k in sample:
        if k not in kept:
            if not math.isnan(arrivals[k]):
                tally.missing += 1
            continue
        frames = {s: pool[s][k % len(pool[s])] for s in pool}
        want = reference.frame(ref, frames, inputs.frame_values(trf, k))
        tally.add(*check.compare(keep[k], want))
    correct, numbers = check.judge(tally.numbers(), cfg["limits"])
    correct = correct and tally.frames > 0

    result = {"correct": correct, "attempted": n, "failed": n - received}
    metrics = {}
    if not trace_on:
        for m in cell.end_to_end:
            v = end_to_end(m["name"], window)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        ctx = SimpleNamespace(
            frames=received, edge=edge, counters=cdelta, trace=reduced,
            bytes_per_frame=roofline.bytes_per_frame(ref),
            peak_bytes_s=roofline.peak_bytes_s(device_kind(device)))
        for m in cell.per_layer:
            v = spec.load_reader(m["name"]).read(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    result["metrics"] = metrics
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": device_kind(device), "count": cell.chips,
           "memory_peak_bytes": int(peak)}
    if reduced is not None:
        dev["busy_s"] = reduced["busy_s"]
        dev["window_s"] = reduced["window_s"]
        result["breakdown"] = {"device_ops": reduced["device_ops"],
                               "idle_gaps": reduced["idle_gaps"]}
    result["device"] = dev
    result["check_frames"] = tally.frames
    result["check"] = numbers  # last: the numbers compared, with limits
    return result


def device_kind(device) -> str:
    if device.type == "cuda":
        return torch.cuda.get_device_name(device)
    return device.type
