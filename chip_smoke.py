#!/usr/bin/env python3
"""Smoke check of the PyTorch/CUDA port (tpuvf_torch) on one NVIDIA GPU.

    python3 chip_smoke.py        # from the root of a checkout; needs one card

Phases (each prints its own lines; any failure exits 1 with no result line):

1. the card: nvidia-smi's name and power limit, torch and CUDA versions;
2. build the hand-written CUDA kernels from tpuvf_torch/csrc with nvcc;
3. K1 (resample_rows_f32) and K1b (resample_cols_f32) against their plain
   PyTorch versions at the main path's shapes: bitwise (torch.equal), each
   timed beside its plain version (CUDA events, median of 20);
4. the main path through tpuvf_torch.cli.launch.parse_pipeline on "cuda":
   (a) appsrc NV12 1920x1080 -> vfmetalconvertscale -> BGRA 640x480 ->
   vfmetalvideofilter b/c/s -> appsink, and (b) the same chain at 3840x2160
   identity, 8 frames each.  The kernels' launch counters are reset just
   before each run and must have grown; frame 0 must be within 1 LSB of the
   same pipeline on the CPU; device-resident us/frame of the built step and
   wall fps of Pipeline.run (upload and readback included) are printed;
5. a small chain on the card against the repo's numpy oracle of the Metal
   semantics (tests/oracle), within its 2-LSB tolerance.

The line before the last is a JSON object {"kernels": [...]}; the last line
is {"ok": true, "device": {...}}.  Matmul TF32 is switched off (the sampler
contract is full float32), though the slice runs no matmul.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
import traceback

FRAMES = 8
BCS = "vfmetalvideofilter brightness=0.05 contrast=1.1 saturation=1.2"


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", flush=True)
    sys.exit(1)


def cuda_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Median device time of fn() in ms (CUDA events around each call)."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def phase_card():
    import torch

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    if smi.returncode != 0:
        fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0]
    print(card)
    print(f"[1 card] {card} | torch {torch.__version__} | CUDA "
          f"{torch.version.cuda} | device 0: {torch.cuda.get_device_name(0)} "
          f"| count {torch.cuda.device_count()}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print("[1 card] TF32 off for matmul and cuDNN (float32 sampler contract)")
    return card


def phase_build():
    from tpuvf_torch.kernels import _build

    _build.build()  # always from the checkout's sources
    _build.load()
    print(f"[2 build] nvcc {' '.join(_build.NVCC_FLAGS)}: "
          f"{_build.SOURCE.name} -> {_build.LIBRARY.name} in "
          f"{_build.build_seconds:.2f} s", flush=True)


KERNEL_CASES = [
    # (label, wrapper, planes, rows, cols, out size, filter, scale)
    ("4K chroma rows 1080->2160", "rows", 2, 1080, 1920, 2160, "linear", 1.0),
    ("4K chroma cols 1920->3840", "cols", 2, 2160, 1920, 3840, "linear", 1.0),
    ("1080p luma rows 1080->480", "rows", 1, 1080, 1920, 480, "linear", 1.0),
    ("1080p luma cols 1920->640", "cols", 1, 480, 1920, 640, "linear", 1.0),
    ("1080p chroma rows 540->480", "rows", 2, 540, 960, 480, "linear", 1.0),
    ("1080p chroma cols 960->640", "cols", 2, 480, 960, 640, "linear", 1.0),
    ("letterbox rows 1080->480 (scale 0.75)", "rows", 1, 1080, 1920, 480,
     "linear", 0.75),
    ("pillarbox cols 1440->1920 (scale 0.75)", "cols", 1, 1080, 1440, 1920,
     "linear", 0.75),
    ("nearest rows 1080->480", "rows", 1, 1080, 1920, 480, "nearest", 1.0),
    ("nearest cols 1920->640", "cols", 1, 480, 1920, 640, "nearest", 1.0),
]


def phase_kernels():
    """-> {wrapper: {"max_abs_err", "ms", "plain_ms"}} (times at the 4K
    chroma shape, the headline chain's)."""
    import torch

    from tpuvf_torch.kernels import resample, sample
    from tpuvf_torch.kernels.color import dequant

    gen = torch.Generator(device="cuda").manual_seed(1234)
    summary = {}
    for label, axis, planes, rows, cols, out, filt, scale in KERNEL_CASES:
        in_size = rows if axis == "rows" else cols
        t = sample.texcoords(out, scale)
        mask = sample.coverage_mask(out, scale)
        taps = resample.make_taps(sample.plan_taps(t, in_size, filt, mask),
                                  in_size, "cuda")
        x = dequant(torch.randint(0, 256, (planes, rows, cols), generator=gen,
                                  device="cuda", dtype=torch.uint8))
        kern = getattr(resample, f"resample_{axis}")
        plain = getattr(resample, f"resample_{axis}_plain")
        got = kern(x, taps)
        want = plain(x, taps)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        if not torch.equal(got, want):
            fail(f"K1/K1b {label}: kernel != plain version (max |diff| {err})")
        ms = cuda_ms(lambda: kern(x, taps))
        plain_ms = cuda_ms(lambda: plain(x, taps))
        print(f"[3 kernels] {label} {tuple(x.shape)}->{tuple(got.shape)}: "
              f"torch.equal OK | kernel {ms * 1e3:.1f} us, plain "
              f"{plain_ms * 1e3:.1f} us", flush=True)
        entry = summary.setdefault(axis, {"max_abs_err": 0.0})
        entry["max_abs_err"] = max(entry["max_abs_err"], err)
        if "ms" not in entry:  # the first case per axis: the 4K chroma shape
            entry["ms"], entry["plain_ms"] = ms, plain_ms
    return summary


def nv12_frames(n, w, h, seed):
    import numpy as np

    rng = np.random.default_rng(seed)
    return [{"y": rng.integers(0, 256, (h, w), dtype=np.uint8),
             "uv": rng.integers(0, 256, (h // 2, w), dtype=np.uint8)}
            for _ in range(n)]


def fed_pipeline(desc, frames, device):
    from tpuvf_torch.cli.launch import parse_pipeline

    pipe = parse_pipeline(desc, device=device)
    src = pipe["appsrc0"]
    for f in frames:
        src.push(f)
    src.end_of_stream()
    pipe.negotiate()
    pipe.build()
    return pipe


def phase_chain(label, in_w, in_h, out_w, out_h):
    """Drive one main-path chain on the card; -> (rows, cols) launches."""
    import numpy as np
    import torch

    from tpuvf_torch.kernels import resample

    desc = (f"appsrc format=NV12 width={in_w} height={in_h} ! "
            f"vfmetalconvertscale ! video/x-raw,format=BGRA,width={out_w},"
            f"height={out_h} ! {BCS} ! appsink")
    frames = nv12_frames(FRAMES, in_w, in_h, seed=in_w)
    pipe = fed_pipeline(desc, frames, "cuda")
    resample.resample_rows.launches = 0
    resample.resample_cols.launches = 0
    n = pipe.run()
    torch.cuda.synchronize()
    launches = (resample.resample_rows.launches,
                resample.resample_cols.launches)
    if n != FRAMES:
        fail(f"{label}: ran {n} of {FRAMES} frames")
    if launches[0] == 0 or launches[1] == 0:
        fail(f"{label}: kernel launch counters rows={launches[0]} "
             f"cols={launches[1]}; the main path did not reach K1 and K1b")
    outs = pipe["appsink0"].frames
    for i, f in enumerate(outs):
        if f.shape != (out_h, out_w, 4) or f.dtype != np.uint8:
            fail(f"{label}: frame {i} is {f.dtype}{f.shape}")
        if not (f[..., 3] == 255).all():
            fail(f"{label}: frame {i} alpha is not opaque")
    if np.array_equal(outs[0], outs[1]):
        fail(f"{label}: distinct input frames gave equal outputs")
    cpu = fed_pipeline(desc, frames[:1], "cpu")
    cpu.run()
    ref = cpu["appsink0"].frames[0]
    diff = np.abs(outs[0].astype(np.int32) - ref.astype(np.int32))
    if diff.max() > 1:
        fail(f"{label}: frame 0 differs from the CPU run by {diff.max()} LSB")

    planes = pipe.upload(frames[0])
    params, state = pipe.params(), pipe.state
    step_ms = cuda_ms(lambda: pipe.step(planes, state, params))
    pipe.frames, pipe.wall_seconds = 0, 0.0
    pipe.run()  # warm: planned and allocated by the first run
    fps = pipe.frames / pipe.wall_seconds
    print(f"[4 main path] {label}: {n} frames on cuda | launches K1 "
          f"{launches[0]}, K1b {launches[1]} | frame 0 vs CPU max "
          f"{int(diff.max())} LSB, {float((diff > 0).mean()):.4%} differ | "
          f"device step {step_ms * 1e3:.1f} us/frame | Pipeline.run wall "
          f"{fps:.2f} fps (upload + readback)", flush=True)
    return launches


def phase_oracle():
    """A small chain on the card against tests/oracle (numpy Metal
    semantics; tolerance 2 LSB as in the repo's golden tests)."""
    import importlib.util
    from pathlib import Path

    import numpy as np

    from tpuvf_torch.core.frame import host_to_planes
    from tpuvf_torch.core.spec import FrameSpec
    from tpuvf_torch.core.formats import VideoFormat

    def oracle(name):  # by path: another installed "tests" may shadow it
        path = Path(__file__).resolve().parent / "tests" / "oracle" / name
        spec_ = importlib.util.spec_from_file_location(path.stem, path)
        mod = importlib.util.module_from_spec(spec_)
        spec_.loader.exec_module(mod)
        return mod

    metal_ref, filter_ref = oracle("metal_ref.py"), oracle("filter_ref.py")
    w, h, ow, oh = 64, 36, 32, 24
    desc = (f"appsrc format=NV12 width={w} height={h} ! vfmetalconvertscale "
            f"! video/x-raw,format=RGBA,width={ow},height={oh} ! {BCS} "
            f"! appsink")
    frames = nv12_frames(1, w, h, seed=7)
    pipe = fed_pipeline(desc, frames, "cuda")
    pipe.run()
    got = pipe["appsink0"].frames[0]
    spec = FrameSpec(VideoFormat.NV12, w, h)
    planes = host_to_planes(frames[0], spec)
    mid = metal_ref.quant(metal_ref.sample_rgba(
        planes, "NV12", spec.matrix_index, ow, oh))
    tx = (np.arange(ow, dtype=np.float32) + 0.5) / ow
    ty = (np.arange(oh, dtype=np.float32) + 0.5) / oh
    tc = np.stack(np.broadcast_arrays(tx[None, :], ty[:, None]), -1)
    u = dict(brightness=0.05, contrast=1.1, saturation=1.2, hue=0.0,
             gamma=1.0, sepia=0.0, invert=False, chroma_key_enabled=False,
             key_r=0.0, key_g=1.0, key_b=0.0, key_tolerance=0.2,
             key_smoothness=0.1, vignette=0.0, noise=0.0)
    want = metal_ref.quant(filter_ref.apply_color_adjustments(
        metal_ref.dequant(mid), u, tc, 0))
    diff = np.abs(got.astype(np.int32) - want.astype(np.int32))
    if diff.max() > 2:
        fail(f"oracle: {w}x{h} -> {ow}x{oh} chain off by {diff.max()} LSB")
    print(f"[5 oracle] NV12 {w}x{h} -> RGBA {ow}x{oh} + b/c/s on cuda vs "
          f"numpy oracle: max {int(diff.max())} LSB (tolerance 2)",
          flush=True)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this check needs a card")
    try:
        import tpuvf_torch  # noqa: F401
    except ImportError as exc:
        fail(f"run from the root of a tpuvf checkout ({exc})")
    t0 = time.perf_counter()
    phase_card()
    phase_build()
    summary = phase_kernels()
    launches_a = phase_chain("(a) NV12 1920x1080 -> BGRA 640x480 + b/c/s",
                             1920, 1080, 640, 480)
    launches_b = phase_chain("(b) NV12 3840x2160 -> BGRA 3840x2160 + b/c/s",
                             3840, 2160, 3840, 2160)
    phase_oracle()
    kernels = []
    for idx, (axis, name, replaces) in enumerate((
            ("rows", "resample_rows_f32 (K1)",
             "tpuvf/kernels/pallas/resample.py:152"),
            ("cols", "resample_cols_f32 (K1b)",
             "tpuvf/kernels/sample.py:164"))):
        s = summary[axis]
        kernels.append({
            "name": name, "route": "cuda",
            "source": "tpuvf_torch/csrc/resample.cu", "replaces": replaces,
            "launches": launches_a[idx] + launches_b[idx],
            "max_abs_err": s["max_abs_err"], "ms": s["ms"],
            "plain_ms": s["plain_ms"]})
    print(f"chip_smoke: all phases passed in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except Exception:  # noqa: BLE001 - any failure must exit non-zero
        traceback.print_exc()
        print("chip_smoke: FAIL: unexpected error (traceback above)",
              flush=True)
        sys.exit(1)
