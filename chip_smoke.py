#!/usr/bin/env python3
"""Smoke check of the PyTorch/CUDA port (tpuvf_torch) on one NVIDIA GPU.

    python3 chip_smoke.py        # from the root of a checkout; needs one card

Phases (each prints its own lines; any failure exits 1 with no result line):

1. the card: nvidia-smi's name and power limit, torch and CUDA versions;
2. build the hand-written CUDA kernels from tpuvf_torch/csrc with nvcc (one
   nvcc per source, all started together, then one link);
3. each kernel against its plain PyTorch version on the card, at the main
   paths' shapes, timed beside it (CUDA events, median of 20):
   K1 (resample_rows_f32) and K1b (resample_cols_f32), bitwise;
   K2 (emit_u8/emit_f32, the fused emit) against emit_plain at 1080p and
   4K: YUV with u8 and f32 luma, RGBA u8, the letterbox border, and the
   gate sets b/c/s, b/c/s + chroma key and all seven with frame index 7,
   bitwise (the all-gates case may differ by 1 LSB where the kernel's powf
   and torch.pow's differ; the line says so);
   K3 (lut3d_trilinear_f32) against apply_lut_t_plain at 1080p with seeded
   non-identity 17^3, 33^3 and 64^3 tables, bitwise on the float32 output
   and on the quantizing epilogue;
4. the main paths through tpuvf_torch.cli.launch.parse_pipeline on "cuda",
   8 frames each: (a) appsrc NV12 1920x1080 -> vfmetalconvertscale -> BGRA
   640x480 -> vfmetalvideofilter b/c/s -> appsink; (b) the same at
   3840x2160 identity; (c) BASELINE config 3, appsrc NV12 1920x1080 ->
   vfmetalvideofilter b/c/s + chroma key + a seeded non-identity 33^3 .cube
   -> appsink NV12, and the same to BGRA through vfmetalconvertscale;
   (d) appsrc RGBA 1920x1080 -> vfmetalvideofilter 17^3 grade + contrast +
   sharpness -> BGRA.  The kernels' launch counters are set to 0 just before
   each run and read just after; each kernel of the path must have grown.
   Frame 0 must be within 1 LSB of the same pipeline on the CPU;
   device-resident us/frame of the built step and wall fps of Pipeline.run
   (upload and readback included) are printed;
5. two small chains on the card against the repo's numpy oracle of the Metal
   semantics (tests/oracle), within its 2-LSB tolerance: b/c/s, and
   b/c/s + chroma key + a 9^3 LUT.

The line before the last is a JSON object {"kernels": [...]}; the last line
is {"ok": true, "device": {...}}.  Matmul TF32 is switched off (the sampler
contract is full float32), though the port runs no matmul.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import tempfile
import time
import traceback
from pathlib import Path

FRAMES = 8
BCS = "vfmetalvideofilter brightness=0.05 contrast=1.1 saturation=1.2"
CONFIG3 = ("vfmetalvideofilter brightness=0.1 contrast=1.2 saturation=1.3 "
           "chroma-key-enabled=true")


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


def counters():
    """{kernel label: its wrapper}; each wrapper counts its launches."""
    from tpuvf_torch.kernels import emit, lut, resample

    return {"K1": resample.resample_rows, "K1b": resample.resample_cols,
            "K2": emit.emit, "K3": lut.lut3d}


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
    names = " ".join(p.name for p in _build.sources())
    print(f"[2 build] nvcc {' '.join(_build.NVCC_FLAGS)}: {names} -> "
          f"{_build.LIBRARY.name} in {_build.build_seconds:.2f} s",
          flush=True)


def record(summary, name, err, ms=None, plain_ms=None):
    entry = summary.setdefault(name, {"max_abs_err": 0.0})
    entry["max_abs_err"] = max(entry["max_abs_err"], err)
    if ms is not None and "ms" not in entry:  # the first timed case
        entry["ms"], entry["plain_ms"] = ms, plain_ms


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


def phase_resample(summary):
    """K1/K1b; the JSON times are the 4K chroma shape's (chain (b))."""
    import torch

    from tpuvf_torch.kernels import resample, sample
    from tpuvf_torch.kernels.color import dequant

    gen = torch.Generator(device="cuda").manual_seed(1234)
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
        print(f"[3 K1/K1b] {label} {tuple(x.shape)}->{tuple(got.shape)}: "
              f"torch.equal OK | kernel {ms * 1e3:.1f} us, plain "
              f"{plain_ms * 1e3:.1f} us", flush=True)
        record(summary, "K1" if axis == "rows" else "K1b", err, ms, plain_ms)


GATE_SETS = {
    "b/c/s": {"brightness": 0.05, "contrast": 1.1, "saturation": 1.2},
    "b/c/s + chroma key": {"brightness": 0.1, "contrast": 1.2,
                           "saturation": 1.3, "chroma_key_enabled": 1.0},
    "all seven gates": {"brightness": -0.05, "contrast": 1.1,
                        "saturation": 0.9, "hue": 0.4 * 3.141592653589793,
                        "gamma": 1.8, "sepia": 0.3, "invert": 1.0,
                        "chroma_key_enabled": 1.0, "key_r": 0.4,
                        "key_g": 0.6, "key_b": 0.2, "key_tolerance": 0.3,
                        "vignette": 0.5, "noise": 0.3},
}
DEFAULT_PARAMS = {"brightness": 0.0, "contrast": 1.0, "saturation": 1.0,
                  "hue": 0.0, "gamma": 1.0, "sepia": 0.0, "invert": 0.0,
                  "noise": 0.0, "vignette": 0.0, "chroma_key_enabled": 0.0,
                  "key_r": 0.0, "key_g": 1.0, "key_b": 0.0,
                  "key_tolerance": 0.2, "key_smoothness": 0.1,
                  "sharpness": 0.0}
EMIT_CASES = [
    # (label, source, h, w, border, gate set, frame index, float output)
    ("4K YUV u8 luma, b/c/s (chain (b))", "yuv_u8", 2160, 3840, False,
     "b/c/s", 0, False),
    ("4K YUV u8 luma, convert only", "yuv_u8", 2160, 3840, False, None, 0,
     False),
    ("1080p YUV u8 luma, b/c/s + chroma key -> f32 (chain (c))", "yuv_u8",
     1080, 1920, False, "b/c/s + chroma key", 0, True),
    ("1080p YUV f32 luma, convert only", "yuv_f32", 1080, 1920, False, None,
     0, False),
    ("480p YUV f32 luma, convert only (chain (a))", "yuv_f32", 480, 640,
     False, None, 0, False),
    ("1080p RGBA u8, b/c/s", "rgba_u8", 1080, 1920, False, "b/c/s", 0, False),
    ("1080p RGBA f32, convert only", "rgba_f32", 1080, 1920, False, None, 0,
     False),
    ("1080p YUV f32 luma, letterbox border", "yuv_f32", 1080, 1920, True,
     None, 0, False),
    ("1080p YUV u8 luma, all seven gates, frame 7", "yuv_u8", 1080, 1920,
     False, "all seven gates", 7, False),
    ("4K RGBA u8, all seven gates, frame 7", "rgba_u8", 2160, 3840, False,
     "all seven gates", 7, False),
]


def emit_inputs(kind, h, w, gen):
    import torch

    def u8(*shape):
        return torch.randint(0, 256, shape, generator=gen, device="cuda",
                             dtype=torch.uint8)

    def f32(*shape):
        return torch.rand(shape, generator=gen, device="cuda")

    if kind == "yuv_u8":
        return {"y": u8(h, w), "u": f32(h, w), "v": f32(h, w)}
    if kind == "yuv_f32":
        return {"y": f32(h, w), "u": f32(h, w), "v": f32(h, w)}
    if kind == "rgba_u8":
        return {"rgba": u8(4, h, w)}
    return {"rgba": f32(4, h, w)}


def phase_emit(summary):
    """K2 against emit_plain; the JSON times are chain (b)'s 4K emit."""
    import numpy as np
    import torch

    from tpuvf_torch.kernels import convert, emit, filter as kfilter

    gen = torch.Generator(device="cuda").manual_seed(2024)
    for label, kind, h, w, border, gates_name, frame, out_float in EMIT_CASES:
        src = emit_inputs(kind, h, w, gen)
        bplan = (convert.plan_border(w, h, 1.0, 0.75, (0.1, 0.2, 0.3, 1.0),
                                     "cuda") if border else None)
        adjust = None
        if gates_name:
            values = dict(DEFAULT_PARAMS, **GATE_SETS[gates_name])
            params = {k: torch.tensor(np.float32(v), device="cuda")
                      for k, v in values.items()}
            gates = {"hue": values["hue"] != 0.0,
                     "gamma": values["gamma"] != 1.0,
                     "sepia": values["sepia"] > 0.0,
                     "invert": values["invert"] > 0.0,
                     "chroma_key": values["chroma_key_enabled"] > 0.0,
                     "vignette": values["vignette"] > 0.0,
                     "noise": values["noise"] > 0.0}
            adjust = emit.Adjust(
                params, torch.tensor(frame, dtype=torch.int64, device="cuda"),
                kfilter.plan_coords(w, h, "cuda"), gates)
        args = (src, 0, bplan, adjust, out_float)
        got = emit.emit(*args)
        want = emit.emit_plain(*args)
        torch.cuda.synchronize()
        err = float((got.float() - want.float()).abs().max())
        note = "torch.equal OK"
        if not torch.equal(got, want):
            if gates_name == "all seven gates" and err <= 1:
                share = float((got != want).float().mean())
                note = (f"max 1 LSB on {share:.4%} of values (gamma: the "
                        f"kernel's powf vs torch.pow)")
            else:
                fail(f"K2 {label}: kernel != emit_plain (max |diff| {err})")
        ms = cuda_ms(lambda: emit.emit(*args))
        plain_ms = cuda_ms(lambda: emit.emit_plain(*args))
        print(f"[3 K2] {label}: {note} | kernel {ms * 1e3:.1f} us, plain "
              f"{plain_ms * 1e3:.1f} us", flush=True)
        record(summary, "K2", err, ms, plain_ms)


def grade_cube(size, seed):
    """A seeded non-identity (S, S, S, 3) [b][g][r] grade: a channel mix
    plus noise, so swapped axes or corners show."""
    import numpy as np

    rng = np.random.default_rng(seed)
    t = np.linspace(0.0, 1.0, size)
    b, g, r = np.meshgrid(t, t, t, indexing="ij")
    mix = np.stack([0.7 * r + 0.2 * g + 0.1 * b, 0.1 * r + 0.6 * g + 0.3 * b,
                    0.3 * r * g + 0.7 * b], -1)
    return np.clip(mix + rng.normal(0, 0.05, mix.shape), 0, 1).astype(
        np.float32)


def write_cube(path, table):
    with open(path, "w") as fh:
        fh.write(f"TITLE \"chip_smoke grade\"\nLUT_3D_SIZE {table.shape[0]}\n")
        for rgb in table.reshape(-1, 3):
            fh.write(f"{rgb[0]:.6f} {rgb[1]:.6f} {rgb[2]:.6f}\n")
    return str(path)


def phase_lut(summary):
    """K3 against lut3d_plain at 1080p; the JSON times are the 33^3
    quantizing case's (chain (c))."""
    import torch

    from tpuvf_torch.kernels import filter as kfilter, lut

    gen = torch.Generator(device="cuda").manual_seed(33)
    x = torch.rand((4, 1080, 1920), generator=gen, device="cuda")
    for size in (17, 33, 64):
        grid = torch.arange(size, device="cuda") / float(size - 1)
        x[:3, 0, :size] = grid  # exact grid points, 0 and 1
        x[:3, 1, 0], x[:3, 1, 1] = 0.0, 1.0
        table = torch.from_numpy(
            kfilter.pack_lut_corners(grade_cube(size, seed=size))).cuda()
        for quantize in (True, False):
            got = lut.lut3d(x, table, size, quantize)
            want = lut.lut3d_plain(x, table, size, quantize)
            torch.cuda.synchronize()
            err = float((got.float() - want.float()).abs().max())
            if not torch.equal(got, want):
                fail(f"K3 {size}^3 quantize={quantize}: kernel != plain "
                     f"(max |diff| {err})")
            ms = cuda_ms(lambda: lut.lut3d(x, table, size, quantize))
            plain_ms = cuda_ms(lambda: lut.lut3d_plain(x, table, size,
                                                       quantize))
            kind = "u8 epilogue" if quantize else "f32"
            print(f"[3 K3] 1080p {size}^3 table ({table.numel() * 4 / 1e6:.2f}"
                  f" MB), {kind}: torch.equal OK | kernel {ms * 1e3:.1f} us, "
                  f"plain {plain_ms * 1e3:.1f} us", flush=True)
            record(summary, "K3", err, ms if size == 33 and quantize else None,
                   plain_ms)


def nv12_frames(n, w, h, seed):
    import numpy as np

    rng = np.random.default_rng(seed)
    return [{"y": rng.integers(0, 256, (h, w), dtype=np.uint8),
             "uv": rng.integers(0, 256, (h // 2, w), dtype=np.uint8)}
            for _ in range(n)]


def rgba_frames(n, w, h, seed):
    import numpy as np

    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, (h, w, 4), dtype=np.uint8) for _ in range(n)]


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


def _planes(frame):
    return frame if isinstance(frame, dict) else {"frame": frame}


def phase_chain(label, desc, frames, expect, opaque=False):
    """Drive one main path on the card; -> {kernel: launches}."""
    import numpy as np
    import torch

    wrappers = counters()
    pipe = fed_pipeline(desc, frames, "cuda")
    for w in wrappers.values():
        w.launches = 0
    n = pipe.run()
    torch.cuda.synchronize()
    launches = {k: w.launches for k, w in wrappers.items()}
    if n != len(frames):
        fail(f"{label}: ran {n} of {len(frames)} frames")
    missing = [k for k in expect if launches[k] == 0]
    if missing:
        fail(f"{label}: launch counters {launches}; the path did not reach "
             f"{', '.join(missing)}")
    outs = [_planes(f) for f in pipe["appsink0"].frames]
    for i, f in enumerate(outs):
        for k, v in f.items():
            if v.dtype != np.uint8 or v.size == 0:
                fail(f"{label}: frame {i} plane {k} is {v.dtype}{v.shape}")
        if opaque and not (f["frame"][..., 3] == 255).all():
            fail(f"{label}: frame {i} alpha is not opaque")
    if all(np.array_equal(outs[0][k], outs[1][k]) for k in outs[0]):
        fail(f"{label}: distinct input frames gave equal outputs")
    cpu = fed_pipeline(desc, frames[:1], "cpu")
    cpu.run()
    ref = _planes(cpu["appsink0"].frames[0])
    worst, differ, total = 0, 0, 0
    for k in ref:
        if ref[k].shape != outs[0][k].shape:
            fail(f"{label}: plane {k} {outs[0][k].shape} vs CPU {ref[k].shape}")
        d = np.abs(outs[0][k].astype(np.int32) - ref[k].astype(np.int32))
        worst, differ, total = (max(worst, int(d.max())),
                                differ + int((d > 0).sum()), total + d.size)
    if worst > 1:
        fail(f"{label}: frame 0 differs from the CPU run by {worst} LSB")

    planes = pipe.upload(frames[0])
    params, state = pipe.params(), pipe.state
    step_ms = cuda_ms(lambda: pipe.step(planes, state, params))
    pipe.frames, pipe.wall_seconds = 0, 0.0
    pipe.run()  # warm: planned and allocated by the first run
    fps = pipe.frames / pipe.wall_seconds
    counts = ", ".join(f"{k} {v}" for k, v in launches.items())
    print(f"[4 main path] {label}: {n} frames on cuda | launches {counts} | "
          f"frame 0 vs CPU max {worst} LSB, {differ / total:.4%} differ | "
          f"device step {step_ms * 1e3:.1f} us/frame | Pipeline.run wall "
          f"{fps:.2f} fps (upload + readback)", flush=True)
    return launches


def phase_chains(tmp):
    """Chains (a)-(d); -> {kernel: launches summed over the chains}."""
    lut33 = write_cube(Path(tmp) / "grade33.cube", grade_cube(33, seed=3))
    lut17 = write_cube(Path(tmp) / "grade17.cube", grade_cube(17, seed=17))
    chains = [
        ("(a) NV12 1920x1080 -> BGRA 640x480 + b/c/s",
         f"appsrc format=NV12 width=1920 height=1080 ! vfmetalconvertscale ! "
         f"video/x-raw,format=BGRA,width=640,height=480 ! {BCS} ! appsink",
         nv12_frames(FRAMES, 1920, 1080, seed=1920), ("K1", "K1b", "K2"),
         True),
        ("(b) NV12 3840x2160 -> BGRA 3840x2160 + b/c/s",
         f"appsrc format=NV12 width=3840 height=2160 ! vfmetalconvertscale ! "
         f"video/x-raw,format=BGRA,width=3840,height=2160 ! {BCS} ! appsink",
         nv12_frames(FRAMES, 3840, 2160, seed=3840), ("K1", "K1b", "K2"),
         True),
        ("(c) config 3: NV12 1920x1080 b/c/s + chroma key + 33^3 LUT -> NV12",
         f"appsrc format=NV12 width=1920 height=1080 ! {CONFIG3} "
         f"lut-file={lut33} ! appsink",
         nv12_frames(FRAMES, 1920, 1080, seed=3), ("K1", "K1b", "K2", "K3"),
         False),
        ("(c) config 3 -> BGRA",
         f"appsrc format=NV12 width=1920 height=1080 ! {CONFIG3} "
         f"lut-file={lut33} ! vfmetalconvertscale ! video/x-raw,format=BGRA "
         f"! appsink",
         nv12_frames(FRAMES, 1920, 1080, seed=4), ("K1", "K1b", "K2", "K3"),
         False),
        ("(d) RGBA 1920x1080 17^3 LUT + contrast + sharpness -> BGRA",
         f"appsrc format=RGBA width=1920 height=1080 ! vfmetalvideofilter "
         f"lut-file={lut17} contrast=1.1 sharpness=0.5 ! vfmetalconvertscale "
         f"! video/x-raw,format=BGRA ! appsink",
         rgba_frames(FRAMES, 1920, 1080, seed=17), ("K2", "K3"), False),
    ]
    total = {}
    for label, desc, frames, expect, opaque in chains:
        for k, v in phase_chain(label, desc, frames, expect, opaque).items():
            total[k] = total.get(k, 0) + v
    return total


def phase_oracle(tmp):
    """Small chains on the card against tests/oracle (numpy Metal
    semantics; tolerance 2 LSB as in the repo's golden tests)."""
    import importlib.util

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
    frames = nv12_frames(1, w, h, seed=7)
    spec = FrameSpec(VideoFormat.NV12, w, h)
    planes = host_to_planes(frames[0], spec)
    u = dict(brightness=0.05, contrast=1.1, saturation=1.2, hue=0.0,
             gamma=1.0, sepia=0.0, invert=False, chroma_key_enabled=False,
             key_r=0.0, key_g=1.0, key_b=0.0, key_tolerance=0.2,
             key_smoothness=0.1, vignette=0.0, noise=0.0)

    def texcoords(cw, ch):
        tx = (np.arange(cw, dtype=np.float32) + 0.5) / cw
        ty = (np.arange(ch, dtype=np.float32) + 0.5) / ch
        return np.stack(np.broadcast_arrays(tx[None, :], ty[:, None]), -1)

    def compare(label, got, want):
        worst = max(int(np.abs(got[k].astype(np.int32)
                               - want[k].astype(np.int32)).max())
                    for k in want)
        if worst > 2:
            fail(f"oracle: {label} off by {worst} LSB")
        print(f"[5 oracle] {label} on cuda vs numpy oracle: max {worst} LSB "
              f"(tolerance 2)", flush=True)

    desc = (f"appsrc format=NV12 width={w} height={h} ! vfmetalconvertscale "
            f"! video/x-raw,format=RGBA,width={ow},height={oh} ! {BCS} "
            f"! appsink")
    pipe = fed_pipeline(desc, frames, "cuda")
    pipe.run()
    mid = metal_ref.quant(metal_ref.sample_rgba(
        planes, "NV12", spec.matrix_index, ow, oh))
    want = metal_ref.quant(filter_ref.apply_color_adjustments(
        metal_ref.dequant(mid), u, texcoords(ow, oh), 0))
    compare(f"NV12 {w}x{h} -> RGBA {ow}x{oh} + b/c/s",
            {"rgba": pipe["appsink0"].frames[0]}, {"rgba": want})

    table = grade_cube(9, seed=9)
    lut9 = write_cube(Path(tmp) / "grade9.cube", table)
    desc = (f"appsrc format=NV12 width={w} height={h} ! {CONFIG3} "
            f"lut-file={lut9} ! appsink")
    pipe = fed_pipeline(desc, frames, "cuda")
    pipe.run()
    got = pipe["appsink0"].frames[0]
    uk = dict(u, brightness=0.1, contrast=1.2, saturation=1.3,
              chroma_key_enabled=True)
    rgba = filter_ref.apply_color_adjustments(
        metal_ref.sample_rgba(planes, "NV12", spec.matrix_index, w, h), uk,
        texcoords(w, h), 0)
    rgba = filter_ref.apply_lut(rgba, table, table.shape[0])
    want = metal_ref.pack_rgba(metal_ref.quant(rgba).transpose(2, 0, 1),
                               "NV12", spec.matrix_index)
    got_planes = host_to_planes(got, spec)
    compare(f"NV12 {w}x{h} b/c/s + chroma key + 9^3 LUT -> NV12",
            got_planes, want)


KERNELS = (
    # (label, JSON name, source, the TPU kernel it replaces)
    ("K1", "resample_rows_f32 (K1)", "tpuvf_torch/csrc/resample.cu",
     "tpuvf/kernels/pallas/resample.py:152"),
    ("K1b", "resample_cols_f32 (K1b)", "tpuvf_torch/csrc/resample.cu",
     "tpuvf/kernels/sample.py:164"),
    ("K2", "emit_u8/emit_f32 (K2)", "tpuvf_torch/csrc/emit.cu",
     "scripts/probe_mosaic_emit.py:46"),
    ("K3", "lut3d_trilinear_f32 (K3)", "tpuvf_torch/csrc/lut.cu",
     "scripts/bench_gather.py:111"),
)


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
    summary = {}
    phase_resample(summary)
    phase_emit(summary)
    phase_lut(summary)
    with tempfile.TemporaryDirectory() as tmp:
        launches = phase_chains(tmp)
        phase_oracle(tmp)
    kernels = [{"name": name, "route": "cuda", "source": source,
                "replaces": replaces, "launches": launches[label],
                "max_abs_err": summary[label]["max_abs_err"],
                "ms": summary[label]["ms"],
                "plain_ms": summary[label]["plain_ms"]}
               for label, name, source, replaces in KERNELS]
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
