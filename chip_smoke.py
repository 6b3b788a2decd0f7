#!/usr/bin/env python3
"""Smoke check of the PyTorch/CUDA port (tpuvf_torch) on one NVIDIA GPU.

    python3 chip_smoke.py        # from the root of a checkout; needs one card
    python3 chip_smoke.py --host-steps   # only the chains' host-side times
    python3 chip_smoke.py --mesh         # only the card, the build and (m)
    python3 chip_smoke.py --compiled     # the card, the build, K4, (n), (o)

Phases (each prints its own lines; any failure exits 1 with no result line):

1. the card: nvidia-smi's name and power limit, torch and CUDA versions;
2. build the hand-written CUDA kernels from tpuvf_torch/csrc with nvcc (one
   nvcc per source, all started together, then one link);
3. each kernel against its plain PyTorch version on the card, at the main
   paths' shapes, timed beside it (CUDA events, median of 20); at each
   kernel's JSON shape also its device time (torch.profiler self time per
   launch), its bound (the bytes it must move at 3.35 TB/s, or its float32
   operations at 67 TFLOP/s, whichever is longer) and the share, and the
   one PyTorch call that computes the same function where there is one
   (bilinear F.interpolate for K1/K1b, F.grid_sample for K3), timed as a
   yardstick only:
   K1 (resample_rows_f32) and K1b (resample_cols_f32), bitwise; K1b's
   cases print how many tiles took the shared-memory band and how many
   the direct gather (4-byte copies at 959 -> 1918, descending texcoords,
   masked tiles, an 8x downscale whose spans are too wide to stage);
   K2 (emit_u8/emit_f32, the fused emit) against emit_plain at 1080p and
   4K: YUV with u8 and f32 luma, RGBA u8, the letterbox border, and the
   gate sets b/c/s, b/c/s + chroma key and all seven with frame index 7,
   and the sizes and views that pick its scalar path (637x479, U and V
   planes of one stacked tensor), each line naming its path, bitwise (the
   all-gates case may differ by 1 LSB where the kernel's powf and
   torch.pow's differ; the line says so); at chain (b)'s RGBA shape also a
   torch clone of the stack, what a copy that reads and writes it once
   reaches;
   K3 (lut3d_trilinear_f32) against apply_lut_t_plain at 1080p with seeded
   non-identity 17^3, 33^3 and 64^3 tables, bitwise on the float32 output
   and on the quantizing epilogue, on uniform noise, on chain (c)'s own
   LUT input and on a smooth gradient, each line naming the launcher's
   paths (its exported query, held to the mirror `lut.table_path`); each
   input also cropped to 1919x1079, whose pixel count takes the path of 1
   pixel a thread;
   K4 (composite_fold, vfcompositor's blend fold, reading its draws from
   a device table) against composite_fold_plain on the same table,
   bitwise: BASELINE config 5's shape (a 4K canvas,
   four u8/f32 draws, OVER, OVER at alpha 0.7, ADD), the same with the
   folded overlay as a fifth (mix) draw, the same shape placed off the
   4-pixel grid on a 3838-wide canvas (every draw and the canvas on the
   scalar path), a checker background with negative positions and SOURCE,
   more draws than one launch holds, and an sp band's canvas (its checker
   from frame row 1084, `Background.row0`, the table's rows the frame's);
   each line names each draw's path (the launcher's rule, held to the
   Python mirror); its device time is also read from torch.profiler and
   printed beside the config-5 time before the table;
   K5 (deinterlace_frame: deinterlace_yuv420_u8 and deinterlace_u8,
   vfdeinterlace's whole body in one launch) against
   deinterlace_frame_plain, bitwise on the output planes and the texture
   carried to the next frame: I420 in -> I420 or RGBA out and RGBA in ->
   RGBA or I420 out, bob, weave and greedy-H, tff True/False, with and
   without a previous frame, threshold 0.3, BT.601 in -> BT.709 out,
   1919x1079 crops (the scalar path), and a band whose motion equals the
   threshold exactly (it must take bob); at chain (g)'s I420 greedy-H shape
   also the device time of the launches the route replaced (the parent's
   K1, K1b, K2, field kernel and plain pack, this run), and chain (g')'s
   BGRA weave beside its bound;
   K6 (overlay_frame: overlay_yuv420_u8 and overlay_blend_u8, vfoverlay's
   whole body in one launch) against overlay_frame_plain, bitwise: chain
   (e')'s 4K NV12 frame with the 256x256 red PNG at (128, 128) (with the
   device time of the launches it replaced: K1, K1b, K2 to float32, the
   blend and the plain pack), 1080p I420 with a stretched 640x360 rect
   partly off-frame at relative-x 0.8, an empty rect, alpha 0, BT.601 in
   -> BT.709 out, a 1919x1079 crop (the scalar path), and the RGB route on
   a 4K canvas, its 1919x1079 crop and an empty rect; each K5 and K6 line
   names the launch's path (the kernel's template arguments as
   torch.profiler names them, held to the wrapper module's `route`);
4. the main paths through tpuvf_torch.cli.launch.parse_pipeline on "cuda",
   8 frames each: (a) appsrc NV12 1920x1080 -> vfmetalconvertscale -> BGRA
   640x480 -> vfmetalvideofilter b/c/s -> appsink; (b) the same at
   3840x2160 identity; (c) BASELINE config 3, appsrc NV12 1920x1080 ->
   vfmetalvideofilter b/c/s + chroma key + a seeded non-identity 33^3 .cube
   -> appsink NV12, and the same to BGRA through vfmetalconvertscale;
   (d) appsrc RGBA 1920x1080 -> vfmetalvideofilter 17^3 grade + contrast +
   sharpness -> BGRA; (e) BASELINE config 5: four appsrcs (BGRA 4K, NV12
   1080p, BGRA 720p at alpha 0.7, NV12 720p ADD) -> vfmetalcompositor ->
   BGRA 3840x2160 -> vfmetaloverlay of a 256x256 red PNG (alpha 128) at
   (128, 128), folded into K4 (K6 must not launch); (e') the same to NV12,
   where the overlay does not fold and runs one K6 a frame and no sampler
   or emit of its own; (f) a checker composite to NV12 1920x1080 of a
   scaled NV12 1080p pad at a negative position and a keep-aspect BGRA
   pad; (g) BASELINE config 4: appsrc I420 1920x1080 interlaced ->
   vfmetaldeinterlace greedy-H threshold 0.3 -> I420, a block moving over
   still frames, one K5 a frame and no K1, K1b or K2; (g') BGRA 1920x1080
   weave with field-layout=auto and each buffer's pushed TFF flag
   alternating, one K5 a frame; (h) BASELINE config 2:
   appsrc BGRA 640x480 -> vfmetaltransform clockwise, crop-left 32,
   crop-top 16; (h') NV12 1920x1080 counterclockwise, crop-right 64 ->
   NV12; (h'') NV12 1920x1080 rotate-180 (the flip fast path).  The
   kernels' launch counters are set to 0 just before each run and read
   just after; each kernel of the path must have grown, a kernel the
   path must not reach (K6 in (e), K1/K1b/K2 in (g)) must not have, and
   K5 and K6 must have launched exactly once a frame where so stated.
   Frame 0 must be within 1 LSB of the same pipeline on the CPU;
   device-resident us/frame of the built step (CUDA events and the host
   clock), its device-busy us (torch.profiler) and idle share, and wall fps
   of Pipeline.run (upload and readback included) are printed.  Then the
   multi-sink and file chains, 8 frames each: (i) appsrc NV12 3840x2160 ->
   vfmetalconvertscale -> BGRA -> tee -> vfmetalvideosink 1920x1200 and
   appsink, the window a 1920x1080 rect between 60-row bars (exact), its
   windows and the appsink's frames within 1 LSB of the CPU run, K1, K1b
   and K2 launched; (j) a seeded 1920x1080 It I420 .y4m (written here) ->
   y4msrc -> greedy-H -> tee -> y4menc ! filesink, and vfmetalconvertscale
   -> BGRA 1280x720 -> jpegenc ! multifilesink, the .y4m byte-equal to the
   CPU run's (or within 1 LSB per sample once parsed; the line says which),
   each JPEG decoded within 1 LSB of the CPU run's, one K5 a frame and K1,
   K1b, K2; (k) 8 seeded 3840x2160 UYVY frames in a raw file ->
   rawvideosrc -> vfmetalconvertscale -> BGRA 4K, and -> YUY2 1920x1080,
   each output file within 1 LSB of the CPU run's.  For every chain an
   [4 edge] line splits Pipeline.run's host time a frame: upload, step
   enqueue, the readback's enqueue, the wait on the previous frame's
   event, and delivery (the copy for a sink that keeps its frames, codecs
   and sinks);
(l) controllers, batched and live, 16 frames a path, each path's
   launch counters set to 0 just before it and read just after: (b) at
   NV12 3840x2160 with a 16-entry brightness ramp (`Element.control`)
   under run() and under run_batched (two batches of 8), equal frame for
   frame (0 LSB), frames 0 and 15 within 1 LSB of the CPU run, K1, K1b and
   K2 launched under both; (g) greedy-H at 1080i under two run_batched
   calls of 8 against two run() calls of 8 (the clock restarts each call,
   the carried frame does not), 0 LSB, one K5 a frame, then reset() and 4
   frames equal to a fresh pipeline's first 4; (f) with a sink_0::xpos
   ramp, run() against run_batched, 0 LSB, K4 launched, frames 0 and 15
   within 1 LSB of the CPU run; run_live on (a) at 30 fps: the period
   between deliveries, frames_dropped and latency(); one navigation event
   pair through (f) -> vfvideosink, routed (source and coordinates) as the
   CPU run routes them; Pipeline fps of (b) under run() and run_batched in
   turns, printed beside the card's name and power limit as a reading;
(m) dp/sp sharding (`run_batched(mesh=make_mesh(...), sp_axis="sp")`),
   on distinct cards where the machine has enough, else cuda:0 repeated
   (the line [m devices] says which), every path held 0 LSB to the same
   pipeline's unsharded run_batched on the card and to the same mesh run
   with every step eager, 8 frames a path at full width, run twice: a
   warm-up (each frame key once eagerly, the shard graphs captured), then
   the run whose counters are read alone, through one shard graph replay a
   shard a batch and no frame eager where each shard lies on one card,
   its launches printed beside the unsharded run's (sp times as many; the
   compositor samples a pad only on the bands its rect reaches); fps
   unsharded, with the shard graphs and eager, in turns: (b) on {dp 1,
   sp 2} and {dp 1,
   sp 4}; (d) on {dp 1, sp 4} (the 4-row blur halo); (c) -> NV12 on {dp 1,
   sp 2} (the chroma halo, the LUT, the YUV pack); (h) and (h') on {dp 1,
   sp 2} (every row gathered); (g) on {dp 1, sp 2} over two calls of 8
   (the banded previous frame); (e') on {dp 1, sp 2} (replicated pads, K4
   and K6 per band); (b) with a 16-entry brightness ramp on {dp 2, sp 2}
   against run(); (g) on {dp 2} with independent_streams=True against each
   shard's frames as their own stream, and without the flag the
   ValueError naming the deinterlacer; and the phase's time;
(n) the compiled step (``runtime/compiled.py``: each frame's step over
   fixed buffers, captured once per key as a CUDA graph and replayed):
   chains (a)-(k) under Pipeline.run, and (l)'s paths under run() and
   run_live ((b)'s brightness ramp and (f)'s sink_0::xpos ramp, each at
   one capture over 16 frames; run_live on (a); (f) into the navigation
   chain's vfvideosink; run_batched's are (o)'s), each against the same
   run with every step eager
   (`step_sources` and the sinks' payloads over the same buffers), byte
   for byte on every sink's frames (a live run: the frames both
   delivered); per path the keys, captures, replays and eager frames, the
   captures' wall time and compile_seconds; per chain (a)-(h'') the host
   step of the compiled body eager and with the graph (timed as phase 4
   times the step: params re-read and staged, then the body: the split,
   the stages, the sinks' payloads, the state write-back) and the device
   span of each (CUDA events); then a capture broken by a
   stage's host read, which must raise PipelineError naming that stage at
   the capturing frame; each path's counters set to 0 just before it and
   read just after;
(o) one graph a batch (`CompiledStep.step_batch`: run_batched's n steps
   captured as one CUDA graph once each frame key has run eagerly, one
   replay a batch): (b) at 4K with a 16-entry brightness ramp and (f) with
   a sink_0::xpos ramp (two calls of 16, batches of 8: one capture, three
   replays), (g) greedy-H over two calls of 8 and (e'), (h) and (c) ->
   NV12 over two calls of 8 (one capture, on the second call, and one
   replay), each
   against the same calls with every step eager, byte for byte; per path
   the batch captures and replays, each capture's peak device memory
   (`torch.cuda.max_memory_allocated` around it), the host step a batch
   (params staged and the step's enqueue) and run_batched's fps, eager and
   with the graphs in turns; then a batch capture broken by a stage's host
   read, which must raise PipelineError naming that stage at the batch's
   first frame; each path's counters set to 0 just before it and read
   just after;
5. small pipelines on the card against the repo's numpy oracle of the
   Metal semantics (tests/oracle), within its 2-LSB tolerance: b/c/s,
   b/c/s + chroma key + a 9^3 LUT, a BGRA + NV12 (alpha 0.6) composite
   over the checker background, two NV12 frames through greedy-H, an NV12
   transform clockwise with crops, and a PNG overlay on NV12.

Then one [roofline] line per kernel: its device time beside the one
measured on the kernels of commit d03551a (BEFORE_US), its bound and
share, its library call's device time and its launches on the main paths.
The line before the last is a JSON object {"kernels": [...]}, each entry
with ms and plain_ms (CUDA events), device_us, bound_us and bound_ms,
bound_by, library_ms (null where no single PyTorch call computes the
function) and the main paths' launches; the last line is {"ok": true,
"device": {...}}.  Matmul TF32 is switched off (the sampler contract is
full float32), though the port runs no matmul.

With --host-steps it runs only the card and build phases and the host side
of chains (a)-(h'') (`host_steps`: `step_sources`, and the compiled body
eager and with the graph, Pipeline.run's fps and its host edge), and prints no result line: to compare two checkouts, run it
from the root of each in turns within one call.
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
# BASELINE config 5 (bench/configs.py:186-257): the 4-pad 4K composite and
# its 256x256 red PNG overlay at (128, 128) ({png}), which the pipeline
# folds into the composite's K4 launch for an RGB output ({fmt} BGRA) and
# runs as its own K6 stage after a YUV one (NV12), as tpuvf does
# (tpuvf/runtime/pipeline.py:541-606)
CONFIG5 = ("vfmetalcompositor name=c background=black sink_1::xpos=1920 "
           "sink_2::ypos=1080 sink_2::alpha=0.7 sink_3::xpos=1920 "
           "sink_3::ypos=1080 sink_3::operator=add "
           "! video/x-raw,format={fmt},width=3840,height=2160 "
           "! vfmetaloverlay location={png} x=128 y=128 ! appsink "
           "appsrc name=s0 format=BGRA width=3840 height=2160 ! c.sink_0 "
           "appsrc name=s1 format=NV12 width=1920 height=1080 ! c.sink_1 "
           "appsrc name=s2 format=BGRA width=1280 height=720 ! c.sink_2 "
           "appsrc name=s3 format=NV12 width=1280 height=720 ! c.sink_3")
# BASELINE config 4 (bench/configs.py:177-183)
CONFIG4 = ("appsrc format=I420 width=1920 height=1080 "
           "! video/x-raw,interlace-mode=interleaved ! vfmetaldeinterlace "
           "method=greedyh motion-threshold=0.3 ! appsink")
CHAIN_F = ("vfmetalcompositor name=c background=checker sink_0::width=1280 "
           "sink_0::height=720 sink_0::xpos=-100 sink_0::ypos=40 "
           "sink_1::xpos=1000 sink_1::ypos=400 sink_1::width=800 "
           "sink_1::height=600 sink_1::sizing-policy=keep-aspect-ratio "
           "sink_1::alpha=0.8 "
           "! video/x-raw,format=NV12,width=1920,height=1080 ! appsink "
           "appsrc name=s0 format=NV12 width=1920 height=1080 ! c.sink_0 "
           "appsrc name=s1 format=BGRA width=1280 height=720 ! c.sink_1")


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


def host_us(fn, reps: int = 20, rounds: int = 5, sync: bool = True) -> float:
    """Host-clock us per call of fn(): the median over `rounds` of `reps`
    calls, the device drained before each round and, with `sync`, at its
    end (without: the host's enqueue alone, where the device keeps up)."""
    import torch

    fn()
    times = []
    for _ in range(rounds):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        if sync:
            torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) / reps * 1e6)
    torch.cuda.synchronize()
    return statistics.median(times)


def counters():
    """{kernel label: its wrapper}; each wrapper counts its launches."""
    from tpuvf_torch.kernels import (composite, deinterlace, emit, lut,
                                     overlay, resample)

    return {"K1": resample.resample_rows, "K1b": resample.resample_cols,
            "K2": emit.emit, "K3": lut.lut3d, "K4": composite.composite_fold,
            "K5": deinterlace.deinterlace_frame,
            "K6": overlay.overlay_frame}


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


# The card's peaks for the bound (H100 SXM, NVIDIA's data sheet, at the
# 700 W limit): HBM3 bandwidth, and float32 outside the tensor cores.
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
# float32 operations per output element at each kernel's JSON shape,
# counted from each source's arithmetic (2 mul + 1 add per 2-tap sample;
# the emit's yuv->rgb, b/c/s fold, clamps and quant; the LUT's 8 corner
# weights and 24 products; a blend per draw; K5's and K6's 4:2:0 routes:
# two 3-tap chroma samples and yuv->rgb per texel (1.5 texels a pixel for
# K5), the field logic or the blend, quant, and the pack's rgb->yuv and quad
# average).  K6's 4:2:0 route is bound by these operations; the others by
# their bytes.
OPS_PER_ELEMENT = {"K1": 3, "K1b": 3, "K2": 60, "K3": 90, "K4": 30,
                   "K5": 146, "K6": 90}
# the kernels' names as torch.profiler lists them
KERNEL_NAMES = {"K1": "resample_rows_kernel", "K1b": "resample_cols_kernel",
                "K2": "emit_kernel", "K3": "lut3d_kernel",
                "K4": "composite_fold_kernel",
                "K5": "deinterlace_pair_kernel",
                # overlay_yuv420_kernel (4:2:0) and overlay_blend_kernel (RGB)
                "K6": "overlay_"}


def moved_bytes(*tensors) -> int:
    """Bytes a function must move: each input read once, each output
    written once."""
    return sum(t.numel() * t.element_size() for t in tensors)


def lut_rows_bytes(x, size) -> int:
    """Bytes of the packed K3 table that the frame's pixels need: one
    96-byte corner row for each cell that some pixel falls in (the plain
    version's cell index, NaN to cell 0)."""
    import torch

    s1 = float(size - 1)
    r, g, b = (torch.nan_to_num(torch.floor(x[c] * s1), nan=0.0)
               .clamp(0.0, s1).long() for c in range(3))
    return int(torch.unique((b * size + g) * size + r).numel()) * 24 * 4


def bound_us(label, nbytes, elements, ops=None):
    """The least time the card could take: -> (us, "bytes"/"operations");
    `ops` per element where the case is not the JSON shape's."""
    by_bytes = nbytes / HBM_BYTES_PER_S * 1e6
    by_ops = (ops or OPS_PER_ELEMENT[label]) * elements / F32_OPS_PER_S * 1e6
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops,
                                                             "operations")


def kernel_device_us(fn, label, reps: int = 20) -> float:
    """Device time per launch of the kernel `label` in fn() (its profiler
    self time over the launches the profiler recorded; other kernels fn
    launches are left out)."""
    for _ in range(3):
        seen = [e for e in profiled(fn, reps) if KERNEL_NAMES[label] in e.key]
        if seen:
            return (sum(e.self_device_time_total for e in seen)
                    / sum(e.count for e in seen))
    fail(f"{label}: torch.profiler saw no {KERNEL_NAMES[label]}")


def roofline(summary, label, fn, nbytes, elements, library_ms=None,
             case=None, ops=None):
    """Device time of the kernel beside its bound.  The headline case of a
    kernel (case None: chip_smoke's JSON line) is stored in `summary`;
    another case prints its own before/after.  -> text."""
    dev = kernel_device_us(fn, label)
    bound, by = bound_us(label, nbytes, elements, ops)
    text = (f" | device {dev:.1f} us, bound {bound:.1f} us by {by} "
            f"({nbytes / 1e6:.1f} MB), {bound / dev:.0%} of it")
    if case is None:
        summary.setdefault(label, {"max_abs_err": 0.0}).update(
            device_us=dev, bound_us=bound, bound_by=by, library_ms=library_ms,
            moved_mb=nbytes / 1e6)
    elif f"{label} {case}" in BEFORE_US:
        before = BEFORE_US[f"{label} {case}"]
        text += (f" (before {before:.1f} us, {bound / before:.0%}, "
                 f"{BEFORE_CALL})")
    return text


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
    # K1b's paths: 4-byte copies and scalar stores (959 and 1918 are not
    # multiples of 4), descending texcoords, whole tiles masked, a span too
    # wide to stage; a trailing True flips the texcoords (rotate-180)
    ("1918-wide NV12 chroma cols 959->1918", "cols", 2, 1080, 959, 1918,
     "linear", 1.0),
    ("descending cols 1920->1280 (rotate-180)", "cols", 1, 720, 1920, 1280,
     "linear", 1.0, True),
    ("pillarbox cols 960->3840 (scale 0.25: masked tiles)", "cols", 1, 540,
     960, 3840, "linear", 0.25),
    ("wide-span cols 3840->480 (8x down)", "cols", 1, 1080, 3840, 480,
     "linear", 1.0),
]


def interpolate_yardstick(x, axis, out):
    """The one PyTorch call that computes K1's (rows) or K1b's (cols)
    half-texel clamp-to-edge 2-tap sample at scale 1: bilinear
    F.interpolate with the other axis at its own size.  -> (fn, its
    output)."""
    import torch.nn.functional as F

    size = ((out, x.shape[-1]) if axis == "rows" else (x.shape[-2], out))

    def fn():
        return F.interpolate(x[None], size=size, mode="bilinear",
                             align_corners=False)[0]

    return fn, fn()


def phase_resample(summary):
    """K1/K1b; the JSON times are the 4K chroma shape's (chain (b))."""
    import torch

    from tpuvf_torch.kernels import resample, sample
    from tpuvf_torch.kernels.color import dequant

    gen = torch.Generator(device="cuda").manual_seed(1234)
    for i, (label, axis, planes, rows, cols, out, filt, scale,
            *flip) in enumerate(KERNEL_CASES):
        in_size = rows if axis == "rows" else cols
        t = sample.texcoords(out, scale)
        if flip:
            t = t[::-1].copy()
        mask = sample.coverage_mask(out, scale)
        make = resample.make_taps if axis == "rows" else resample.make_col_taps
        taps = make(sample.plan_taps(t, in_size, filt, mask), in_size, "cuda")
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
        name = "K1" if axis == "rows" else "K1b"
        extra = ""
        if axis == "cols":
            staged, direct = resample.col_paths(taps)
            extra = (f" | banded (shared-memory ring) {staged} tiles, direct "
                     f"{direct} (pitch {taps.pitch} floats)")
        if i < 2:  # the 4K chroma shapes of chain (b): roofline + yardstick
            lib_fn, lib_out = interpolate_yardstick(x, axis, out)
            lib_ms = cuda_ms(lib_fn)
            lib_us = profiled_us(lib_fn)
            extra += roofline(summary, name, lambda: kern(x, taps),
                              moved_bytes(x, got, *taps[:4]), got.numel(),
                              library_ms=lib_ms)
            summary[name]["library_device_us"] = lib_us
            extra += (f" | F.interpolate bilinear {lib_ms * 1e3:.1f} us, "
                      f"device {lib_us:.1f} us (max |diff| from the kernel "
                      f"{float((lib_out - got).abs().max()):.2e})")
        print(f"[3 K1/K1b] {label} {tuple(x.shape)}->{tuple(got.shape)}: "
              f"torch.equal OK | kernel {ms * 1e3:.1f} us, plain "
              f"{plain_ms * 1e3:.1f} us{extra}", flush=True)
        record(summary, name, err, ms, plain_ms)


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
    ("4K RGBA u8, b/c/s (chain (b)'s vfvideofilter)", "rgba_u8", 2160, 3840,
     False, "b/c/s", 0, False),
    # the paths of the kernel: vector where every plane starts on its
    # 4-pixel access, scalar where one does not
    ("1918x1080 YUV u8 luma, b/c/s", "yuv_u8", 1080, 1918, False, "b/c/s", 0,
     False),
    ("637x479 RGBA u8, b/c/s (odd H*W: the stacked planes are misaligned)",
     "rgba_u8", 479, 637, False, "b/c/s", 0, False),
    ("1917x1079 YUV u8 luma, u and v planes of one stacked (2, H, W) f32",
     "yuv_u8_stacked", 1079, 1917, False, None, 0, False),
    ("4K YUV u8 luma -> f32", "yuv_u8", 2160, 3840, False, None, 0, True),
    ("4K YUV u8 luma, letterbox border, b/c/s", "yuv_u8", 2160, 3840, True,
     "b/c/s", 0, False),
    ("1922x1082 RGBA f32, b/c/s -> f32 (H*W % 16 == 4)", "rgba_f32", 1082,
     1922, False, "b/c/s", 0, True),
    ("1922x1082 RGBA u8, b/c/s (H*W % 16 == 4)", "rgba_u8", 1082, 1922,
     False, "b/c/s", 0, False),
    ("1922x1082 YUV u8 luma, b/c/s + chroma key -> f32", "yuv_u8", 1082,
     1922, False, "b/c/s + chroma key", 0, True),
]
# the two emits of chain (b), timed on the device beside their bound; the
# first is the JSON line's
EMIT_ROOFLINE = ("4K YUV u8 luma, b/c/s (chain (b))",
                 "4K RGBA u8, b/c/s (chain (b)'s vfvideofilter)")


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
    if kind == "yuv_u8_stacked":  # as convert.plan_rgba_sampler hands them
        uv = f32(2, h, w)
        return {"y": u8(h, w), "u": uv[0], "v": uv[1]}
    if kind == "rgba_u8":
        return {"rgba": u8(4, h, w)}
    return {"rgba": f32(4, h, w)}


def emit_args(kind, h, w, border, gates_name, frame, out_float, gen):
    """emit.emit's arguments for one EMIT_CASES row, on the card."""
    import numpy as np
    import torch

    from tpuvf_torch.kernels import convert, emit, filter as kfilter

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
    return src, 0, bplan, adjust, out_float


def emit_vector_path(src, out) -> bool:
    """Whether K2's launch takes its vector path for these planes: the
    rule the kernel's launcher applies (csrc/emit.cu `vector_path`)."""
    import torch

    from tpuvf_torch.kernels import _build

    x = src.get("rgba", src.get("y"))
    u, v = src.get("u"), src.get("v")
    return bool(_build.load().emit_vector_path(
        x.data_ptr(), int(x.dtype == torch.float32),
        None if u is None else u.data_ptr(),
        None if v is None else v.data_ptr(), out.data_ptr(),
        int(out.dtype == torch.float32), out.shape[-2], out.shape[-1]))


def phase_emit(summary):
    """K2 against emit_plain; the JSON times are chain (b)'s 4K emit."""
    import torch

    from tpuvf_torch.kernels import emit

    gen = torch.Generator(device="cuda").manual_seed(2024)
    for label, kind, h, w, border, gates_name, frame, out_float in EMIT_CASES:
        args = emit_args(kind, h, w, border, gates_name, frame, out_float, gen)
        src = args[0]
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
        extra = ""
        if label in EMIT_ROOFLINE:
            extra = roofline(summary, "K2", lambda: emit.emit(*args),
                             moved_bytes(*src.values(), got), h * w,
                             case=None if label == EMIT_ROOFLINE[0] else label)
        if "rgba" in src and label in EMIT_ROOFLINE:
            # what a copy reaches: the stack read once and written once
            extra += (f" | torch clone of the stack, device "
                      f"{profiled_us(src['rgba'].clone):.1f} us")
        path = "vector" if emit_vector_path(src, got) else "scalar"
        print(f"[3 K2] {label}: {note}, {path} path | kernel {ms * 1e3:.1f} "
              f"us, plain {plain_ms * 1e3:.1f} us{extra}", flush=True)
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


def chain_c_lut_input(tmp):
    """Chain (c)'s own K3 input: the float32 frame its emit hands the LUT
    (random NV12 after b/c/s + chroma key, clamped colours included),
    captured from vfvideofilter's call on the card."""
    from tpuvf_torch.elements import videofilter

    seen, lut3d = [], videofilter.lut3d

    def capture(chans, *args, **kwargs):
        seen.append(chans.clone())
        return lut3d(chans, *args, **kwargs)

    videofilter.lut3d = capture
    try:
        lut33 = write_cube(Path(tmp) / "capture33.cube", grade_cube(33, 3))
        fed_pipeline(f"appsrc format=NV12 width=1920 height=1080 ! {CONFIG3} "
                     f"lut-file={lut33} ! appsink",
                     {"appsrc0": nv12_frames(1, 1920, 1080, seed=3)},
                     "cuda").run()
    finally:
        videofilter.lut3d = lut3d
    return seen[0]


def lut_inputs(gen, tmp):
    """{name: (4, 1080, 1920) float32 planes}: uniform noise (each pixel's
    corner row at random, the headline), chain (c)'s frame, and a smooth
    gradient (neighbours share their cells, as a graded frame does); each
    with exact grid points, 0 and 1 written in per size by phase_lut."""
    import torch

    noise = torch.rand((4, 1080, 1920), generator=gen, device="cuda")
    ys = torch.linspace(0.0, 1.0, 1080, device="cuda")[:, None]
    xs = torch.linspace(0.0, 1.0, 1920, device="cuda")[None, :]
    gradient = torch.stack([xs.expand(1080, 1920), ys.expand(1080, 1920),
                            (0.5 * (xs + ys)).expand(1080, 1920),
                            torch.ones((1080, 1920), device="cuda")])
    return {"noise": noise, "chain (c) frame": chain_c_lut_input(tmp),
            "gradient": gradient.contiguous()}


def phase_lut(summary, tmp):
    """K3 against lut3d_plain at 1080p, each line naming the launcher's
    paths, and each input cropped to 1919x1079 (1 pixel a thread); the
    JSON times are the 1080p 33^3 quantizing case on noise (chain (c))."""
    import torch

    from tpuvf_torch.kernels import filter as kfilter, lut

    gen = torch.Generator(device="cuda").manual_seed(33)
    inputs = lut_inputs(gen, tmp)
    for size in (17, 33, 64):
        cube = grade_cube(size, seed=size)
        table = torch.from_numpy(kfilter.pack_lut_corners(cube)).cuda()
        grid = torch.arange(size, device="cuda") / float(size - 1)
        for kind, full in inputs.items():
            full[:3, 0, :size] = grid  # exact grid points, 0 and 1
            full[:3, 1, 0], full[:3, 1, 1] = 0.0, 1.0
            frames = ((f"1080p {kind}", full, kind == "noise"),
                      (f"{kind} 1919x1079",
                       full[:, :1079, :1919].contiguous(), False))
            for frame, x, with_f32 in frames:
                for quantize in (True, False) if with_f32 else (True,):
                    phase_lut_case(summary, size, cube, table, frame, x,
                                   quantize)


def phase_lut_case(summary, size, cube, table, frame, x, quantize):
    """One K3 case: bitwise against lut3d_plain, its paths held to the
    mirror, timed beside the plain version."""
    import torch

    from tpuvf_torch.kernels import lut

    run = (lambda: lut.lut3d(x, table, size, quantize))
    got = run()
    want = lut.lut3d_plain(x, table, size, quantize)
    torch.cuda.synchronize()
    err = float((got.float() - want.float()).abs().max())
    label = f"{frame} {size}^3 {'u8' if quantize else 'f32'}"
    if not torch.equal(got, want):
        fail(f"K3 {label}: kernel != plain (max |diff| {err})")
    how = lut.lut3d_path(x, got, size)
    if not how.startswith(lut.PATH_NAMES[lut.table_path(size)]):
        fail(f"K3 {label}: the launcher took {how!r}, not lut.table_path's")
    ms = cuda_ms(run)
    plain_ms = cuda_ms(lambda: lut.lut3d_plain(x, table, size, quantize))
    headline = size == 33 and quantize and frame == "1080p noise"
    nbytes = moved_bytes(x, got) + lut_rows_bytes(x, size)
    extra = ""
    if headline:  # chain (c)'s shape: roofline + yardstick
        lib_fn, lib_out = grid_sample_yardstick(x, cube)
        lib_ms = cuda_ms(lib_fn)
        lib_us = profiled_us(lib_fn)
        extra = roofline(summary, "K3", run, nbytes, x[0].numel(),
                         library_ms=lib_ms)
        summary["K3"]["library_device_us"] = lib_us
        f32 = lut.lut3d(x, table, size, False)[:3]
        extra += (f" | F.grid_sample {lib_ms * 1e3:.1f} us, device "
                  f"{lib_us:.1f} us (max |diff| from the kernel's f32 "
                  f"{float((lib_out - f32).abs().max()):.2e})")
    elif quantize:
        extra = roofline(summary, "K3", run, nbytes, x[0].numel(),
                         case=label)
    print(f"[3 K3] {label} ({table.numel() * 4 / 1e6:.2f} MB table), "
          f"{how}: torch.equal OK | kernel {ms * 1e3:.1f} us, plain "
          f"{plain_ms * 1e3:.1f} us{extra}", flush=True)
    record(summary, "K3", err, ms if headline else None, plain_ms)


def grid_sample_yardstick(x, cube):
    """The one PyTorch call that computes K3's trilinear lookup: 5-D
    F.grid_sample of the (1, 3, S, S, S) [b][g][r] table, border padding,
    corners aligned; the grid is built here, outside the timed call.
    -> (fn, its (3, H, W) output)."""
    import torch
    import torch.nn.functional as F

    table = torch.from_numpy(cube).cuda().permute(3, 0, 1, 2)[None]
    table = table.contiguous()
    grid = (x[:3].permute(1, 2, 0) * 2.0 - 1.0)[None, None].contiguous()

    def fn():
        return F.grid_sample(table, grid, mode="bilinear",
                             padding_mode="border", align_corners=True)

    return fn, fn()[0, :, 0]


def profiled(fn, reps: int, attempts: int = 5):
    """torch.profiler's key averages over `reps` calls of fn(); a window in
    which the profiler recorded no device time is taken again."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for _ in range(attempts):
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        events = [e for e in prof.key_averages()
                  if e.self_device_time_total > 0]
        if events:
            return events
    fail("torch.profiler saw no device time")


def device_breakdown(fn, reps: int = 20):
    """torch.profiler over `reps` calls of fn() -> (device us per call,
    [(kernel name, us per call)] largest first)."""
    per = sorted(((e.key, e.self_device_time_total / reps)
                  for e in profiled(fn, reps)), key=lambda kv: -kv[1])
    return sum(us for _, us in per), per


def profiled_us(fn, reps: int = 20) -> float:
    """Device time per call of fn() in us: the CUDA kernels' summed self
    time in torch.profiler over `reps` calls."""
    return device_breakdown(fn, reps)[0]


def composite_cases(gen, tmp):
    """(label, height, width, Background, [Draw]) for K4, on the card; the
    draws placed in the canvas's rows (`pack_draws` moves a band's by its
    row0 into the table's frame rows)."""
    import numpy as np
    import torch

    from tpuvf_torch.io import png
    from tpuvf_torch.kernels.composite import (OP_ADD, OP_OVER, OP_SOURCE,
                                               Background, Draw,
                                               background_colors)

    from tpuvf_torch.kernels.overlay import overlay_rect

    def draw(h, w, pw, ph, x, y, op, alpha, f32):
        if f32:  # an emit's float32 RGBA: colour in [0, 1], alpha 1
            src = torch.rand((4, ph, pw), generator=gen, device="cuda")
            src[3] = 1.0
        else:
            src = torch.randint(0, 256, (4, ph, pw), generator=gen,
                                device="cuda", dtype=torch.uint8)
        rect = (min(max(x, 0), w), min(max(y, 0), h),
                min(max(x + pw, 0), w), min(max(y + ph, 0), h))
        return Draw(src, x, y, rect, op, float(np.float32(alpha)))

    def config5(dx, dw, width):
        """Config 5's four pads, each moved dx right and dw narrower."""
        return [draw(2160, width, 3840 - dw, 2160, dx, 0, OP_OVER, 1.0,
                     False),
                draw(2160, width, 1920 - dw, 1080, 1920 + dx, 0, OP_OVER, 1.0,
                     True),
                draw(2160, width, 1280 - dw, 720, dx, 1080, OP_OVER, 0.7,
                     False),
                draw(2160, width, 1280 - dw, 720, 1920 + dx, 1080, OP_ADD,
                     1.0, True)]

    # config 5's overlay as the pipeline folds it: the 256x256 red PNG
    # (alpha 128) at (128, 128), a mix draw of its float32 rect planes
    red = png.decode_premultiplied(
        Path(red_png(Path(tmp) / "k4-red.png")).read_bytes())
    (x0, x1, y0, y1), planes = overlay_rect(red, 3840, 2160, 128.0, 128.0,
                                            256.0, 256.0)
    mix = Draw(torch.from_numpy(planes).cuda(), x0, y0, (x0, y0, x1, y1),
               OP_OVER, 1.0, keep_alpha=True)
    black = Background(background_colors(((0, 0, 0, 1),) * 2))
    checker = Background(background_colors(((0.5, 0.5, 0.5, 1),
                                            (0.75, 0.75, 0.75, 1))))
    base = config5(0, 0, 3840)
    return [
        ("config 5 shape: 4K canvas, 4K u8 + 1080p f32 OVER, 720p u8 OVER "
         "0.7, 720p f32 ADD", 2160, 3840, black, base),
        ("config 5 shape + the folded 256x256 overlay (mix draw, chain (e))",
         2160, 3840, black, base + [mix]),
        ("config 5 shape off the 4-pixel grid: 3838-wide canvas, pads at "
         "x + 1, 3 px narrower", 2160, 3838, black, config5(1, 3, 3838)),
        ("1080p checker, negative positions, SOURCE, odd sizes at odd x",
         1080, 1920, checker,
         [draw(1080, 1920, 1280, 720, -100, -51, OP_SOURCE, 0.6, True),
          draw(1080, 1920, 1917, 1077, 5, 3, OP_OVER, 0.45, False),
          draw(1080, 1920, 37, 23, 1901, 1071, OP_SOURCE, 1.0, False),
          draw(1080, 1920, 641, 359, -333, 777, OP_ADD, 0.8, True)]),
        ("1080p checker, 11 draws (two launches)", 1080, 1920, checker,
         [draw(1080, 1920, 400 + 97 * i, 240 + 61 * i, 150 * i - 201,
               80 * i - 33, i % 3, 0.15 + 0.08 * i, bool(i % 2))
          for i in range(11)]),
        ("an sp band's canvas: 540 rows of a checker frame from row 1084 "
         "(row0, off the 8-row cell), two draws", 540, 1920,
         checker._replace(row0=1084),
         [draw(540, 1920, 1280, 720, -100, -300, OP_OVER, 0.7, True),
          draw(540, 1920, 700, 400, 611, 203, OP_SOURCE, 1.0, False)]),
    ]


def draw_paths(draws) -> str:
    """Each draw's source path as K4's launcher picks it (its exported
    rule), which must equal composite.draw_vector_path's."""
    import torch

    from tpuvf_torch.kernels import _build, composite

    paths = []
    for d in draws:
        vector = bool(_build.load().composite_draw_vector_path(
            d.src.data_ptr(), int(d.src.dtype == torch.float32),
            d.src.shape[2], d.x))
        if vector != composite.draw_vector_path(d):
            fail(f"K4: the launcher's path for a draw at x {d.x}, width "
                 f"{d.src.shape[2]} is not draw_vector_path's")
        paths.append("vector" if vector else "scalar")
    return "/".join(paths)


# K4's config-5 device time before its draw table (PERF.md section 6, on
# the kernels of commit b4df81c, NVIDIA H100 80GB HBM3, 700.00 W), printed
# beside the table route's (a reading: a card's time moves with its power
# limit)
K4_BEFORE_TABLE_US = 66.6


def phase_composite(summary, tmp):
    """K4 against composite_fold_plain, both reading the same draw table
    (`pack_draws`, on the card); the JSON times are the config-5 shape's
    (chain (e)'s pads)."""
    import torch

    from tpuvf_torch.kernels import composite

    gen = torch.Generator(device="cuda").manual_seed(5)
    for i, (label, h, w, bg, draws) in enumerate(composite_cases(gen, tmp)):
        sources, table = composite.pack_draws(h, w, draws, True, bg.row0)
        args = (h, w, bg, sources, table.cuda(), "cuda")
        got = composite.composite_fold(*args)
        want = composite.composite_fold_plain(*args)
        torch.cuda.synchronize()
        err = float((got.float() - want.float()).abs().max())
        if not torch.equal(got, want):
            fail(f"K4 {label}: kernel != composite_fold_plain (max |diff| "
                 f"{err})")
        ms = cuda_ms(lambda: composite.composite_fold(*args))
        plain_ms = cuda_ms(lambda: composite.composite_fold_plain(*args))
        device = ""
        if i < 3:  # the config-5 shapes: device time beside the bound
            device = roofline(summary, "K4",
                              lambda: composite.composite_fold(*args),
                              moved_bytes(*(d.src for d in draws), got),
                              h * w * len(draws),
                              case=None if i == 0 else label)
        if i == 0:
            dev_us = summary["K4"]["device_us"]
            plain_dev_us = profiled_us(
                lambda: composite.composite_fold_plain(*args))
            slower = dev_us - K4_BEFORE_TABLE_US
            device += (f" | plain device {plain_dev_us:.1f} us | table "
                       f"route: {dev_us:.1f} us against "
                       f"{K4_BEFORE_TABLE_US} us before the table (b4df81c; "
                       f"{'at most' if slower <= 3.0 else 'MORE than'} 3 "
                       f"us slower)")
        canvas = "vector" if w % 4 == 0 else "scalar"
        print(f"[3 K4] {label}: torch.equal OK (table route) | canvas "
              f"{canvas}, draws {draw_paths(draws)} | kernel "
              f"{ms * 1e3:.1f} us, plain {plain_ms * 1e3:.1f} us{device}",
              flush=True)
        record(summary, "K4", err, ms if i == 0 else None, plain_ms)


def u8_planes(gen, fmt, w, h):
    """Random uint8 planes of a w x h frame on the card: {"rgba"} or 4:2:0
    {"y", "u", "v"}."""
    import torch

    def u8(*shape):
        return torch.randint(0, 256, shape, generator=gen, device="cuda",
                             dtype=torch.uint8)

    if fmt == "RGBA":
        return {"rgba": u8(4, h, w)}
    cw, ch = (w + 1) // 2, (h + 1) // 2
    return {"y": u8(h, w), "u": u8(ch, cw), "v": u8(ch, cw)}


def crop_planes(planes, w, h):
    """The top-left w x h crop of a frame's planes, contiguous."""
    if "rgba" in planes:
        return {"rgba": planes["rgba"][:, :h, :w].contiguous()}
    cw, ch = (w + 1) // 2, (h + 1) // 2
    return {"y": planes["y"][:h, :w].contiguous(),
            "u": planes["u"][:ch, :cw].contiguous(),
            "v": planes["v"][:ch, :cw].contiguous()}


def planes_equal(got, want) -> float:
    """-> max |diff| over the planes' dicts (or tensors); fails on a key or
    shape mismatch."""
    if not isinstance(got, dict):
        got, want = {"": got}, {"": want}
    if set(got) != set(want):
        fail(f"planes {sorted(got)} vs {sorted(want)}")
    err = 0.0
    for k in want:
        if got[k].shape != want[k].shape or got[k].dtype != want[k].dtype:
            fail(f"plane {k}: {got[k].dtype}{tuple(got[k].shape)} vs "
                 f"{want[k].dtype}{tuple(want[k].shape)}")
        err = max(err, float((got[k].float() - want[k].float()).abs().max()))
    return err


def launched_path(fn, label):
    """(columns a thread, vector path) of the one kernel `label` that fn()
    launches, read off its template arguments as torch.profiler names it
    (deinterlace_pair_kernel<kCols, kVec, ...>, overlay_yuv420_kernel<kCols,
    kVec>, overlay_blend_kernel<kVec>: 16 or 1 columns)."""
    import re

    # a window of 20 calls: windows of one call, and once of 3, have come
    # back empty three times in a row on the card (the profiler's flake,
    # not the kernel's)
    names = {e.key for e in profiled(fn, 20) if KERNEL_NAMES[label] in e.key}
    if len(names) != 1:
        fail(f"{label}: expected one kernel, torch.profiler saw {names}")
    name = names.pop()
    m = re.search(r"<(\d+), (true|false)", name)
    if m:
        return int(m.group(1)), m.group(2) == "true"
    vec = re.search(r"<(true|false)>", name).group(1) == "true"
    return (16 if vec else 1), vec


def path_text(fn, label, mirror) -> str:
    """The launch's path, held to the wrapper module's mirror of the
    launcher's rule (`route`: columns a thread, vector path)."""
    cols, vec = launched_path(fn, label)
    if (cols, vec) != tuple(mirror):
        fail(f"{label}: the launcher took {cols} columns a thread "
             f"(vector path {vec}), the mirror says {mirror}")
    return f"{'vector' if vec else 'scalar'} path, {cols} columns a thread"


def replaced_text(fn) -> tuple:
    """Device time of the launches a fused route replaced (the parent's
    route at this shape) -> (us, text with its largest kernels)."""
    us, per = device_breakdown(fn)
    top = ", ".join(f"{name[:32]} {t:.1f}" for name, t in per[:4])
    return us, (f" | the launches it replaces (parent's route, this run): "
                f"{us:.1f} us device, {len(per)} kernels ({top})")


def tie_threshold():
    """A float32 threshold that a motion of one channel's 200 - 100 step
    equals exactly: sqrt(d * d) == |d| in IEEE round to nearest."""
    import numpy as np

    inv = np.float32(1.0 / 255.0)
    return float(np.float32(200) * inv - np.float32(100) * inv)


def deinterlace_cases(gen):
    """[(label, planes, taps, prev, method, tff, has_prev, threshold,
    matrix_in, out format, matrix_out)] for K5, the JSON case first."""
    import torch

    from tpuvf_torch.core.formats import VideoFormat as F
    from tpuvf_torch.core.spec import FrameSpec
    from tpuvf_torch.kernels import convert, deinterlace as kd, emit
    from tpuvf_torch.kernels.sample import NEAREST

    w, h = 1920, 1080
    names = {kd.METHOD_BOB: "bob", kd.METHOD_WEAVE: "weave",
             kd.METHOD_GREEDYH: "greedy-H"}
    thr = torch.tensor(0.3, device="cuda")

    def inputs(fmt, w, h, planes=None):
        """(planes, taps, prev): prev is the planes' own texture on the
        left half (still: weave) and noise on the right (motion: bob)."""
        planes = planes or u8_planes(gen, fmt, w, h)
        taps = None
        if fmt == "RGBA":
            tex = planes["rgba"]
        else:
            taps = convert.plan_chroma_taps(FrameSpec(F.I420, w, h), "cuda",
                                            NEAREST)
            tex = emit.emit_plain(convert.sample_yuv420_plain(planes, taps),
                                  0)
        prev = tex.clone()
        prev[:, :, w // 2:] = u8_planes(gen, "RGBA", w - w // 2, h)["rgba"]
        return planes, taps, prev

    yuv, rgb = inputs("I420", w, h), inputs("RGBA", w, h)
    cases = [("(g) I420 1080p greedy-H tff, has prev -> I420", *yuv,
              kd.METHOD_GREEDYH, True, True, thr, 0, F.I420, 0)]
    for kind, (planes, taps, prev), out in (("I420", yuv, F.I420),
                                            ("RGBA", rgb, F.RGBA)):
        for m in names:
            for tff in (True, False):
                for has_prev in (True, False):
                    cases.append((f"{kind} 1080p {names[m]} tff={tff} "
                                  f"has_prev={has_prev} -> {out.value}",
                                  planes, taps, prev, m, tff, has_prev, thr,
                                  0, out, 0))
    cases += [
        ("I420 1080p greedy-H -> RGBA", *yuv, kd.METHOD_GREEDYH, True, True,
         thr, 0, F.RGBA, 0),
        ("I420 1080p bob bff -> RGBA", *yuv, kd.METHOD_BOB, False, False,
         thr, 0, F.RGBA, 0),
        ("I420 1080p weave, BT.601 in -> BT.709 out", *yuv, kd.METHOD_WEAVE,
         False, True, thr, 0, F.I420, 1),
        ("RGBA 1080p greedy-H -> I420", *rgb, kd.METHOD_GREEDYH, True, True,
         thr, 0, F.I420, 0),
    ]
    crop_yuv = inputs("I420", 1919, 1079, crop_planes(yuv[0], 1919, 1079))
    crop_rgb = inputs("RGBA", 1919, 1079, crop_planes(rgb[0], 1919, 1079))
    cases += [
        ("I420 1919x1079 greedy-H bff -> I420", *crop_yuv, kd.METHOD_GREEDYH,
         False, True, thr, 0, F.I420, 0),
        ("I420 1919x1079 bob -> RGBA", *crop_yuv, kd.METHOD_BOB, True, False,
         thr, 0, F.RGBA, 0),
        ("RGBA 1919x1079 greedy-H tff -> RGBA", *crop_rgb, kd.METHOD_GREEDYH,
         True, True, thr, 0, F.RGBA, 0),
        ("RGBA 1919x1079 weave bff -> I420", *crop_rgb, kd.METHOD_WEAVE,
         False, True, thr, 0, F.I420, 1),
    ]
    # the knife edge: half the discarded pixels of a band move by exactly
    # the threshold (R 200 vs 100), the other half by one step less
    tie_cur, tie_prev = rgb[0]["rgba"].clone(), rgb[0]["rgba"].clone()
    tie_cur[0, :, :480], tie_prev[0, :, :480] = 200, 100
    tie_cur[0, :, :240] = 199
    cases.append(("RGBA 1080p greedy-H threshold tie", {"rgba": tie_cur},
                  None, tie_prev, kd.METHOD_GREEDYH, True, True,
                  torch.tensor(tie_threshold(), device="cuda"), 0, F.RGBA,
                  0))
    return cases


def phase_deinterlace(summary):
    """K5 (deinterlace_frame) against deinterlace_frame_plain on every route:
    4:2:0 in -> 4:2:0 or RGBA out, RGB in -> RGBA or 4:2:0 out, each at
    1080p (vector path) and on a 1919x1079 crop (scalar path), the tie band;
    the JSON times are chain (g)'s I420 greedy-H, and chain (g')'s BGRA
    weave is timed beside its bound too."""
    import torch

    from tpuvf_torch.core.formats import VideoFormat as F
    from tpuvf_torch.core.spec import FrameSpec
    from tpuvf_torch.kernels import convert, deinterlace as kd, emit
    from tpuvf_torch.kernels.sample import NEAREST

    gen = torch.Generator(device="cuda").manual_seed(4)
    for i, (label, planes, taps, prev, method, tff, has_prev, t, mi, fmt,
            mo) in enumerate(deinterlace_cases(gen)):
        args = (planes, prev, method, tff, has_prev, t, taps, mi, fmt, mo)
        got, got_tex = kd.deinterlace_frame(*args)
        want, want_tex = kd.deinterlace_frame_plain(*args)
        torch.cuda.synchronize()
        err = planes_equal(got, want)
        if (got_tex is None) != (want_tex is None):
            fail(f"K5 {label}: a texture on one side only")
        if got_tex is not None:
            err = max(err, planes_equal(got_tex, want_tex))
        if err or not all(torch.equal(got[k], want[k]) for k in want) or (
                got_tex is not None and not torch.equal(got_tex, want_tex)):
            fail(f"K5 {label}: kernel != deinterlace_frame_plain (max |diff| "
                 f"{err})")
        if "tie" in label:
            o, p = got["rgba"], prev
            prev_taken = (o[:, 1::2, :480] == p[:, 1::2, :480]).all(0)
            if not (prev_taken[:, :240].all() and
                    not prev_taken[:, 240:].any()):
                fail("K5 threshold tie: motion == threshold did not take bob")

        def run(args=args):
            return kd.deinterlace_frame(*args)

        note = " | " + path_text(run, "K5", kd.route(planes, prev))
        ms = plain_ms = None
        g_prime = label == "RGBA 1080p weave tff=True has_prev=True -> RGBA"
        if i == 0 or g_prime or "1919" in label:
            ms = cuda_ms(run)
            plain_ms = cuda_ms(lambda: kd.deinterlace_frame_plain(*args))
            note += (f" | kernel {ms * 1e3:.1f} us, plain "
                     f"{plain_ms * 1e3:.1f} us")
        # the bytes: the input planes, prev on the rebuilt rows, the
        # texture written for the next frame (4:2:0 in), the output
        nbytes = (moved_bytes(*planes.values(), *got.values())
                  + (moved_bytes(prev) // 2 if has_prev else 0)
                  + (moved_bytes(got_tex) if "y" in planes and got_tex
                     is not None else 0))
        h, w = prev.shape[1:]
        if i == 0:  # chain (g): roofline, and the launches it replaces
            note += roofline(summary, "K5", run, nbytes, h * w)
            sampler = convert.plan_rgba_sampler(FrameSpec(F.I420, w, h),
                                                w, h, "cuda", filter=NEAREST)

            def parent(args=args):  # K1, K1b, K2, the field kernel, the pack
                cur = emit.emit(sampler(planes), mi)
                return convert.pack_rgba(
                    kd.deinterlace(cur, prev, method, tff, has_prev, t),
                    fmt, mo)

            summary["K5"]["replaced_us"], text = replaced_text(parent)
            note += text
        elif g_prime:  # chain (g'): the RGB route beside its bound
            note += roofline(summary, "K5", run, nbytes, h * w, ops=30,
                             case="(g') BGRA 1080p weave")
        print(f"[3 K5] {label}: torch.equal OK (planes"
              f"{' and texture' if got_tex is not None else ''}){note}",
              flush=True)
        record(summary, "K5", err, ms if i == 0 else None, plain_ms)


def red_png(path, size=256, alpha=128):
    """BASELINE config 5's overlay image: a size x size red PNG."""
    import numpy as np

    img = np.zeros((size, size, 4), np.uint8)
    img[..., 0], img[..., 3] = 255, alpha
    return write_png(path, img)


def write_png(path, rgba):
    """A minimal 8-bit RGBA PNG (one IDAT, filter 0 rows)."""
    import struct
    import zlib

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


def overlay_cases(gen, tmp):
    """[(label, planes, taps, image, placement, alpha, matrix_in,
    matrix_out)] for K6, the JSON case first."""
    import numpy as np

    from tpuvf_torch.core.formats import VideoFormat as F
    from tpuvf_torch.core.spec import FrameSpec
    from tpuvf_torch.io import png
    from tpuvf_torch.kernels import convert

    red = png.decode_premultiplied(
        Path(red_png(Path(tmp) / "red.png")).read_bytes())
    rng = np.random.default_rng(6)
    art = rng.integers(0, 256, (120, 200, 4), dtype=np.uint8)
    art = png.decode_premultiplied(
        Path(write_png(Path(tmp) / "art.png", art)).read_bytes())

    def yuv(planes, w, h):
        return planes, convert.plan_chroma_taps(FrameSpec(F.NV12, w, h),
                                                "cuda")

    nv12_4k = yuv(u8_planes(gen, "I420", 3840, 2160), 3840, 2160)
    i420 = yuv(u8_planes(gen, "I420", 1920, 1080), 1920, 1080)
    crop = yuv(crop_planes(i420[0], 1919, 1079), 1919, 1079)
    rgba_4k = u8_planes(gen, "RGBA", 3840, 2160)
    stretched = (0.8 * 1920, 300.0, 640.0, 360.0)
    return [
        ("(e') 4K NV12, 256x256 red alpha 128 at (128, 128) -> NV12",
         *nv12_4k, red, (128.0, 128.0, 256.0, 256.0), 1.0, 1, 1),
        ("1080p I420, 200x120 stretched to 640x360 at relative-x 0.8 (partly "
         "off-frame), alpha 0.75", *i420, art, stretched, 0.75, 1, 1),
        ("1080p I420, empty rect (off-frame)", *i420, art,
         (5000.0, 300.0, 640.0, 360.0), 1.0, 1, 1),
        ("1080p I420, alpha 0", *i420, art, stretched, 0.0, 1, 1),
        ("1080p I420, BT.601 in -> BT.709 out", *i420, art, stretched, 0.75,
         0, 1),
        ("1919x1079 I420 crop, partly off-frame rect", *crop, art,
         (0.8 * 1919, 300.0, 640.0, 360.0), 0.75, 1, 1),
        ("4K RGBA u8, 256x256 red alpha 128 at (128, 128)", rgba_4k, None,
         red, (128.0, 128.0, 256.0, 256.0), 1.0, 0, 0),
        ("1919x1079 RGBA crop, partly off-frame rect",
         crop_planes(rgba_4k, 1919, 1079), None, art,
         (0.8 * 1919, 300.0, 640.0, 360.0), 0.75, 0, 0),
        ("4K RGBA u8, empty rect", rgba_4k, None, art,
         (5000.0, 300.0, 640.0, 360.0), 1.0, 0, 0),
    ]


def phase_overlay(summary, tmp):
    """K6 (overlay_frame) against overlay_frame_plain on both routes, 4:2:0
    (vector and scalar path) and RGB (vector and scalar); the JSON times are
    chain (e')'s 4K NV12 overlay."""
    import torch

    from tpuvf_torch.core.formats import VideoFormat as F
    from tpuvf_torch.core.spec import FrameSpec
    from tpuvf_torch.kernels import convert, emit, overlay as ko

    gen = torch.Generator(device="cuda").manual_seed(6)
    for i, (label, planes, taps, image, place, alpha, mi,
            mo) in enumerate(overlay_cases(gen, tmp)):
        x = planes.get("rgba", planes.get("y"))
        h, w = x.shape[-2:]
        rect, ov_np = ko.overlay_rect(image, w, h, *place)
        ov = torch.from_numpy(ov_np).cuda()
        args = (planes, taps, rect, ov,
                torch.tensor(alpha, dtype=torch.float32, device="cuda"), mi,
                mo)
        got = ko.overlay_frame(*args)
        want = ko.overlay_frame_plain(*args)
        torch.cuda.synchronize()
        err = planes_equal(got, want)
        if err or not all(torch.equal(got[k], want[k]) for k in want):
            fail(f"K6 {label}: kernel != overlay_frame_plain (max |diff| "
                 f"{err})")

        def run(args=args):
            return ko.overlay_frame(*args)

        note = " | " + path_text(run, "K6", ko.route(planes))
        ms = plain_ms = None
        if i == 0 or "1919" in label or "4K RGBA u8, 256" in label:
            ms = cuda_ms(run)
            plain_ms = cuda_ms(lambda: ko.overlay_frame_plain(*args))
            note += (f" | kernel {ms * 1e3:.1f} us, plain "
                     f"{plain_ms * 1e3:.1f} us")
        nbytes = moved_bytes(*planes.values(), ov, *got.values())
        if i == 0:  # chain (e'): roofline, and the launches it replaces
            note += roofline(summary, "K6", run, nbytes, h * w)
            sampler = convert.plan_rgba_sampler(FrameSpec(F.NV12, w, h), w,
                                                h, "cuda")

            def parent(args=args):  # K1, K1b, K2 -> f32, the blend, the pack
                src = emit.emit(sampler(planes), mi, out_float=True)
                return convert.pack_rgba(
                    ko.overlay_blend_plain(src, rect, ov, args[4]), F.NV12,
                    mo)

            summary["K6"]["replaced_us"], text = replaced_text(parent)
            note += text + (" (its blend is the plain torch one: the float32"
                            " K6 route is gone)")
        elif "4K RGBA u8, 256" in label:  # the RGB route beside its bound
            note += roofline(summary, "K6", run, nbytes, h * w, ops=20,
                             case="4K RGBA u8 canvas")
        print(f"[3 K6] {label}, rect {rect}: torch.equal OK{note}",
              flush=True)
        record(summary, "K6", err, ms if i == 0 else None, plain_ms)


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


def i420_moving_block(n, w, h, seed, block=96):
    """n I420 frames, each the one before with a block moved on: still
    areas weave from the previous frame, the block's trail bobs."""
    import numpy as np

    rng = np.random.default_rng(seed)
    frame = {"y": rng.integers(0, 256, (h, w), dtype=np.uint8),
             "u": rng.integers(0, 256, (h // 2, w // 2), dtype=np.uint8),
             "v": rng.integers(0, 256, (h // 2, w // 2), dtype=np.uint8)}
    frames = []
    for k in range(n):
        frame = {p: a.copy() for p, a in frame.items()}
        x, y = 200 + 64 * k, 300 + 16 * k
        frame["y"][y:y + block, x:x + block] = 235 - 20 * k
        frame["u"][y // 2:(y + block) // 2, x // 2:(x + block) // 2] = 90
        frames.append(frame)
    return frames


def fed_pipeline(desc, feeds, device, tffs=None):
    """The pipeline on `device` with {appsrc name: frames} pushed, each
    with its TFF flag from {appsrc name: [bool]} where given."""
    from tpuvf_torch.cli.launch import parse_pipeline

    pipe = parse_pipeline(desc, device=device)
    for name, frames in feeds.items():
        flags = (tffs or {}).get(name) or [None] * len(frames)
        for f, tff in zip(frames, flags):
            pipe[name].push(f, tff=tff)
        pipe[name].end_of_stream()
    pipe.negotiate()
    pipe.build()
    return pipe


def _planes(frame):
    return frame if isinstance(frame, dict) else {"frame": frame}


def counted_run(label, pipe, frames, expect, drive=None):
    """Pipeline.run (or `drive()`, which returns the frames it ran) with
    every launch counter set to 0 just before it and read just after: every
    kernel of `expect` must launch, none of it written "!K6" may, and one
    written "K6=8" must launch exactly that often; -> {kernel: launches}."""
    import torch

    wrappers = counters()
    for w in wrappers.values():
        w.launches = 0
    n = (drive or pipe.run)()
    torch.cuda.synchronize()
    launches = {k: w.launches for k, w in wrappers.items()}
    if n != frames:
        fail(f"{label}: ran {n} of {frames} frames")
    exact = dict(k.split("=") for k in expect if "=" in k)
    wrong = {k: launches[k] for k, n in exact.items() if launches[k] != int(n)}
    if wrong:
        fail(f"{label}: launch counters {launches}; expected exactly "
             f"{exact}")
    missing = [k for k in expect
               if k[0] != "!" and "=" not in k and launches[k] == 0]
    if missing:
        fail(f"{label}: launch counters {launches}; the path did not reach "
             f"{', '.join(missing)}")
    barred = [k[1:] for k in expect if k[0] == "!" and launches[k[1:]]]
    if barred:
        fail(f"{label}: launch counters {launches}; the path must not reach "
             f"{', '.join(barred)}")
    return launches


def phase_chain(label, desc, feeds, expect, opaque=False, tffs=None):
    """Drive one main path on the card, fed {appsrc name: frames}, its
    kernels held to `expect` (`counted_run`); -> {kernel: launches}."""
    import numpy as np

    frames = max(feeds.values(), key=len)
    pipe = fed_pipeline(desc, feeds, "cuda", tffs)
    launches = counted_run(label, pipe, len(frames), expect)
    outs = [_planes(f) for f in pipe["appsink0"].frames]
    for i, f in enumerate(outs):
        for k, v in f.items():
            if v.dtype != np.uint8 or v.size == 0:
                fail(f"{label}: frame {i} plane {k} is {v.dtype}{v.shape}")
        if opaque and not (f["frame"][..., 3] == 255).all():
            fail(f"{label}: frame {i} alpha is not opaque")
    if all(np.array_equal(outs[0][k], outs[1][k]) for k in outs[0]):
        fail(f"{label}: distinct input frames gave equal outputs")
    cpu = fed_pipeline(desc, {k: v[:1] for k, v in feeds.items()}, "cpu",
                       tffs)
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

    inputs = pipe.upload_sources({k: v[0] for k, v in feeds.items()})
    state = pipe.state

    def step():  # as run() steps: params re-read, staged if one changed
        return pipe.step_sources(inputs, state, pipe.params())

    step_ms = cuda_ms(step)
    step_us = host_us(step)
    busy_us, per = device_breakdown(step)
    top = ", ".join(f"{name[:40]} {us:.1f}" for name, us in per[:4])
    n = len(frames)
    counts = ", ".join(f"{k} {v} ({v / n:g}/frame)"
                       for k, v in launches.items() if v)
    fps, edge = run_fps(pipe)
    print(f"[4 main path] {label}: {n} frames on cuda | launches {counts} | "
          f"frame 0 vs CPU max {worst} LSB, {differ / total:.4%} differ | "
          f"device step {step_ms * 1e3:.1f} us/frame (events), "
          f"{step_us:.1f} us (host clock), busy {busy_us:.1f} us, idle "
          f"{max(0.0, 1.0 - busy_us / step_us):.3f} (largest, us: {top}) | "
          f"Pipeline.run wall {fps:.2f} fps (upload + readback)",
          flush=True)
    print(f"[4 edge] {label[:4].strip()}: {edge_text(edge)}", flush=True)
    return launches


def run_fps(pipe, drive=None):
    """Pipeline.run's (or `drive()`'s) frames per second, upload and
    readback included, on a pipeline that has run once (planned and
    allocated), and its host edge, ms a frame per part
    (`PipelineStats.edge_seconds`)."""
    pipe.frames, pipe.wall_seconds = 0, 0.0
    edge = pipe.stats.edge_seconds
    edge.update(dict.fromkeys(edge, 0.0))
    (drive or pipe.run)()
    return (pipe.frames / pipe.wall_seconds,
            {k: v / pipe.frames * 1e3 for k, v in edge.items()})


def edge_text(edge) -> str:
    return ("host edge ms/frame: "
            + ", ".join(f"{k} {v:.2f}" for k, v in edge.items()))


def main_paths(tmp):
    """Chains (a)-(h''): [(label, description, {appsrc: frames}, kernels
    the chain must launch ("!K6": must not; "K6=8": exactly 8 times), opaque
    output, *({appsrc: [tff]},))]."""
    lut33 = write_cube(Path(tmp) / "grade33.cube", grade_cube(33, seed=3))
    lut17 = write_cube(Path(tmp) / "grade17.cube", grade_cube(17, seed=17))
    red = red_png(Path(tmp) / "config5-red.png")
    config5 = {"s0": rgba_frames(FRAMES, 3840, 2160, seed=50),
               "s1": nv12_frames(FRAMES, 1920, 1080, seed=51),
               "s2": rgba_frames(FRAMES, 1280, 720, seed=52),
               "s3": nv12_frames(FRAMES, 1280, 720, seed=53)}
    return [
        ("(a) NV12 1920x1080 -> BGRA 640x480 + b/c/s",
         f"appsrc format=NV12 width=1920 height=1080 ! vfmetalconvertscale ! "
         f"video/x-raw,format=BGRA,width=640,height=480 ! {BCS} ! appsink",
         {"appsrc0": nv12_frames(FRAMES, 1920, 1080, seed=1920)},
         ("K1", "K1b", "K2"), True),
        ("(b) NV12 3840x2160 -> BGRA 3840x2160 + b/c/s",
         f"appsrc format=NV12 width=3840 height=2160 ! vfmetalconvertscale ! "
         f"video/x-raw,format=BGRA,width=3840,height=2160 ! {BCS} ! appsink",
         {"appsrc0": nv12_frames(FRAMES, 3840, 2160, seed=3840)},
         ("K1", "K1b", "K2"), True),
        ("(c) config 3: NV12 1920x1080 b/c/s + chroma key + 33^3 LUT -> NV12",
         f"appsrc format=NV12 width=1920 height=1080 ! {CONFIG3} "
         f"lut-file={lut33} ! appsink",
         {"appsrc0": nv12_frames(FRAMES, 1920, 1080, seed=3)},
         ("K1", "K1b", "K2", "K3"), False),
        ("(c) config 3 -> BGRA",
         f"appsrc format=NV12 width=1920 height=1080 ! {CONFIG3} "
         f"lut-file={lut33} ! vfmetalconvertscale ! video/x-raw,format=BGRA "
         f"! appsink",
         {"appsrc0": nv12_frames(FRAMES, 1920, 1080, seed=4)},
         ("K1", "K1b", "K2", "K3"), False),
        ("(d) RGBA 1920x1080 17^3 LUT + contrast + sharpness -> BGRA",
         f"appsrc format=RGBA width=1920 height=1080 ! vfmetalvideofilter "
         f"lut-file={lut17} contrast=1.1 sharpness=0.5 ! vfmetalconvertscale "
         f"! video/x-raw,format=BGRA ! appsink",
         {"appsrc0": rgba_frames(FRAMES, 1920, 1080, seed=17)}, ("K2", "K3"),
         False),
        ("(e) config 5: BGRA 4K + NV12 1080p + BGRA 720p alpha 0.7 + NV12 "
         "720p ADD -> BGRA 4K, then the 256x256 PNG overlay at (128, 128), "
         "folded into K4", CONFIG5.format(png=red, fmt="BGRA"), config5,
         ("K1", "K1b", "K2", "K4", "!K6"), False),
        ("(e') config 5 -> NV12 4K, then the overlay (not folded: K6)",
         CONFIG5.format(png=red, fmt="NV12"), config5,
         ("K1", "K1b", "K2", "K4", f"K6={FRAMES}"), False),
        ("(f) checker composite -> NV12 1080p: NV12 1080p scaled to 1280x720 "
         "at xpos -100 + BGRA 720p keep-aspect", CHAIN_F,
         {"s0": nv12_frames(FRAMES, 1920, 1080, seed=60),
          "s1": rgba_frames(FRAMES, 1280, 720, seed=61)},
         ("K1", "K1b", "K2", "K4"), False),
        ("(g) config 4: I420 1920x1080 interlaced, greedy-H threshold 0.3, "
         "a moving block -> I420", CONFIG4,
         {"appsrc0": i420_moving_block(FRAMES, 1920, 1080, seed=4)},
         (f"K5={FRAMES}", "!K1", "!K1b", "!K2"), False),
        ("(g') BGRA 1920x1080 weave, field-layout=auto, pushed tff "
         "alternating -> BGRA",
         "appsrc format=BGRA width=1920 height=1080 ! vfmetaldeinterlace "
         "method=weave field-layout=auto ! appsink",
         {"appsrc0": rgba_frames(FRAMES, 1920, 1080, seed=41)},
         (f"K5={FRAMES}", "!K1", "!K1b", "!K2"), False,
         {"appsrc0": [i % 2 == 0 for i in range(FRAMES)]}),
        ("(h) config 2: BGRA 640x480 clockwise, crop-left 32, crop-top 16",
         "appsrc format=BGRA width=640 height=480 ! vfmetaltransform "
         "method=clockwise crop-left=32 crop-top=16 ! appsink",
         {"appsrc0": rgba_frames(FRAMES, 640, 480, seed=2)},
         ("K1", "K1b", "K2"), False),
        ("(h') NV12 1920x1080 counterclockwise, crop-right 64 -> NV12",
         "appsrc format=NV12 width=1920 height=1080 ! vfmetaltransform "
         "method=counterclockwise crop-right=64 ! appsink",
         {"appsrc0": nv12_frames(FRAMES, 1920, 1080, seed=21)},
         ("K1", "K1b", "K2"), False),
        ("(h'') NV12 1920x1080 rotate-180 (the fast path) -> NV12",
         "appsrc format=NV12 width=1920 height=1080 ! vfmetaltransform "
         "method=rotate-180 ! appsink",
         {"appsrc0": nv12_frames(FRAMES, 1920, 1080, seed=22)},
         ("K1", "K1b", "K2"), False),
    ]


def phase_chains(tmp):
    """Chains (a)-(h''); -> {kernel: launches summed over the chains}.
    (e') is (e) to NV12: its overlay stage must add its one K6 a frame and
    no sampler or emit launch of its own to (e)'s."""
    total, by_chain = {}, {}
    for label, desc, frames, expect, opaque, *tffs in main_paths(tmp):
        by_chain[label[:4]] = phase_chain(label, desc, frames, expect,
                                          opaque, *tffs)
        for k, v in by_chain[label[:4]].items():
            total[k] = total.get(k, 0) + v
    e, e2 = by_chain["(e) "], by_chain["(e')"]
    if any(e[k] != e2[k] for k in ("K1", "K1b", "K2")):
        fail(f"(e'): the overlay stage launched samplers or emits of its "
             f"own ((e) {e}, (e') {e2})")
    return total


# Chain (i): a preview branch beside a capture branch, as in live production
CHAIN_I = ("appsrc format=NV12 width=3840 height=2160 ! vfmetalconvertscale ! "
           "video/x-raw,format=BGRA ! tee name=t t. ! queue ! "
           "vfmetalvideosink window-width=1920 window-height=1200 t. ! queue "
           "! appsink")
# Chain (j): the file edge at 1080i, {src} a 1920x1080 It I420 .y4m
CHAIN_J = ("y4msrc location={src} ! vfmetaldeinterlace method=greedyh "
           "motion-threshold=0.3 ! tee name=t t. ! queue ! y4menc ! filesink "
           "location={out}/out.y4m t. ! queue ! vfmetalconvertscale ! "
           "video/x-raw,format=BGRA,width=1280,height=720 ! jpegenc "
           "quality=85 ! multifilesink location={out}/f%05d.jpg")
# Chain (k): packed 4:2:2 at 4K (config_convert422's shape), {src} raw UYVY
CHAIN_K = ("rawvideosrc location={src} format=UYVY width=3840 height=2160 "
           "num-buffers=8 ! vfmetalconvertscale ! video/x-raw,{caps} ! "
           "filesink location={out}")


def within(label, got, want, what) -> int:
    """Max |got - want| over uint8 arrays of one shape; fails above 1."""
    import numpy as np

    if got.shape != want.shape:
        fail(f"{label}: {what} {got.shape} vs the CPU run's {want.shape}")
    worst = int(np.abs(got.astype(np.int32) - want.astype(np.int32)).max())
    if worst > 1:
        fail(f"{label}: {what} differs from the CPU run by {worst} LSB")
    return worst


def print_chain(label, pipe, launches, note):
    pipe.negotiate()  # reopens the chain's files and restarts its encoders
    fps, edge = run_fps(pipe)
    n = pipe.frames
    counts = ", ".join(f"{k} {v} ({v / n:g}/frame)"
                       for k, v in launches.items() if v)
    print(f"[4 main path] {label}: {n} frames on cuda | launches {counts} | "
          f"{note} | Pipeline.run wall {fps:.2f} fps (upload + readback)",
          flush=True)
    print(f"[4 edge] {label[:4].strip()}: {edge_text(edge)}", flush=True)


def collect_windows(pipe):
    """The windows the pipeline's vfvideosink presents, in order."""
    sink, shown = pipe["vfmetalvideosink0"], []
    present = sink.present

    def keep(window, index):
        shown.append(window)
        present(window, index)

    sink.present = keep
    return sink, shown


def chain_i():
    """(i): NV12 4K -> BGRA -> tee -> vfvideosink 1920x1200 + appsink.  The
    window is a 1920x1080 rect between 60-row black bars; windows and
    appsink frames within 1 LSB of the CPU run (on the first 2 frames and
    the last 2, where a readback buffer reused too early would show), the
    bars exact."""
    import numpy as np

    label = "(i) NV12 4K -> BGRA -> tee: vfvideosink 1920x1200 + appsink"
    feeds = {"appsrc0": nv12_frames(FRAMES, 3840, 2160, seed=38)}
    pipe = fed_pipeline(CHAIN_I, feeds, "cuda")
    sink, shown = collect_windows(pipe)
    launches = counted_run(label, pipe, FRAMES, ("K1", "K1b", "K2"))
    if sink._display_rect != (0, 60, 1920, 1080):
        fail(f"{label}: display rect {sink._display_rect}")
    # the chain keeps no state: the CPU run of these frames alone gives
    # their outputs
    held = (0, 1, FRAMES - 2, FRAMES - 1)
    cpu = fed_pipeline(CHAIN_I, {"appsrc0": [feeds["appsrc0"][k]
                                             for k in held]}, "cpu")
    _, cpu_shown = collect_windows(cpu)
    cpu.run()
    kept = pipe["appsink0"].frames
    if len(shown) != FRAMES or len(kept) != FRAMES:
        fail(f"{label}: {len(shown)} windows, {len(kept)} appsink frames")
    bars = np.r_[0:60, 1140:1200]
    worst = 0
    for c, k in enumerate(held):
        worst = max(worst,
                    within(label, shown[k], cpu_shown[c], f"window {k}"),
                    within(label, kept[k], cpu["appsink0"].frames[c],
                           f"appsink frame {k}"))
    for k, w in enumerate(shown):
        if w.shape != (1200, 1920, 4) or not (w[bars] == (0, 0, 0, 255)).all():
            fail(f"{label}: window {k} {w.shape}: the bars are not black")
    if np.array_equal(shown[0], shown[1]):
        fail(f"{label}: distinct frames gave equal windows")
    print_chain(label, pipe, launches,
                f"frames {held} vs CPU max {worst} LSB, bars exact")
    return launches


def write_y4m(path, frames, w, h):
    from tpuvf_torch.io import y4m

    with open(path, "wb") as fh:
        fh.write(y4m.stream_header(w, h, fps=(25, 1), interlacing="t"))
        for f in frames:
            fh.write(y4m.encode_frame(f))


def chain_j(tmp):
    """(j): a seeded 1080i I420 .y4m -> greedy-H -> tee: y4menc ! filesink,
    and BGRA 1280x720 -> jpegenc -> multifilesink.  The .y4m byte-equal to
    the CPU run's (or every sample within 1 LSB once parsed); each JPEG,
    decoded, within 1 LSB of the CPU run's."""
    import numpy as np

    from tpuvf_torch.io import y4m
    from tpuvf_torch.native import jpeg

    label = "(j) 1080i I420 .y4m -> greedy-H -> tee: y4menc + 720p jpegenc"
    src = Path(tmp) / "in.y4m"
    write_y4m(src, i420_moving_block(FRAMES, 1920, 1080, seed=44), 1920, 1080)
    dirs = {}
    for dev in ("cuda", "cpu"):
        out = dirs[dev] = Path(tmp) / f"j-{dev}"
        out.mkdir()
        pipe = fed_pipeline(CHAIN_J.format(src=src, out=out), {}, dev)
        if dev == "cuda":
            launches = counted_run(label, pipe, FRAMES,
                                   (f"K5={FRAMES}", "K1", "K1b", "K2"))
            gpu = pipe
        else:
            pipe.run()
    got, want = (dirs[d] / "out.y4m" for d in ("cuda", "cpu"))
    if got.read_bytes() == want.read_bytes():
        y4m_note = "out.y4m byte-equal"
    else:
        a, b = y4m.Reader(str(got)), y4m.Reader(str(want))
        if a.header != b.header or a.num_frames() != b.num_frames():
            fail(f"{label}: out.y4m headers or frame counts differ")
        for k in range(b.num_frames()):
            fa, fb = a.read_frame(k), b.read_frame(k)
            for p in fb:
                within(label, fa[p], fb[p], f"out.y4m frame {k} {p}")
        y4m_note = "out.y4m within 1 LSB per sample once parsed"
    names = sorted(p.name for p in dirs["cpu"].glob("f*.jpg"))
    if names != sorted(p.name for p in dirs["cuda"].glob("f*.jpg")) or \
            len(names) != FRAMES:
        fail(f"{label}: JPEG files {names}")
    same, worst = 0, 0
    for name in names:
        a, b = ((dirs[d] / name).read_bytes() for d in ("cuda", "cpu"))
        same += a == b
        worst = max(worst, within(label, jpeg.decode(a), jpeg.decode(b),
                                  f"{name} decoded"))
    first = jpeg.decode((dirs["cuda"] / names[0]).read_bytes())
    if first.shape != (720, 1280, 4) or np.array_equal(
            first, jpeg.decode((dirs["cuda"] / names[1]).read_bytes())):
        fail(f"{label}: JPEG frames {first.shape} or equal")
    print_chain(label, gpu, launches,
                f"{y4m_note}; JPEGs decoded max {worst} LSB from the CPU "
                f"run's, {same} of {len(names)} byte-equal")
    return launches


def chain_k(tmp):
    """(k): 8 seeded 3840x2160 UYVY frames as raw bytes -> rawvideosrc ->
    vfconvertscale -> BGRA 4K, and -> YUY2 1920x1080, each to a filesink;
    each output file within 1 LSB of the CPU run's."""
    import numpy as np

    src = Path(tmp) / "in.uyvy"
    np.random.default_rng(422).integers(
        0, 256, (FRAMES, 2160, 7680), dtype=np.uint8).tofile(src)
    total = {}
    for caps, expect in (("format=BGRA", ("K1b", "K2")),
                         ("format=YUY2,width=1920,height=1080",
                          ("K1", "K1b", "K2"))):
        label = f"(k) UYVY 3840x2160 raw file -> {caps.replace('format=', '')}"
        outs = {d: Path(tmp) / f"k-{d}.raw" for d in ("cuda", "cpu")}
        pipe = fed_pipeline(CHAIN_K.format(src=src, caps=caps,
                                           out=outs["cuda"]), {}, "cuda")
        launches = counted_run(label, pipe, FRAMES, expect)
        fed_pipeline(CHAIN_K.format(src=src, caps=caps, out=outs["cpu"]), {},
                     "cpu").run()
        got, want = (np.fromfile(outs[d], np.uint8) for d in ("cuda", "cpu"))
        worst = within(label, got, want, "the output file")
        print_chain(label, pipe, launches,
                    f"{got.size} bytes, max {worst} LSB from the CPU run's")
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v
    return total


def phase_file_chains(tmp):
    """Chains (i)-(k); -> {kernel: launches summed over them}."""
    total = {}
    for launches in (chain_i(), chain_j(tmp), chain_k(tmp)):
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v
    return total


LFRAMES = 16  # phase (l)'s frames a path
CHAIN_B = ("appsrc format=NV12 width=3840 height=2160 ! vfmetalconvertscale ! "
           f"video/x-raw,format=BGRA,width=3840,height=2160 ! {BCS} ! appsink")


def same_frames(label, got, want) -> None:
    """Two runs' appsink frames, equal frame for frame (0 LSB)."""
    import numpy as np

    if len(got) != len(want):
        fail(f"{label}: {len(got)} frames against {len(want)}")
    for i, (a, b) in enumerate(zip(got, want)):
        a, b = _planes(a), _planes(b)
        if any(not np.array_equal(a[k], b[k]) for k in b):
            fail(f"{label}: frame {i} differs from run()'s")


def ctl_b(label_run, card):
    """(l) chain (b) at 4K with a 16-entry brightness ramp: run() against
    run_batched (two batches of 8), 0 LSB frame for frame; frames 0 and 15
    within 1 LSB of the CPU run; K1, K1b and K2 launched under both; then
    fps of the two loops in turns, a reading."""
    import numpy as np

    ramp = [float(v) for v in np.linspace(0.02, 0.3, LFRAMES)]
    feeds = {"appsrc0": nv12_frames(LFRAMES, 3840, 2160, seed=3841)}
    pipes, launches = {}, {}
    for mode in ("run", "run_batched"):
        pipe = fed_pipeline(CHAIN_B, feeds, "cuda")
        pipe["vfmetalvideofilter0"].control("brightness", ramp)
        drive = (pipe.run if mode == "run" else
                 lambda pipe=pipe: pipe.run_batched(LFRAMES, batch_size=8))
        launches[mode] = counted_run(f"{label_run} {mode}", pipe, LFRAMES,
                                     ("K1", "K1b", "K2"), drive)
        pipes[mode] = pipe
    got = pipes["run_batched"]["appsink0"].frames
    same_frames(f"{label_run} run_batched", got, pipes["run"]["appsink0"]
                .frames)
    if np.array_equal(got[0], got[1]):
        fail(f"{label_run}: the ramp did not animate")
    # the chain keeps no state: frames 0 and 15 alone, with their ramp
    # entries, give the CPU run's
    cpu = fed_pipeline(CHAIN_B, {"appsrc0": [feeds["appsrc0"][0],
                                             feeds["appsrc0"][-1]]}, "cpu")
    cpu["vfmetalvideofilter0"].control("brightness", [ramp[0], ramp[-1]])
    cpu.run()
    worst = max(within(label_run, got[k], cpu["appsink0"].frames[c],
                       f"frame {k}") for c, k in enumerate((0, LFRAMES - 1)))
    fps, edges = {"run": [], "run_batched": []}, {}
    for mode in ("run", "run_batched", "run_batched", "run"):
        pipe = pipes[mode]
        pipe["appsink0"].frames.clear()
        if mode == "run":
            rate, edges[mode] = run_fps(pipe)
        else:
            rate, edges[mode] = run_fps(
                pipe, lambda pipe=pipe: pipe.run_batched(LFRAMES,
                                                         batch_size=8))
        fps[mode].append(rate)
    counts = {m: ", ".join(f"{k} {v}" for k, v in launches[m].items() if v)
              for m in launches}
    print(f"[l controllers] {label_run}: run_batched (2 batches of 8) = "
          f"run() 0 LSB on {LFRAMES} frames; frames 0, {LFRAMES - 1} vs CPU "
          f"max {worst} LSB | launches run: {counts['run']}; run_batched: "
          f"{counts['run_batched']}", flush=True)
    print(f"[l fps] (b) 4K with the ramp, Pipeline wall fps in turns (run, "
          f"batched, batched, run; a reading, no claim): run "
          + ", ".join(f"{v:.2f}" for v in fps["run"]) + "; run_batched "
          + ", ".join(f"{v:.2f}" for v in fps["run_batched"])
          + f" | {card}", flush=True)
    for mode, edge in edges.items():
        print(f"[l edge] (b) {mode}, its last run: {edge_text(edge)}",
              flush=True)
    return launches


def ctl_g():
    """(l) chain (g), I420 1080i greedy-H: two calls of run_batched (batch
    8) against two calls of run(), 0 LSB, one K5 a frame; then reset() and
    4 frames, equal to a fresh pipeline's first 4."""
    label = "(l) (g) greedy-H 1080i"
    feeds = {"appsrc0": i420_moving_block(8, 1920, 1080, seed=45)}
    pipes, launches = {}, {}
    for mode in ("run", "run_batched"):
        pipe = fed_pipeline(CONFIG4, feeds, "cuda")

        def drive(pipe=pipe, mode=mode):
            if mode == "run":
                return pipe.run(8) + pipe.run(8)
            return pipe.run_batched(8) + pipe.run_batched(8)

        launches[mode] = counted_run(f"{label} {mode}", pipe, LFRAMES,
                                     (f"K5={LFRAMES}", "!K1", "!K1b", "!K2"),
                                     drive)
        pipes[mode] = pipe
    same_frames(f"{label} run_batched", pipes["run_batched"]["appsink0"]
                .frames, pipes["run"]["appsink0"].frames)
    pipe = pipes["run_batched"]
    pipe.reset()
    pipe["appsink0"].frames.clear()
    pipe.run_batched(4, batch_size=4)
    fresh = fed_pipeline(CONFIG4, feeds, "cuda")
    fresh.run(4)
    same_frames(f"{label} after reset()", pipe["appsink0"].frames,
                fresh["appsink0"].frames)
    print(f"[l controllers] {label}: run_batched(8) twice = run(8) twice, 0 "
          f"LSB on {LFRAMES} frames, K5 {launches['run_batched']['K5']} "
          f"({launches['run_batched']['K5'] / LFRAMES:g}/frame); reset() then "
          f"4 frames = a fresh pipeline's first 4", flush=True)
    return launches


def ctl_f():
    """(l) chain (f) with a sink_0::xpos ramp: run() against run_batched,
    0 LSB, K4 launched; the draw moves with the ramp."""
    import numpy as np

    label = "(l) (f) sink_0::xpos ramp"
    ramp = [-100 + 8 * k for k in range(LFRAMES)]
    feeds = {"s0": nv12_frames(LFRAMES, 1920, 1080, seed=62),
             "s1": rgba_frames(LFRAMES, 1280, 720, seed=63)}
    pipes, launches = {}, {}
    for mode in ("run", "run_batched"):
        pipe = fed_pipeline(CHAIN_F, feeds, "cuda")
        pipe["c"].control("sink_0::xpos", ramp)
        drive = (pipe.run if mode == "run" else
                 lambda pipe=pipe: pipe.run_batched(LFRAMES, batch_size=8))
        launches[mode] = counted_run(f"{label} {mode}", pipe, LFRAMES,
                                     ("K1", "K1b", "K2", "K4"), drive)
        pipes[mode] = pipe
    got = pipes["run_batched"]["appsink0"].frames
    same_frames(f"{label} run_batched", got, pipes["run"]["appsink0"].frames)
    cpu = fed_pipeline(CHAIN_F, {k: [v[0], v[-1]] for k, v in feeds.items()},
                       "cpu")
    cpu["c"].control("sink_0::xpos", [ramp[0], ramp[-1]])
    cpu.run()
    worst = 0
    for c, k in enumerate((0, LFRAMES - 1)):
        for p, want in cpu["appsink0"].frames[c].items():
            worst = max(worst, within(label, got[k][p], want,
                                      f"frame {k} {p}"))
    if np.array_equal(got[0]["y"], got[1]["y"]):
        fail(f"{label}: the pad did not move")
    print(f"[l controllers] {label}: run_batched = run() 0 LSB on {LFRAMES} "
          f"frames; frames 0, {LFRAMES - 1} vs CPU max {worst} LSB; K4 "
          f"{launches['run_batched']['K4']}", flush=True)
    return launches


def live_a(card):
    """(l) run_live on chain (a) at 30 fps: the achieved period between
    deliveries, the ticks dropped and latency(), a reading."""
    import time as _time

    label = "(l) run_live (a) 30 fps"
    desc = ("appsrc format=NV12 width=1920 height=1080 ! "
            "video/x-raw,framerate=30/1 ! vfmetalconvertscale ! "
            f"video/x-raw,format=BGRA,width=640,height=480 ! {BCS} ! appsink")
    feeds = {"appsrc0": nv12_frames(LFRAMES, 1920, 1080, seed=30)}
    pipe = fed_pipeline(desc, feeds, "cuda")
    stamps, sink = [], pipe["appsink0"]
    consume = sink.consume

    def stamped(frame, spec, index):
        stamps.append(_time.perf_counter())
        consume(frame, spec, index)

    sink.consume = stamped
    # the frames run and the ticks dropped add up to the clock's 16
    launches = counted_run(label, pipe, LFRAMES, ("K1", "K1b", "K2"),
                           lambda: pipe.run_live(LFRAMES)
                           + pipe.stats.frames_dropped)
    dropped = pipe.stats.frames_dropped
    if len(stamps) + dropped != LFRAMES:
        fail(f"{label}: {len(stamps)} delivered + {dropped} dropped != "
             f"{LFRAMES}")
    # frame k is delivered at tick k + 1, the last one as the loop ends:
    # the period is taken between the deliveries of frames 1 and n - 2
    period = (stamps[-2] - stamps[1]) / (len(stamps) - 3) * 1e3
    lo, hi = pipe.latency()
    print(f"[l live] {label}: {len(stamps)} frames delivered, "
          f"frames_dropped {dropped}, period between deliveries after the "
          f"preroll {period:.2f} ms (clock 33.33 ms), latency() "
          f"({lo:g}, {hi * 1e3:.2f} ms) | {card}", flush=True)
    return launches


def nav_f():
    """(l) one navigation event through (f) -> vfvideosink: the routed
    source and coordinates equal the CPU run's."""
    label = "(l) navigation (f) -> vfvideosink"
    desc = CHAIN_F.replace("! appsink", "! vfmetalvideosink", 1)
    feeds = {"s0": nv12_frames(1, 1920, 1080, seed=64),
             "s1": rgba_frames(1, 1280, 720, seed=65)}
    routed = {}
    for dev in ("cuda", "cpu"):
        pipe = fed_pipeline(desc, feeds, dev)
        pipe.run()
        sink = pipe["vfmetalvideosink0"]
        h, w = sink.window.shape[:2]  # the video's size: 1920x1080
        # over the keep-aspect pad, then over the scaled NV12 pad only
        for fx, fy in ((0.625, 0.555), (0.104, 0.277)):
            sink.send_navigation_event("mouse-button-press", fx * w, fy * h)
        routed[dev] = pipe.navigation_events
    if routed["cuda"] != routed["cpu"] or len(routed["cuda"]) != 2:
        fail(f"{label}: {routed['cuda']} against the CPU run's "
             f"{routed['cpu']}")
    print(f"[l navigation] {label}: " + "; ".join(
        f"{ev['source']} at ({ev['pointer_x']:.3f}, {ev['pointer_y']:.3f})"
        for ev in routed["cuda"]) + " = the CPU run's", flush=True)


def phase_controllers(card):
    """Phase (l): controllers, batched and live, 16 frames a path;
    -> {kernel: launches summed over its paths}."""
    total = {}
    parts = [ctl_b("(l) (b) NV12 4K + brightness ramp", card), ctl_g(),
             ctl_f(), {"live": live_a(card)}]
    for part in parts:
        for launches in part.values():
            for k, v in launches.items():
                total[k] = total.get(k, 0) + v
    nav_f()
    return total


# -- phase (m): dp/sp sharding ------------------------------------------------


def mesh_devices(k: int) -> list:
    """k devices for a mesh: distinct cards where the machine has k, else
    cuda:0 repeated (one card rehearsing the bands: they share it)."""
    import torch

    if torch.cuda.device_count() >= k:
        return [f"cuda:{i}" for i in range(k)]
    return ["cuda:0"] * k


def mesh_of(axes: dict):
    from tpuvf_torch.parallel.mesh import make_mesh

    size = 1
    for v in axes.values():
        size *= v
    return make_mesh(axes, devices=mesh_devices(size))


def mesh_same(label, got, want) -> None:
    """Frame for frame, 0 LSB, with the worst difference named."""
    import numpy as np

    if len(got) != len(want):
        fail(f"{label}: {len(got)} frames against {len(want)}")
    for i, (a, b) in enumerate(zip(got, want)):
        a, b = _planes(a), _planes(b)
        for k in b:
            if a[k].shape != b[k].shape or not np.array_equal(a[k], b[k]):
                d = (np.abs(a[k].astype(np.int32) - b[k].astype(np.int32))
                     .max() if a[k].shape == b[k].shape else "shape")
                fail(f"{label}: frame {i} plane {k} differs from the "
                     f"unsharded run (max {d})")


def launch_text(launches) -> str:
    return ", ".join(f"{k} {v}" for k, v in launches.items() if v)


def one_card_shards(mesh, sp_axis) -> bool:
    """Whether every dp shard's bands lie on one card (its graph holds the
    whole shard)."""
    from tpuvf_torch.parallel import mesh as pmesh

    return all(len(set(devs)) == 1
               for devs in pmesh.layout(mesh, sp_axis).devices)


def mesh_path(label, desc, feeds, axes, expect, card, calls=1, exact=(),
              **kw):
    """Drive `desc` through run_batched on a mesh of `axes` (rows over
    'sp' where the mesh has it) and unsharded, both on the card, `calls`
    calls of the fed frames each (batch 8; each call's clock restarts at
    buffer 0 while the carried state goes on), twice: a warm-up, in which
    every frame key runs eagerly once and the graphs are captured, then
    the run whose counters are set to 0 just before it and read just
    after.  The mesh runs through its shard graphs (one replay a shard a
    batch; no frame eager after the warm-up where each shard lies on one
    card), and a third pipeline runs the same mesh with every step eager
    (`eager_steps`).  The frames of all three must be equal (0 LSB), the
    kernels of `exact` must launch sp times as often as unsharded; then
    run_batched's fps unsharded, with the shard graphs and eager, a
    reading.  -> the counted mesh run's launches."""
    per = len(max(feeds.values(), key=len))
    frames = per * calls
    sp_axis = "sp" if "sp" in axes else None
    mesh = mesh_of(axes)
    plain = fed_pipeline(desc, feeds, "cuda")
    sharded = fed_pipeline(desc, feeds, "cuda")
    eager = fed_pipeline(desc, feeds, "cuda")
    eager_steps(eager)

    def drive_plain():
        return sum(plain.run_batched(per, batch_size=FRAMES)
                   for _ in range(calls))

    def drive_mesh(pipe):
        return sum(pipe.run_batched(per, batch_size=FRAMES, mesh=mesh,
                                    sp_axis=sp_axis, **kw)
                   for _ in range(calls))

    drive_plain()
    drive_mesh(sharded)
    drive_mesh(eager)
    want = counted_run(f"{label} unsharded", plain, frames, expect,
                       drive_plain)
    cs = sharded.compiled
    cs.eager = cs.batch_captures = cs.batch_replays = 0
    got = counted_run(f"{label} {axes}", sharded, frames, expect,
                      lambda: drive_mesh(sharded))
    counts = (cs.batch_replays, cs.batch_captures, cs.eager)
    drive_mesh(eager)
    mesh_same(f"{label} {axes}", sharded["appsink0"].frames,
              plain["appsink0"].frames)
    mesh_same(f"{label} {axes} graphs against eager",
              sharded["appsink0"].frames, eager["appsink0"].frames)
    sp = axes.get("sp", 1)
    wrong = {k: (got[k], want[k]) for k in exact if got[k] != sp * want[k]}
    if wrong:
        fail(f"{label} {axes}: launches (mesh, unsharded) {wrong}; expected "
             f"sp={sp} times the unsharded count")
    dp = axes.get("dp", 1)
    one_card = one_card_shards(mesh, sp_axis)
    if one_card and (cs.eager or cs.batch_replays != calls * dp):
        fail(f"{label} {axes}: after the warm-up eager {cs.eager}, shard "
             f"replays {cs.batch_replays}; expected 0 and {calls * dp} (one "
             f"a shard a batch)")
    fps = {"unsharded": [], "mesh": [], "eager": []}
    runs = {"unsharded": (plain, drive_plain),
            "mesh": (sharded, lambda: drive_mesh(sharded)),
            "eager": (eager, lambda: drive_mesh(eager))}
    for name in ("unsharded", "mesh", "eager", "eager", "mesh", "unsharded"):
        pipe, drive = runs[name]
        pipe["appsink0"].frames.clear()
        fps[name].append(run_fps(pipe, drive)[0])
    devs = [str(d) for d in mesh.devices.flat]
    print(f"[m mesh] {label} on {axes} ({', '.join(devs)}): = unsharded "
          f"run_batched and = the eager mesh, 0 LSB on {2 * frames} frames "
          f"({calls} call{'s' if calls > 1 else ''} twice) | after the "
          f"warm-up: shard replays {counts[0]}, captures {counts[1]}, "
          f"eager {counts[2]}"
          f"{'' if one_card else ' (shards across cards run eagerly)'} | "
          f"launches mesh: {launch_text(got)}; unsharded: "
          f"{launch_text(want)}", flush=True)
    print(f"[m fps] {label} {axes}: run_batched fps in turns (unsharded, "
          f"graphs, eager, eager, graphs, unsharded; a reading): unsharded "
          + ", ".join(f"{v:.2f}" for v in fps["unsharded"]) + "; mesh "
          "graphs " + ", ".join(f"{v:.2f}" for v in fps["mesh"])
          + "; mesh eager " + ", ".join(f"{v:.2f}" for v in fps["eager"])
          + f" | {card}", flush=True)
    return got


def mesh_ramp(card):
    """(b) 4K with a 16-entry brightness ramp on {dp: 2, sp: 2} against
    run() (16 frames, two batches of 8)."""
    import numpy as np

    label = "(m) (b) 4K + brightness ramp"
    axes = {"dp": 2, "sp": 2}
    ramp = [float(v) for v in np.linspace(0.02, 0.3, LFRAMES)]
    feeds = {"appsrc0": nv12_frames(LFRAMES, 3840, 2160, seed=3842)}
    mesh = mesh_of(axes)
    pipes = {}
    for mode in ("run", "mesh"):
        pipes[mode] = pipe = fed_pipeline(CHAIN_B, feeds, "cuda")
        pipe["vfmetalvideofilter0"].control("brightness", ramp)
    want = counted_run(f"{label} run", pipes["run"], LFRAMES,
                       ("K1", "K1b", "K2"))
    got = counted_run(f"{label} {axes}", pipes["mesh"], LFRAMES,
                      ("K1", "K1b", "K2"),
                      lambda: pipes["mesh"].run_batched(
                          LFRAMES, batch_size=8, mesh=mesh, sp_axis="sp"))
    mesh_same(f"{label} {axes}", pipes["mesh"]["appsink0"].frames,
              pipes["run"]["appsink0"].frames)
    frames = pipes["mesh"]["appsink0"].frames
    if np.array_equal(frames[0], frames[1]):
        fail(f"{label}: the ramp did not animate")
    print(f"[m mesh] {label} on {axes} ("
          f"{', '.join(str(d) for d in mesh.devices.flat)}): = run() 0 LSB "
          f"on {LFRAMES} frames | launches mesh: {launch_text(got)}; run: "
          f"{launch_text(want)} | {card}", flush=True)
    return got


def mesh_streams(card):
    """(g) on {dp: 2} with independent_streams=True, two calls of 8 (4
    frames a shard a call): each shard's frames equal their own unsharded
    stream over two calls; the second call replays one graph a shard (each
    shard lies on one card, on distinct cards where the machine has two)
    and runs no frame eagerly; without the flag the run raises a
    ValueError naming the deinterlacer."""
    label = "(m) (g) greedy-H 1080i, dp=2"
    frames = i420_moving_block(FRAMES, 1920, 1080, seed=46)
    mesh = mesh_of({"dp": 2})
    pipe = fed_pipeline(CONFIG4, {"appsrc0": frames}, "cuda")

    def call():
        return pipe.run_batched(FRAMES, batch_size=FRAMES, mesh=mesh,
                                independent_streams=True)

    got = counted_run(f"{label} independent_streams", pipe, FRAMES,
                      (f"K5={FRAMES}", "!K1", "!K1b", "!K2"), call)
    cs = pipe.compiled
    cs.eager = cs.batch_replays = 0
    call()
    if cs.eager or cs.batch_replays != 2:
        fail(f"{label}: the second call ran {cs.eager} frames eagerly and "
             f"{cs.batch_replays} shard replays; expected 0 and 2")
    half = FRAMES // 2
    for d in range(2):
        own = fed_pipeline(CONFIG4, {"appsrc0": frames[d * half:
                                                       (d + 1) * half]},
                           "cuda")
        own.run_batched(half, batch_size=half)
        own.run_batched(half, batch_size=half)
        mesh_same(f"{label} shard {d}", [
            f for c in range(2) for f in pipe["appsink0"].frames[
                c * FRAMES + d * half:c * FRAMES + (d + 1) * half]],
            own["appsink0"].frames)
    refused = fed_pipeline(CONFIG4, {"appsrc0": frames}, "cuda")
    try:
        refused.run_batched(FRAMES, batch_size=FRAMES, mesh=mesh)
    except ValueError as exc:
        if "vfmetaldeinterlace0" not in str(exc):
            fail(f"{label}: the refusal does not name the deinterlacer: "
                 f"{exc}")
    else:
        fail(f"{label}: dp=2 without independent_streams ran")
    print(f"[m mesh] {label} ({', '.join(str(d) for d in mesh.devices.flat)}"
          f"): independent_streams=True, two calls, each shard's {half} "
          f"frames a call = its own unsharded stream, 0 LSB; K5 "
          f"{got['K5']} in the first; the second call one replay a shard, "
          f"no frame eager; without the flag ValueError naming "
          f"vfmetaldeinterlace0 | {card}", flush=True)
    return got


def phase_mesh(tmp, card):
    """Phase (m): dp/sp sharding on the card; -> {kernel: launches summed
    over the mesh runs}."""
    import torch

    t0 = time.perf_counter()
    n = torch.cuda.device_count()
    print(f"[m devices] {n} CUDA device(s): "
          + ("distinct cards for each mesh" if n >= 4 else
             "meshes of more devices than that repeat cuda:0 (the bands "
             "share the card: sp adds launches and gathers and buys "
             "nothing here)"), flush=True)
    lut17 = write_cube(Path(tmp) / "mesh17.cube", grade_cube(17, seed=18))
    lut33 = write_cube(Path(tmp) / "mesh33.cube", grade_cube(33, seed=34))
    red = red_png(Path(tmp) / "mesh-red.png")
    sp1 = {"dp": 1, "sp": 2}
    b = ("(m) (b) NV12 4K -> BGRA + b/c/s", CHAIN_B,
         {"appsrc0": nv12_frames(FRAMES, 3840, 2160, seed=3843)},
         ("K1", "K1b", "K2"))
    paths = [
        b + (sp1,), b + ({"dp": 1, "sp": 4},),
        ("(m) (d) RGBA 1080p 17^3 LUT + contrast + sharpness",
         f"appsrc format=RGBA width=1920 height=1080 ! vfmetalvideofilter "
         f"lut-file={lut17} contrast=1.1 sharpness=0.5 ! vfmetalconvertscale "
         f"! video/x-raw,format=BGRA ! appsink",
         {"appsrc0": rgba_frames(FRAMES, 1920, 1080, seed=19)},
         ("K2", "K3"), {"dp": 1, "sp": 4}),
        ("(m) (c) config 3 -> NV12",
         f"appsrc format=NV12 width=1920 height=1080 ! {CONFIG3} "
         f"lut-file={lut33} ! appsink",
         {"appsrc0": nv12_frames(FRAMES, 1920, 1080, seed=5)},
         ("K1", "K1b", "K2", "K3"), sp1),
        ("(m) (h) BGRA 640x480 clockwise, crop-left 32, crop-top 16",
         "appsrc format=BGRA width=640 height=480 ! vfmetaltransform "
         "method=clockwise crop-left=32 crop-top=16 ! appsink",
         {"appsrc0": rgba_frames(FRAMES, 640, 480, seed=6)},
         ("K1", "K1b", "K2"), sp1),
        ("(m) (h') NV12 1080p counterclockwise, crop-right 64 -> NV12",
         "appsrc format=NV12 width=1920 height=1080 ! vfmetaltransform "
         "method=counterclockwise crop-right=64 ! appsink",
         {"appsrc0": nv12_frames(FRAMES, 1920, 1080, seed=23)},
         ("K1", "K1b", "K2"), sp1),
    ]
    total = {}

    def add(launches):
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v

    for label, desc, feeds, expect, axes in paths:
        add(mesh_path(label, desc, feeds, axes, expect, card,
                      exact=expect))
    add(mesh_path("(m) (g) greedy-H 1080i", CONFIG4,
                  {"appsrc0": i420_moving_block(FRAMES, 1920, 1080,
                                                seed=47)},
                  sp1, ("K5", "!K1", "!K1b", "!K2"), card, calls=2,
                  exact=("K5",)))
    config5 = {"s0": rgba_frames(FRAMES, 3840, 2160, seed=54),
               "s1": nv12_frames(FRAMES, 1920, 1080, seed=55),
               "s2": rgba_frames(FRAMES, 1280, 720, seed=56),
               "s3": nv12_frames(FRAMES, 1280, 720, seed=57)}
    # the pads are sampled by the band their rect reaches: K1/K1b/K2 are
    # not sp times as many
    add(mesh_path("(m) (e') config 5 -> NV12 4K + overlay (K6)",
                  CONFIG5.format(png=red, fmt="NV12"), config5, sp1,
                  ("K1", "K1b", "K2", "K4", "K6"), card,
                  exact=("K4", "K6")))
    add(mesh_ramp(card))
    add(mesh_streams(card))
    print(f"[m time] phase (m) took {time.perf_counter() - t0:.1f} s",
          flush=True)
    return total


# -- phase (n): the compiled step ------------------------------------------


def record_sinks(pipe) -> dict:
    """{sink name: [(frame index, bytes)]}: what each sink is handed (its
    payload after its host codecs), in the order the runs deliver it."""
    import numpy as np

    got = {}
    for sink in pipe.sinks:
        frames = got[sink.name] = []
        deliver = sink.deliver

        def keep(payload, spec, index, frames=frames, deliver=deliver):
            if isinstance(payload, (bytes, bytearray)):
                data = bytes(payload)
            elif isinstance(payload, dict):
                data = b"".join(np.ascontiguousarray(v).tobytes()
                                for v in payload.values())
            else:
                data = np.ascontiguousarray(payload).tobytes()
            frames.append((index, data))
            deliver(payload, spec, index)

        sink.deliver = keep
    return got


def eager_steps(pipe) -> None:
    """Every frame, batch and shard of `pipe`'s runs steps eagerly from now
    on: the compiled step's bodies (`step_sources` or `_step_bands` and the
    sinks' payloads over its fixed buffers), never a graph
    (`CompiledStep.graphs` off).  Phases (m), (n) and (o)'s reference."""
    pipe.compiled.graphs = False


def graph_step_us(pipe) -> tuple:
    """The host step (us, `host_us`: params re-read and staged each step,
    the inputs on the card, as phase 4 times the step) eager and with the
    graph, over the same body (the split, the stages, the sinks' payloads
    and the state write-back): its eager run, and the replay of frame 0's
    key; then the device span of each (CUDA events, us)."""
    from tpuvf_torch.runtime.staging import read_params

    cs = pipe.compiled
    out_fps, infos = pipe._clock()
    metas = {name: meta for name, (_, meta) in
             pipe._select_buffers(0, out_fps, infos).items()}

    def eager():
        reads = read_params(pipe._active(), pipe.device)
        cs.stage(reads, metas)
        return cs._body(reads, metas, cs._load_state(pipe.state), 0)

    def graph():
        reads = read_params(pipe._active(), pipe.device)
        cs.stage(reads, metas)
        return cs.step(reads, metas, pipe.state, 0)

    return (host_us(eager), host_us(graph), cuda_ms(eager) * 1e3,
            cuda_ms(graph) * 1e3)


def compiled_path(label, make, drive, frames, expect=(), captures=None,
                  live=False):
    """One path of phase (n): `make()` -> a fresh pipeline on the card,
    `drive(pipe)` -> the frames it ran.  The graph run (the launch counters
    set to 0 just before it and read just after, `counted_run`) against
    the same run with every step eager (`eager_steps`), byte-equal for
    every sink and frame (a live run: on the frames both delivered); the
    compiled step's keys, captures and replays, `captures` captures where
    given; -> (launches, the graph run's pipeline, a text)."""
    graph = make()
    got = record_sinks(graph)
    before = graph.stats.compile_seconds
    launches = counted_run(label, graph, frames, expect,
                           lambda: drive(graph))
    cs = graph.compiled
    capture_s = graph.stats.compile_seconds - before
    eager = make()
    want = record_sinks(eager)
    eager_steps(eager)
    drive(eager)
    compared = 0
    for sink, frames_want in want.items():
        frames_got = got[sink]
        if live:
            common = set(dict(frames_got)) & set(dict(frames_want))
            if len(common) < frames // 2:
                fail(f"{label}: {len(common)} frames delivered by both runs")
            frames_got = [f for f in frames_got if f[0] in common]
            frames_want = [f for f in frames_want if f[0] in common]
        if len(frames_got) != len(frames_want) or not frames_want:
            fail(f"{label}: {sink} got {len(frames_got)} frames, the eager "
                 f"run {len(frames_want)}")
        for (i, a), (j, b) in zip(frames_got, frames_want):
            if i != j or a != b:
                fail(f"{label}: {sink} frame {i} of the graph run differs "
                     f"from the eager run's")
        compared += len(frames_want)
    if cs.captures == 0 or cs.replays == 0:
        fail(f"{label}: {cs.captures} captures, {cs.replays} replays")
    if captures is not None and cs.captures != captures:
        fail(f"{label}: {cs.captures} captures, expected {captures} "
             f"(keys {cs.keys})")
    text = (f"graph = eager byte-equal on {compared} sink frames | keys "
            f"{cs.keys}, captures {cs.captures}, replays {cs.replays}, "
            f"eager {cs.eager} | captures took {capture_s * 1e3:.1f} ms "
            f"(compile_seconds {graph.stats.compile_seconds:.3f} s with the "
            f"build)")
    return launches, graph, text


def capture_failure():
    """A capture that an element's op breaks (a host read of a device
    value, legal eagerly) raises PipelineError naming that element at the
    capturing frame; nothing runs the step eagerly in its place."""
    from tpuvf_torch.runtime.observability import PipelineError

    desc = ("appsrc format=NV12 width=1920 height=1080 ! vfmetalconvertscale "
            f"! video/x-raw,format=BGRA,width=640,height=480 ! {BCS} ! "
            f"appsink")
    pipe = fed_pipeline(desc, {"appsrc0": nv12_frames(3, 1920, 1080, 7)},
                        "cuda")
    st = next(st for st in pipe.stages
              if st.element.ELEMENT_NAME == "vfvideofilter")
    real = st.process

    def process(planes, state, params):
        out, state = real(planes, state, params)
        int(out["rgba"][0, 0, 0])  # waits for the card: no capture can
        return out, state

    st.process = process
    try:
        pipe.run()
    except PipelineError as exc:
        if exc.element != st.element.name or exc.frame_index != 1:
            fail(f"(n) capture failure: named {exc.element!r} at frame "
                 f"{exc.frame_index}, not {st.element.name!r} at 1")
        if pipe.compiled.eager != 1 or len(pipe["appsink0"].frames) != 1:
            fail("(n) capture failure: a frame ran past the failed capture")
        print(f"[n capture failure] a host read in {st.element.name}'s "
              f"stage: PipelineError names {exc.element!r} at frame "
              f"{exc.frame_index} ({type(exc.cause).__name__})", flush=True)
        return
    fail("(n) capture failure: a host read in a stage did not fail the "
         "capture")


def dead_graphs_before_capture():
    """A dead pipeline's graphs (its pipeline and compiled step hold each
    other, so only the cyclic collector frees them) are freed before the
    next capture, not inside it, where destroying a graph invalidates the
    capture: the second pipeline's compositor stage runs the collector
    while its step is being captured, and the run must pass."""
    import gc

    def make():
        return fed_pipeline(CHAIN_F, {
            "s0": nv12_frames(3, 1920, 1080, seed=70),
            "s1": rgba_frames(3, 1280, 720, seed=71)}, "cuda")

    dead = make()
    dead.run()
    if dead.compiled.captures != 1:
        fail(f"(n) dead graphs: {dead.compiled.captures} captures, not 1")
    del dead
    pipe = make()
    stage = next(st for st in pipe.stages if st.element is pipe["c"])
    real = stage.process
    freed = []

    class Process:
        """The compositor's process, running the collector at the
        capture (its second call)."""

        calls = 0

        def __getattr__(self, name):
            return getattr(real, name)

        def __call__(self, *args):
            Process.calls += 1
            if Process.calls == 2:
                freed.append(gc.collect())
            return real(*args)

    stage.process = Process()
    pipe.run()
    if pipe.compiled.captures != 1 or not freed:
        fail(f"(n) dead graphs: {pipe.compiled.captures} captures, the "
             f"collector ran {len(freed)} times in the capture")
    print(f"[n dead graphs] a dropped pipeline's graphs freed before the "
          f"next capture: its run captures 1 graph with the collector run "
          f"inside the capture ({freed[0]} objects freed there)", flush=True)


def phase_compiled(tmp, card):
    """Phase (n): every main path under Pipeline.run (and phase (l)'s
    paths under their loops) through the compiled step, each against the
    same run stepped eagerly, byte-equal; the host step eager and with the
    graph; -> {kernel: launches summed over the paths}."""
    import numpy as np

    t0 = time.perf_counter()
    total = {}

    def add(launches):
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v

    for label, desc, feeds, expect, _, *tffs in main_paths(tmp):
        launches, pipe, text = compiled_path(
            label, lambda: fed_pipeline(desc, feeds, "cuda", *tffs),
            lambda p: p.run(), FRAMES, expect)
        add(launches)
        eager_us, graph_us, eager_dev, graph_dev = graph_step_us(pipe)
        print(f"[n compiled] {label[:4].strip()}: {text} | host step eager "
              f"{eager_us:.1f} us, graph {graph_us:.1f} us | device span "
              f"(events) eager {eager_dev:.1f} us, graph {graph_dev:.1f} "
              f"us", flush=True)
    # (i)-(k): the tee with the window, the file edge, packed 4:2:2
    src_j = Path(tmp) / "n-in.y4m"
    write_y4m(src_j, i420_moving_block(FRAMES, 1920, 1080, seed=46), 1920,
              1080)
    src_k = Path(tmp) / "n-in.uyvy"
    np.random.default_rng(423).integers(
        0, 256, (FRAMES, 2160, 7680), dtype=np.uint8).tofile(src_k)
    outs = iter(range(1000))

    def out_dir():
        out = Path(tmp) / f"n-out{next(outs)}"
        out.mkdir()
        return out

    files = [
        ("(i)", lambda: fed_pipeline(CHAIN_I, {"appsrc0": nv12_frames(
            FRAMES, 3840, 2160, seed=39)}, "cuda"), ("K1", "K1b", "K2")),
        ("(j)", lambda: fed_pipeline(CHAIN_J.format(src=src_j, out=out_dir()),
                                     {}, "cuda"), (f"K5={FRAMES}",)),
        ("(k) -> BGRA", lambda: fed_pipeline(CHAIN_K.format(
            src=src_k, caps="format=BGRA", out=out_dir() / "k.raw"), {},
            "cuda"), ("K1b", "K2")),
        ("(k) -> YUY2", lambda: fed_pipeline(CHAIN_K.format(
            src=src_k, caps="format=YUY2,width=1920,height=1080",
            out=out_dir() / "k.raw"), {}, "cuda"), ("K1", "K1b", "K2")),
    ]
    for label, make, expect in files:
        launches, _, text = compiled_path(label, make, lambda p: p.run(),
                                          FRAMES, expect)
        add(launches)
        print(f"[n compiled] {label}: {text}", flush=True)
    # (l)'s paths under run(): the ramps (one capture over 16 frames), the
    # live loop, the window of the navigation chain (run_batched's: (o))
    ramp = [float(v) for v in np.linspace(0.02, 0.3, LFRAMES)]
    feeds_b = {"appsrc0": nv12_frames(LFRAMES, 3840, 2160, seed=3842)}

    def ramp_b():
        pipe = fed_pipeline(CHAIN_B, feeds_b, "cuda")
        pipe["vfmetalvideofilter0"].control("brightness", ramp)
        return pipe

    xramp = [-100 + 8 * k for k in range(LFRAMES)]
    feeds_f = {"s0": nv12_frames(LFRAMES, 1920, 1080, seed=66),
               "s1": rgba_frames(LFRAMES, 1280, 720, seed=67)}

    def ramp_f():
        pipe = fed_pipeline(CHAIN_F, feeds_f, "cuda")
        pipe["c"].control("sink_0::xpos", xramp)
        return pipe

    live = ("appsrc format=NV12 width=1920 height=1080 ! "
            "video/x-raw,framerate=30/1 ! vfmetalconvertscale ! "
            f"video/x-raw,format=BGRA,width=640,height=480 ! {BCS} ! appsink")
    feeds_a = {"appsrc0": nv12_frames(LFRAMES, 1920, 1080, seed=31)}
    feeds_nav = {"s0": nv12_frames(4, 1920, 1080, seed=68),
                 "s1": rgba_frames(4, 1280, 720, seed=69)}
    paths = [
        ("(l) (b) 4K brightness ramp, run()", ramp_b, lambda p: p.run(),
         LFRAMES, ("K1", "K1b", "K2"), 1, False),
        ("(l) (f) sink_0::xpos ramp, run()", ramp_f, lambda p: p.run(),
         LFRAMES, ("K1", "K1b", "K2", "K4"), 1, False),
        ("(l) run_live (a) 30 fps", lambda: fed_pipeline(live, feeds_a,
                                                         "cuda"),
         lambda p: p.run_live(LFRAMES) + p.stats.frames_dropped, LFRAMES,
         ("K1", "K1b", "K2"), None, True),
        ("(l) (f) -> vfvideosink (the navigation chain)",
         lambda: fed_pipeline(CHAIN_F.replace("! appsink",
                                              "! vfmetalvideosink", 1),
                              feeds_nav, "cuda"),
         lambda p: p.run(), 4, ("K1", "K1b", "K2", "K4"), None, False),
    ]
    for label, make, drive, frames, expect, captures, is_live in paths:
        launches, _, text = compiled_path(label, make, drive, frames,
                                          expect, captures, is_live)
        add(launches)
        print(f"[n compiled] {label}: {text}", flush=True)
    capture_failure()
    dead_graphs_before_capture()
    print(f"[n time] phase (n) took {time.perf_counter() - t0:.1f} s | "
          f"{card}", flush=True)
    return total


# -- phase (o): one graph a batch ----------------------------------------------


def capture_memory(pipe) -> list:
    """Measure each of `pipe`'s compiled-step captures: -> a list that
    gets, per capture, (peak bytes allocated during it, bytes it left
    allocated), each above what was allocated just before it
    (`torch.cuda.max_memory_allocated` after resetting the peak).  The
    collector runs first, as the capture runs it: what it frees is not
    the capture's."""
    import gc

    import torch

    cs = pipe.compiled
    capture = cs._capture
    seen = []

    def measured(body, device, index):
        gc.collect()
        torch.cuda.synchronize(device)
        base = torch.cuda.memory_allocated(device)
        torch.cuda.reset_peak_memory_stats(device)
        entry = capture(body, device, index)
        torch.cuda.synchronize(device)
        seen.append((torch.cuda.max_memory_allocated(device) - base,
                     torch.cuda.memory_allocated(device) - base))
        return entry

    cs._capture = measured
    return seen


def batch_path(label, make, per, calls, expect, captures, replays, card):
    """One path of phase (o): `make()` -> a fresh pipeline on the card,
    driven by `calls` run_batched calls of `per` frames (batch 8) through
    the batch graphs (its counters set to 0 just before and read just
    after, `counted_run`), against the same calls with every step eager
    (`eager_steps`), byte for byte on every sink's frames.  The batch
    graphs must be captured `captures` times and replayed `replays` times
    (one capture a batch key, one replay a batch once its frame keys have
    run).  Then the host step a batch (`edge_seconds`' step: params
    re-read and staged, and the step's enqueue) and run_batched's fps,
    eager and with the graphs in turns, and each capture's peak memory;
    -> the graph run's launches."""
    frames = per * calls
    graph = make()
    got = record_sinks(graph)
    memory = capture_memory(graph)

    def drive(pipe):
        return sum(pipe.run_batched(per, batch_size=8) for _ in range(calls))

    launches = counted_run(label, graph, frames, expect,
                           lambda: drive(graph))
    cs = graph.compiled
    eager = make()
    want = record_sinks(eager)
    eager_steps(eager)
    drive(eager)
    for sink, frames_want in want.items():
        if got[sink] != frames_want or len(frames_want) != frames:
            fail(f"{label}: {sink}'s {len(got[sink])} frames of the batch "
                 f"graphs differ from the eager run's {len(frames_want)}")
    counts = (f"batch captures {cs.batch_captures}, replays "
              f"{cs.batch_replays}, eager frames {cs.eager}")
    if cs.batch_captures != captures or cs.batch_replays != replays:
        fail(f"{label}: {counts}; expected {captures} captures and "
             f"{replays} replays")
    for pipe in (graph, eager):
        for sink in pipe.sinks:
            del sink.deliver  # record_sinks' wrapper: keep no more bytes
    fps = {"eager": [], "graphs": []}
    step = {"eager": [], "graphs": []}
    for name in ("eager", "graphs", "graphs", "eager"):
        pipe = graph if name == "graphs" else eager
        for sink in pipe.sinks:
            getattr(sink, "frames", []).clear()
        rate, edge = run_fps(pipe, lambda pipe=pipe: drive(pipe))
        fps[name].append(rate)
        step[name].append(edge["step"] * 8)
    peak = ", ".join(f"{p / 2**20:.1f} MiB peak, {h / 2**20:.1f} MiB held"
                     for p, h in memory)
    print(f"[o batch] {label}: graphs = eager byte-equal on {frames} frames "
          f"({calls} call{'s' if calls > 1 else ''} of {per}) | {counts} | "
          f"launches {launch_text(launches)} | captures: {peak}",
          flush=True)
    print(f"[o host] {label}: host step a batch of 8, ms (params staged + "
          f"the step's enqueue; eager, graphs, graphs, eager): eager "
          + ", ".join(f"{v:.3f}" for v in step["eager"]) + "; graphs "
          + ", ".join(f"{v:.3f}" for v in step["graphs"])
          + " | run_batched fps: eager "
          + ", ".join(f"{v:.2f}" for v in fps["eager"]) + "; graphs "
          + ", ".join(f"{v:.2f}" for v in fps["graphs"]) + f" | {card}",
          flush=True)
    return launches


def batch_capture_failure():
    """A batch capture that an element's op breaks (a host read of a device
    value, legal eagerly) raises PipelineError naming that element at the
    batch's first frame; the eager batch before it is delivered."""
    from tpuvf_torch.runtime.observability import PipelineError

    desc = ("appsrc format=NV12 width=1920 height=1080 ! vfmetalconvertscale "
            f"! video/x-raw,format=BGRA,width=640,height=480 ! {BCS} ! "
            f"appsink")
    pipe = fed_pipeline(desc, {"appsrc0": nv12_frames(16, 1920, 1080, 8)},
                        "cuda")
    st = next(st for st in pipe.stages
              if st.element.ELEMENT_NAME == "vfvideofilter")
    real = st.process

    def process(planes, state, params):
        out, state = real(planes, state, params)
        int(out["rgba"][0, 0, 0])  # waits for the card: no capture can
        return out, state

    st.process = process
    try:
        pipe.run_batched(16, batch_size=8)
    except PipelineError as exc:
        if exc.element != st.element.name or exc.frame_index != 8:
            fail(f"(o) capture failure: named {exc.element!r} at frame "
                 f"{exc.frame_index}, not {st.element.name!r} at 8")
        if pipe.compiled.eager != 8 or len(pipe["appsink0"].frames) != 8:
            fail("(o) capture failure: the eager batch was not delivered "
                 "or a frame ran past the failed capture")
        print(f"[o capture failure] a host read in {st.element.name}'s "
              f"stage: PipelineError names {exc.element!r} at frame "
              f"{exc.frame_index}, the second batch's first "
              f"({type(exc.cause).__name__}); batch 0's 8 frames delivered",
              flush=True)
        return
    fail("(o) capture failure: a host read in a stage did not fail the "
         "batch's capture")


def phase_batch_graphs(tmp, card):
    """Phase (o): run_batched through one graph a batch, each path against
    the same calls stepped eagerly; -> {kernel: launches summed over the
    paths}."""
    import numpy as np

    t0 = time.perf_counter()
    total = {}

    def add(launches):
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v

    ramp = [float(v) for v in np.linspace(0.02, 0.3, LFRAMES)]
    feeds_b = {"appsrc0": nv12_frames(LFRAMES, 3840, 2160, seed=3844)}

    def ramp_b():
        pipe = fed_pipeline(CHAIN_B, feeds_b, "cuda")
        pipe["vfmetalvideofilter0"].control("brightness", ramp)
        return pipe

    xramp = [-100 + 8 * k for k in range(LFRAMES)]
    feeds_f = {"s0": nv12_frames(LFRAMES, 1920, 1080, seed=72),
               "s1": rgba_frames(LFRAMES, 1280, 720, seed=73)}

    def ramp_f():
        pipe = fed_pipeline(CHAIN_F, feeds_f, "cuda")
        pipe["c"].control("sink_0::xpos", xramp)
        return pipe

    red = red_png(Path(tmp) / "o-red.png")
    config5 = {"s0": rgba_frames(FRAMES, 3840, 2160, seed=74),
               "s1": nv12_frames(FRAMES, 1920, 1080, seed=75),
               "s2": rgba_frames(FRAMES, 1280, 720, seed=76),
               "s3": nv12_frames(FRAMES, 1280, 720, seed=77)}
    lut33 = write_cube(Path(tmp) / "o-grade33.cube", grade_cube(33, seed=35))
    feeds_c = {"appsrc0": nv12_frames(FRAMES, 1920, 1080, seed=78)}
    feeds_g = {"appsrc0": i420_moving_block(FRAMES, 1920, 1080, seed=48)}
    feeds_h = {"appsrc0": rgba_frames(FRAMES, 640, 480, seed=79)}
    # (label, make, frames a call, calls, kernels, captures, replays):
    # 16 frames a call are two batches of one key, the first eager on the
    # first call; a call of 8 is one batch, captured on the second call
    # (greedy-H's first batch carries has_prev False on frame 0)
    paths = [
        ("(o) (b) 4K brightness ramp", ramp_b, LFRAMES, 2,
         ("K1", "K1b", "K2"), 1, 3),
        ("(o) (f) sink_0::xpos ramp", ramp_f, LFRAMES, 2,
         ("K1", "K1b", "K2", "K4"), 1, 3),
        ("(o) (g) greedy-H, two calls of 8",
         lambda: fed_pipeline(CONFIG4, feeds_g, "cuda"), FRAMES, 2,
         (f"K5={2 * FRAMES}", "!K1", "!K1b", "!K2"), 1, 1),
        ("(o) (e') config 5 -> NV12 4K + overlay (K6)",
         lambda: fed_pipeline(CONFIG5.format(png=red, fmt="NV12"), config5,
                              "cuda"), FRAMES, 2,
         ("K1", "K1b", "K2", "K4", f"K6={2 * FRAMES}"), 1, 1),
        ("(o) (h) config 2: BGRA 640x480 clockwise, crops",
         lambda: fed_pipeline("appsrc format=BGRA width=640 height=480 ! "
                              "vfmetaltransform method=clockwise "
                              "crop-left=32 crop-top=16 ! appsink",
                              feeds_h, "cuda"), FRAMES, 2,
         ("K1", "K1b", "K2"), 1, 1),
        ("(o) (c) config 3 -> NV12",
         lambda: fed_pipeline(f"appsrc format=NV12 width=1920 height=1080 ! "
                              f"{CONFIG3} lut-file={lut33} ! appsink",
                              feeds_c, "cuda"), FRAMES, 2,
         ("K1", "K1b", "K2", "K3"), 1, 1),
    ]
    for label, make, per, calls, expect, captures, replays in paths:
        add(batch_path(label, make, per, calls, expect, captures, replays,
                       card))
    batch_capture_failure()
    print(f"[o time] phase (o) took {time.perf_counter() - t0:.1f} s | "
          f"{card}", flush=True)
    return total


def phase_oracle(tmp):
    """Small chains on the card against tests/oracle (numpy Metal
    semantics; tolerance 2 LSB as in the repo's golden tests)."""
    import importlib.util
    import types

    import numpy as np

    from tpuvf_torch.core.frame import host_to_planes
    from tpuvf_torch.core.spec import FrameSpec
    from tpuvf_torch.core.formats import VideoFormat

    def oracle(name, metal_ref=None):
        """tests/oracle/<name>, loaded by path: another installed "tests"
        may shadow it.  element_ref imports metal_ref from the package, so
        that import is given the one loaded here."""
        path = Path(__file__).resolve().parent / "tests" / "oracle" / name
        spec_ = importlib.util.spec_from_file_location(path.stem, path)
        mod = importlib.util.module_from_spec(spec_)
        shim = {}
        if metal_ref is not None:
            pkg = types.ModuleType("tests.oracle")
            pkg.__path__, pkg.metal_ref = [], metal_ref
            root = types.ModuleType("tests")
            root.__path__, root.oracle = [], pkg
            shim = {"tests": root, "tests.oracle": pkg,
                    "tests.oracle.metal_ref": metal_ref}
        saved = {k: sys.modules.get(k) for k in shim}
        sys.modules.update(shim)
        try:
            spec_.loader.exec_module(mod)
        finally:
            for k, v in saved.items():
                if v is None:
                    sys.modules.pop(k, None)
                else:
                    sys.modules[k] = v
        return mod

    metal_ref, filter_ref = oracle("metal_ref.py"), oracle("filter_ref.py")
    element_ref = oracle("element_ref.py", metal_ref)
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
    pipe = fed_pipeline(desc, {"appsrc0": frames}, "cuda")
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
    pipe = fed_pipeline(desc, {"appsrc0": frames}, "cuda")
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

    # tests/test_compositor.py's golden two-input OVER on the card
    rng = np.random.default_rng(8)
    base = rng.integers(0, 256, (24, 32, 4), dtype=np.uint8)
    top = nv12_frames(1, 24, 16, seed=9)[0]
    desc = ("vfmetalcompositor name=c background=checker sink_1::xpos=16 "
            "sink_1::ypos=8 sink_1::alpha=0.6 ! video/x-raw,format=BGRA "
            "! appsink appsrc name=s0 format=BGRA width=32 height=24 "
            "! c.sink_0 appsrc name=s1 format=NV12 width=24 height=16 "
            "! c.sink_1")
    pipe = fed_pipeline(desc, {"s0": [base], "s1": [top]}, "cuda")
    pipe.run()
    out_spec = FrameSpec(VideoFormat.BGRA, 40, 24)
    dst = metal_ref.dequant(metal_ref.quant(element_ref.checker_bg(40, 24)))
    for planes, fmt, x, y, pw, ph, alpha in (
            (host_to_planes(base, FrameSpec(VideoFormat.BGRA, 32, 24)),
             "BGRA", 0, 0, 32, 24, 1.0),
            (host_to_planes(top, FrameSpec(VideoFormat.NV12, 24, 16)),
             "NV12", 16, 8, 24, 16, 0.6)):
        dst = element_ref.composite_draw(dst, planes, fmt, 0, x, y, pw, ph,
                                         alpha, 1)
    want = metal_ref.pack_rgba(metal_ref.quant(dst).transpose(2, 0, 1),
                               "BGRA", 0)
    compare("BGRA 32x24 + NV12 24x16 at (16, 8) alpha 0.6 over checker -> "
            "BGRA 40x24", host_to_planes(pipe["appsink0"].frames[0],
                                         out_spec), want)

    # tests/test_deinterlace.py's greedy-H golden case: two NV12 frames, the
    # second still on its top half (weave) and new below (bob)
    dw, dh = 32, 24
    spec = FrameSpec(VideoFormat.NV12, dw, dh)
    fields = nv12_frames(2, dw, dh, seed=10)
    fields[1]["y"][:12], fields[1]["uv"][:6] = (fields[0]["y"][:12],
                                                fields[0]["uv"][:6])
    desc = (f"appsrc format=NV12 width={dw} height={dh} ! vfmetaldeinterlace "
            f"method=greedyh motion-threshold=0.25 ! appsink")
    pipe = fed_pipeline(desc, {"appsrc0": fields}, "cuda")
    pipe.run()
    prev_q = None
    for i, host in enumerate(fields):
        cur_q = metal_ref.quant(metal_ref.sample_rgba(
            host_to_planes(host, spec), "NV12", spec.matrix_index, dw, dh,
            filt="nearest"))
        cur = metal_ref.dequant(cur_q)
        prev = (np.zeros_like(cur) if prev_q is None
                else metal_ref.dequant(prev_q))
        out = element_ref.deinterlace(cur, prev, 3, True, 0.25,
                                      has_prev=prev_q is not None)
        want = metal_ref.pack_rgba(metal_ref.quant(out).transpose(2, 0, 1),
                                   "NV12", spec.matrix_index)
        compare(f"NV12 {dw}x{dh} greedy-H threshold 0.25, frame {i}",
                host_to_planes(pipe["appsink0"].frames[i], spec), want)
        prev_q = cur_q

    # tests/test_transform_overlay.py's golden cases: an NV12 transform
    # clockwise with crops, and a PNG overlay on NV12
    tw, th = 48, 32
    spec = FrameSpec(VideoFormat.NV12, tw, th)
    frame = nv12_frames(1, tw, th, seed=11)
    planes = host_to_planes(frame[0], spec)
    desc = (f"appsrc format=NV12 width={tw} height={th} ! vfmetaltransform "
            f"method=clockwise crop-left=4 crop-top=2 ! appsink")
    pipe = fed_pipeline(desc, {"appsrc0": frame}, "cuda")
    pipe.run()
    want = metal_ref.pack_rgba(element_ref.transform(
        planes, "NV12", spec.matrix_index, tw, th, 1, 4, 0, 2, 0), "NV12",
        spec.matrix_index)
    compare(f"NV12 {tw}x{th} clockwise, crop-left 4, crop-top 2",
            host_to_planes(pipe["appsink0"].frames[0], spec), want)

    from tpuvf_torch.io import png

    art = np.random.default_rng(12).integers(0, 256, (12, 16, 4),
                                             dtype=np.uint8)
    art[..., 3] = 200
    path = write_png(Path(tmp) / "oracle-ov.png", art)
    desc = (f"appsrc format=NV12 width={tw} height={th} ! vfmetaloverlay "
            f"location={path} x=8 y=4 alpha=0.7 ! appsink")
    pipe = fed_pipeline(desc, {"appsrc0": frame}, "cuda")
    pipe.run()
    video = metal_ref.sample_rgba(planes, "NV12", spec.matrix_index, tw, th)
    out = element_ref.overlay(video, png.decode_premultiplied(
        Path(path).read_bytes()), 8, 4, 16, 12, 0.7)
    want = metal_ref.pack_rgba(metal_ref.quant(out).transpose(2, 0, 1),
                               "NV12", spec.matrix_index)
    compare(f"NV12 {tw}x{th} + 16x12 PNG at (8, 4) alpha 0.7",
            host_to_planes(pipe["appsink0"].frames[0], spec), want)


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
    ("K4", "composite_fold (K4)", "tpuvf_torch/csrc/composite.cu",
     "scripts/bench_comp_pallas.py:163"),
    ("K5", "deinterlace_yuv420_u8/deinterlace_u8 (K5)",
     "tpuvf_torch/csrc/deinterlace.cu", "tpuvf/kernels/deinterlace.py:135"),
    ("K6", "overlay_yuv420_u8/overlay_blend_u8 (K6)",
     "tpuvf_torch/csrc/overlay.cu", "tpuvf/elements/overlay.py:595"),
)
# Device time (us, torch.profiler self time) of each kernel at its JSON
# shape, and of K2 at chain (b)'s RGBA shape, before the redesigns of K3 and
# K4, and where it was measured: this script's phase 3 on the kernels of
# commit d03551a (PERF.md section 6).  K5 and K6 are held instead to the
# launches their fused routes replace, timed in this run (phase 3).
BEFORE_CALL = "kernels of d03551a, NVIDIA H100 80GB HBM3, 700.00 W"
BEFORE_US = {"K1": 20.1, "K1b": 37.3, "K2": 39.8, "K3": 62.6, "K4": 88.3,
             "K2 4K RGBA u8, b/c/s (chain (b)'s vfvideofilter)": 31.4}


def host_steps() -> int:
    """--host-steps: the host side of the main paths alone, to compare two
    checkouts in one call (run this script from the root of each, in
    turns).  Per chain the step's host-clock time with the inputs on the
    card and Pipeline.run's fps, then the host's enqueue time per call of
    K2's and the K1/K1b sampler's wrappers at chain (a)'s shapes, where the
    device keeps up.  No CPU run, no profiler, except one window at the end
    to show what a profiler session does to the host step after it."""
    import torch

    from tpuvf_torch.kernels import convert, emit, sample

    phase_card()
    phase_build()
    with tempfile.TemporaryDirectory() as tmp:
        paths = main_paths(tmp)
        for label, desc, feeds, _, _, *tffs in paths:
            pipe = fed_pipeline(desc, feeds, "cuda", *tffs)
            pipe.run()
            inputs = pipe.upload_sources({k: v[0] for k, v in feeds.items()})
            state = pipe.state

            def step(pipe=pipe, inputs=inputs, state=state):
                return pipe.step_sources(inputs, state, pipe.params())

            fps, edge = run_fps(pipe)
            eager_us, graph_us, _, _ = graph_step_us(pipe)
            print(f"[host] {label}: step {host_us(step):.1f} us "
                  f"(step_sources); the compiled body eager "
                  f"{eager_us:.1f} us, with the graph {graph_us:.1f} us "
                  f"(host clock, median of 5 x 20) | "
                  f"Pipeline.run {fps:.2f} fps | {edge_text(edge)}",
                  flush=True)
            if label.startswith("(a)"):
                first = step
    gen = torch.Generator(device="cuda").manual_seed(7)
    enqueue = [(f"K2 enqueue, 640x480 {kind} b/c/s", emit.emit,
                emit_args(kind, 480, 640, False, "b/c/s", 0, False, gen))
               for kind in ("yuv_f32", "rgba_u8")]
    luma = torch.randint(0, 256, (1080, 1920), generator=gen, device="cuda",
                         dtype=torch.uint8)
    enqueue.append(("K1 + K1b enqueue, luma 1920x1080 -> 640x480",
                    convert.plan_plane_sampler(1920, 1080, 640, 480,
                                               sample.LINEAR, 1.0, 1.0,
                                               "cuda"), (luma,)))
    for label, fn, args in enqueue:
        us = host_us(lambda: fn(*args), 200, sync=False)
        print(f"[host] {label}: {us:.1f} us a call", flush=True)
    before = host_us(first)
    device_breakdown(first)
    print(f"[host] (a) step {before:.1f} us, after one torch.profiler window "
          f"{host_us(first):.1f} us", flush=True)
    return 0


def main(argv) -> int:
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this check needs a card")
    try:
        import tpuvf_torch  # noqa: F401
    except ImportError as exc:
        fail(f"run from the root of a tpuvf checkout ({exc})")
    if argv == ["--host-steps"]:
        return host_steps()
    if argv == ["--mesh"]:
        card = phase_card()
        phase_build()
        with tempfile.TemporaryDirectory() as tmp:
            phase_mesh(tmp, card)
        return 0
    if argv == ["--compiled"]:
        card = phase_card()
        phase_build()
        with tempfile.TemporaryDirectory() as tmp:
            phase_composite({}, tmp)
            phase_compiled(tmp, card)
            phase_batch_graphs(tmp, card)
        return 0
    if argv:
        fail(f"unknown arguments {argv} (none, --host-steps, --mesh or "
             f"--compiled)")
    t0 = time.perf_counter()
    card = phase_card()
    phase_build()
    summary = {}
    phase_resample(summary)
    phase_emit(summary)
    phase_deinterlace(summary)
    with tempfile.TemporaryDirectory() as tmp:
        phase_lut(summary, tmp)
        phase_composite(summary, tmp)
        phase_overlay(summary, tmp)
        launches = phase_chains(tmp)
        for k, v in phase_file_chains(tmp).items():
            launches[k] += v
        for k, v in phase_controllers(card).items():
            launches[k] += v
        for k, v in phase_mesh(tmp, card).items():
            launches[k] += v
        for k, v in phase_compiled(tmp, card).items():
            launches[k] += v
        for k, v in phase_batch_graphs(tmp, card).items():
            launches[k] += v
        phase_oracle(tmp)
    kernels = []
    for label, name, source, replaces in KERNELS:
        s = summary[label]
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches[label],
            "max_abs_err": s["max_abs_err"], "ms": s["ms"],
            "plain_ms": s["plain_ms"], "bound_ms": s["bound_us"] / 1e3,
            "bound_by": s["bound_by"], "library_ms": s["library_ms"],
            "device_us": s["device_us"], "bound_us": s["bound_us"]})
        before = BEFORE_US.get(label)
        was = (f"before {before:.1f} us ({BEFORE_CALL}), "
               f"{s['bound_us'] / before:.0%} of the bound -> "
               if before else "")
        if "replaced_us" in s:
            was = (f"replaces launches of {s['replaced_us']:.1f} us device "
                   f"(the parent's route, this run) -> ")
        lib = s.get("library_device_us")
        print(f"[roofline] {label} {name}: {was}device {s['device_us']:.1f} "
              f"us, bound {s['bound_us']:.1f} us ({s['moved_mb']:.1f} MB "
              f"at {HBM_BYTES_PER_S / 1e12:.2f} TB/s), "
              f"{s['bound_us'] / s['device_us']:.0%} of the bound | "
              f"library call: "
              + (f"{lib:.1f} us device" if lib else "none")
              + f" | main-path launches {launches[label]}", flush=True)
    print(f"chip_smoke: all phases passed in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main(sys.argv[1:]))
    except Exception:  # noqa: BLE001 - any failure must exit non-zero
        traceback.print_exc()
        print("chip_smoke: FAIL: unexpected error (traceback above)",
              flush=True)
        sys.exit(1)
