"""Chain (a), NV12 1080p -> vfconvertscale -> BGRA 640x480 -> b/c/s
(``vfbench`` cell ``cs480-batch32``), on the CPU at NV12 96x54 -> BGRA
32x24: the cell's own ratios, 3:1 across and 2.25:1 down on luma, 1.5:1 and
1.125:1 on chroma, so every plane is scaled down as at full size.

- The program against the benchmark's plain torch reference
  (``vfbench/references/convert_scale_filter.py``): a whole run of the cell
  (``vfbench.harness.run_cell``) under the cell's traffic in batches of 4,
  and a batch-of-one ``Pipeline.run``; every frame crosses the link.
- The control (the reference in bfloat16 in the program's place) and the
  faults planted under the timed path come out not correct.
- The reference against an independent float64 numpy model (the Metal
  linear sampler, BT.709, b/c/s): within 1 LSB at vfconvertscale's output,
  2 after b/c/s; the same model with the
  sampler's centres shifted by half a texel is not correct against the
  program.
- The scaler's roofline reader: its bytes on the configuration's shapes and
  its share on a made-up trace.

The tests marked ``card`` need a CUDA card and skip without one (run them
on the card with ``python -m pytest --noconftest -m card
tests/test_torch_cs480.py``): the batch readback (one raw call and one
event for each chunk of a batch's copies, ``Pipeline._readback_batch``)
of `run_batched` over the cells' launches at full size, chain (a) in
batches of 32 and BASELINE config 5 in batches of 8, from a pool of 12
frames a source (so that neighbouring batches differ), byte for byte the
same run read back frame by frame (torch's copies and an event a frame,
``Pipeline._readback``); with the raw copies pointed at the other output
set, frames come out wrong.
"""

import hashlib
import json
import re
import sys
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from tpuvf_torch.runtime import pipeline as pipeline_module
from vfbench import calibrate, check, faults, harness, inputs, roofline, spec
from vfbench.reference import Reference

SEEDS = (2**33 + 23, 7)  # one wider than 32 bits
SMALL = {1920: 96, 1080: 54, 640: 32, 480: 24}
# limited-range YUV -> RGB, GStreamer's default colorimetry by height
BT601 = ((1.164383, 0.0, 1.596027),
         (1.164383, -0.391762, -0.812968),
         (1.164383, 2.017232, 0.0))
BT709 = ((1.164383, 0.0, 1.792741),
         (1.164383, -0.213249, -0.532909),
         (1.164383, 2.112402, 0.0))
CONFIG = spec.HERE / "configs" / "convert_scale_480p.json"


def full_config() -> dict:
    with open(CONFIG) as fh:
        return json.load(fh)


def small_cell(batch_size: int = 4) -> spec.Cell:
    """The cell at NV12 96x54 -> BGRA 32x24, under the `batch32` mix in
    batches of `batch_size`."""
    cfg = full_config()
    cfg["launch"] = re.sub(r"\b(width|height)=(\d+)",
                           lambda m: f"{m[1]}={SMALL[int(m[2])]}",
                           cfg["launch"])
    ref = cfg["reference"]
    for d in (ref["sources"]["s0"], ref["output"]):
        d["width"], d["height"] = SMALL[d["width"]], SMALL[d["height"]]
    with open(spec.traffic_path("batch32")) as fh:
        trf = json.load(fh)
    trf["batch_size"] = batch_size
    return spec.Cell("cs480.small", 1, cfg, trf, [], [])


@pytest.fixture
def threads():
    """`run_cell` sets the traffic's host threads; give the worker back its
    own count."""
    n = torch.get_num_threads()
    yield
    torch.set_num_threads(n)


def run_frames(cell, seed: int, n: int = 12):
    """A batch-of-one `run` of n frames through the harness's pipeline ->
    ({frame: output bytes}, the pool, the pipeline's stats)."""
    pipe, pool = harness.build(cell, seed, torch.device("cpu"), "")
    harness.feed(pipe, pool, n)
    out = cell.config["reference"]["output"]
    keep = {k: np.zeros((out["height"], out["width"], 4), np.uint8)
            for k in range(n)}
    pipe["out"].arm(n, keep)
    assert pipe.run(n) == n
    return keep, pool, pipe.stats


# -- the program against the reference ---------------------------------------

@pytest.mark.parametrize("seed", SEEDS)
def test_cs480_batched_matches_the_reference(seed, threads):
    r = harness.run_cell(small_cell(), seed, 0.3, False, "cpu")
    assert r["correct"], r["check"]
    assert r["check"]["missing"]["value"] == 0
    assert r["check"]["max_lsb"]["value"] <= 1
    assert r["check_frames"] >= 8 and r["failed"] == 0


@pytest.mark.parametrize("seed", SEEDS)
def test_cs480_run_matches_the_reference(seed, threads):
    cell = small_cell()
    ref = cell.config["reference"]
    keep, pool, stats = run_frames(cell, seed)
    assert stats.upload_direct + stats.upload_filled == len(keep)
    tally = check.Tally()
    for k, got in keep.items():
        want = Reference().frame(ref, {"s0": pool["s0"][k % 8]}, {})
        tally.add(*check.compare(got, want))
    correct, numbers = check.judge(tally.numbers(), cell.config["limits"])
    assert correct and numbers["max_lsb"]["value"] <= 1, numbers


def test_cs480_every_batch_row_crosses_the_link(threads):
    """Under the cell's pool of 8 and batches of 4 no row is ever left
    holding its buffer: every frame of a call is uploaded."""
    cell = small_cell()
    pipe, pool = harness.build(cell, SEEDS[0], torch.device("cpu"), "")
    harness.feed(pipe, pool, 16)
    pipe.run_batched(16, batch_size=4)
    st = pipe.stats
    before = st.upload_direct + st.upload_filled
    harness.feed(pipe, pool, 40)
    pipe["out"].arm(40, {})
    assert pipe.run_batched(40, batch_size=4) == 40
    assert st.upload_direct + st.upload_filled - before == 40


def test_cs480_control_is_not_correct():
    r = calibrate.control(small_cell(), SEEDS[0], 0.3, "cpu",
                          dtype=torch.bfloat16, fps_guess=200.0)
    assert not r["correct"]
    assert r["check"]["diff_ppm"]["value"] > r["check"]["diff_ppm"]["limit"]


@pytest.mark.parametrize("fault", sorted(faults.FAULTS))
def test_cs480_fault_is_not_correct(monkeypatch, fault, threads):
    faults.plant(fault, monkeypatch.setattr)
    r = harness.run_cell(small_cell(), SEEDS[0], 0.3, False, "cpu")
    assert not r["correct"], (fault, r["check"])


# -- the reference against an independent model --------------------------------

def _axis(n_out: int, n_in: int, shift: float) -> np.ndarray:
    """The Metal linear sampler along one axis as a dense float64 matrix:
    half-texel centres (moved by `shift` texels), clamp to edge."""
    s = (np.arange(n_out) + 0.5) * n_in / n_out - 0.5 + shift
    i0 = np.floor(s).astype(int)
    f = s - i0
    m = np.zeros((n_out, n_in))
    np.add.at(m, (np.arange(n_out), np.clip(i0, 0, n_in - 1)), 1 - f)
    np.add.at(m, (np.arange(n_out), np.clip(i0 + 1, 0, n_in - 1)), f)
    return m


def model(frame: dict, ref: dict, shift: float = 0.0) -> np.ndarray:
    """Chain (a) in float64 numpy: each plane sampled at the output's
    centres, BT.709 (BT.601 at 576 lines or fewer) limited range, the RGBA8
    target, b/c/s, BGRA bytes."""
    out = ref["output"]
    matrix = BT709 if ref["sources"]["s0"]["height"] > 576 else BT601
    w, h = out["width"], out["height"]

    def sample(p):
        p = np.asarray(p, np.float64) / 255.0
        return _axis(h, p.shape[0], shift) @ p @ _axis(w, p.shape[1],
                                                       shift).T

    y, u, v = (sample(p) for p in (frame["y"], frame["uv"][:, 0::2],
                                   frame["uv"][:, 1::2]))
    yuv = (y - 16 / 255, u - 128 / 255, v - 128 / 255)
    rgb = [np.clip(sum(c * x for c, x in zip(row, yuv)), 0, 1) for row in matrix]
    rgb = [np.round(x * 255) / 255 for x in rgb]  # the RGBA8 target
    f = ref["filter"]
    rgb = [(x + f["brightness"] - 0.5) * f["contrast"] + 0.5 for x in rgb]
    lum = 0.2126 * rgb[0] + 0.7152 * rgb[1] + 0.0722 * rgb[2]
    rgb = [np.clip(lum + (x - lum) * f["saturation"], 0.0001, 1.0)
           for x in rgb]
    r, g, b = (np.round(x * 255).astype(np.uint8) for x in rgb)
    return np.stack([b, g, r, np.full_like(r, 255)], -1)


IDENTITY = {"brightness": 0.0, "contrast": 1.0, "saturation": 1.0}


@pytest.mark.parametrize("stage,lsb", [("convert", 1), ("filter", 2)])
@pytest.mark.parametrize("size", ["full", "small"])
@pytest.mark.parametrize("seed", SEEDS)
def test_reference_agrees_with_a_float64_model(seed, size, stage, lsb):
    """At the published 1080p -> 640x480 (BT.709) one frame, at the small
    size (BT.601) four.  vfconvertscale's RGBA8 output alone (the filter at
    identity) agrees within 1 LSB.  Through b/c/s a byte of that output that
    float32 and float64 round to neighbouring values is scaled by contrast
    and saturation, and the last quantization can then differ by 2."""
    ref = (full_config() if size == "full"
           else small_cell().config)["reference"]
    values = IDENTITY if stage == "convert" else {}
    ref_model = dict(ref, filter=dict(ref["filter"], **values))
    pool = inputs.frame_pool(ref["sources"], 1 if size == "full" else 4,
                             seed, "cpu")
    for frame in pool["s0"]:
        want = Reference().frame(ref, {"s0": frame}, values).numpy()
        d = np.abs(model(frame, ref_model).astype(int) - want.astype(int))
        assert d.max() <= lsb


@pytest.mark.parametrize("shift,correct", [(0.0, True), (0.5, False)])
def test_a_half_texel_shift_is_not_correct(shift, correct, threads):
    cell = small_cell()
    ref = cell.config["reference"]
    keep, pool, _ = run_frames(cell, SEEDS[0], n=8)
    tally = check.Tally()
    for k, got in keep.items():
        want = torch.from_numpy(model(pool["s0"][k % 8], ref, shift))
        tally.add(*check.compare(got, want))
    ok, numbers = check.judge(tally.numbers(), cell.config["limits"])
    assert ok == correct, numbers


# -- the scaler's roofline reader -------------------------------------------------

SCALE_BYTES = (4 * (1920 * 1080 + 2 * 960 * 540)  # each source plane, float32
               + 3 * 640 * 480 * 4)  # Y, U and V sampled, float32


def test_scale_bytes_of_chain_a():
    ref = full_config()["reference"]
    # the link's bytes a frame: NV12 1080p in, BGRA 640x480 out
    assert roofline.bytes_per_frame(ref) == 3_110_400 + 1_228_800
    scale = spec.load_reader("scale_roofline_pct.batch")
    assert scale.scale_bytes(ref) == SCALE_BYTES
    assert SCALE_BYTES == 16_128_000
    with open(spec.HERE / "configs" / "convert_filter_4k.json") as fh:
        assert scale.scale_bytes(json.load(fh)["reference"]) is None


def test_scale_roofline_pct_on_a_synthetic_reduction(monkeypatch):
    read = spec.load_reader("scale_roofline_pct.batch").read
    monkeypatch.setattr(sys, "argv", ["vfbench.run", "--workload",
                                      "cs480-batch32", "--seed", "3"])
    least_s = SCALE_BYTES / 3.35e12  # 4.8 us

    def ctx(ops, frames=32, peak=3.35e12):
        return SimpleNamespace(frames=frames, peak_bytes_s=peak,
                               trace=None if ops is None
                               else {"device_ops": ops})

    ops = [["Memcpy HtoD (Pinned -> Device)", 1.0],
           ["void (anonymous namespace)::resample_rows_kernel<true>(...)",
            32 * least_s],
           ["void (anonymous namespace)::resample_cols_kernel<true, true>()",
            3 * 32 * least_s]]
    assert read(ctx(ops)) == pytest.approx(25.0)
    assert read(ctx(ops[:1])) is None  # neither kernel ran
    assert read(ctx(ops, peak=None)) is None  # a card not in the table
    assert read(ctx(None)) is None  # no trace
    assert read(ctx(ops, frames=0)) is None
    # a cell that scales nothing, and a process that names no cell
    monkeypatch.setattr(sys, "argv", ["x", "--workload", "cf4k-batch"])
    assert read(ctx(ops)) is None
    monkeypatch.setattr(sys, "argv", ["pytest"])
    assert read(ctx(ops)) is None


# -- the batch readback on the card --------------------------------------------


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


def _digests(workload, batch_size, tmp_path, patch=None, frames=6):
    """`run_batched` of `frames` batches of the cell's launch on the card,
    its sources fed from a pool of 12, `patch(pipe)` first where given ->
    (each frame's digest, the pipeline's stats, a frame's bytes)."""
    cell = spec.load_cell(spec.HERE.parent, workload)
    cell.traffic = dict(cell.traffic, pool=12)
    pipe, pool = harness.build(cell, SEEDS[0], torch.device("cuda"),
                               str(tmp_path))
    n = frames * batch_size
    harness.feed(pipe, pool, n)
    out = pipe["out"]
    digests = []

    def deliver(payload, spec_, k):
        digests.append(hashlib.blake2b(np.ascontiguousarray(payload),
                                       digest_size=16).digest())

    out.deliver = deliver
    if patch is not None:
        patch(pipe)
    assert pipe.run_batched(n, batch_size=batch_size) == n
    return digests, pipe.stats, pipe._rings[out.name][0].nbytes


def _frame_by_frame(monkeypatch):
    """-> a patch: every batch read back frame by frame (``Pipeline.
    _readback``: torch's copies, an event a frame)."""

    def patch(pipe):
        def readback_batch(outs, first, base, retries, stream):
            return [pipe._readback(payloads, first + j, base + j, retries[j])
                    for j, payloads in enumerate(outs)]

        monkeypatch.setattr(pipe, "_readback_batch", readback_batch)

    return patch


def _other_set(monkeypatch):
    """-> a patch: each raw copy of a replayed batch's piece reads the
    same piece of the key's other output set, where it has been
    captured."""

    def patch(pipe):
        real = pipeline_module.copy_d2h

        def copy_d2h(copies, stream):
            swap = {}
            for entry in pipe.compiled._batches.values():
                if len(entry.sets) == 2:
                    a, b = ([p for payloads in entry.sets[t][1][0]
                             for _, _, pieces in payloads for p in pieces]
                            for t in (0, 1))
                    for x, y in zip(a, b):
                        swap[x.data_ptr()], swap[y.data_ptr()] = y, x
            real([(v, swap.get(p.data_ptr(), p)) for v, p in copies], stream)

        monkeypatch.setattr(pipeline_module, "copy_d2h", copy_d2h)

    return patch


@pytest.mark.card
@pytest.mark.parametrize("readback", ["as built", "the other output set"])
@pytest.mark.parametrize("workload,batch_size",
                         [("cs480-batch32", 32), ("comp4k-batch", 8)])
def test_the_batch_readback_equals_frame_by_frame_on_the_card(
        card, monkeypatch, tmp_path, workload, batch_size, readback):
    """The first batch runs eagerly, every later one replays its key's
    graph; each is read back by raw calls and an event a chunk
    (`Pipeline.READBACK_CHUNK`: 7 frames of 1.2 MB, or each 33 MB frame
    alone), equal to frame by frame.  With the raw copies pointed at the
    other output set's pieces (the batch before's, or the next one's),
    frames differ."""
    want, ref_stats, _ = _digests(workload, batch_size, tmp_path,
                                  _frame_by_frame(monkeypatch))
    got, stats, size = _digests(workload, batch_size, tmp_path,
                                None if readback == "as built"
                                else _other_set(monkeypatch))
    assert ref_stats.readback_events == 0
    per = -(-pipeline_module.Pipeline.READBACK_CHUNK // size)
    assert stats.readback_events == 6 * -(-batch_size // per)
    assert len(set(want[:12])) == 12  # every pool frame differs
    assert len(got) == len(want) == 6 * batch_size
    wrong = [i for i, (a, b) in enumerate(zip(got, want)) if a != b]
    if readback == "as built":
        assert not wrong, f"{len(wrong)} of {len(got)} frames wrong: {wrong}"
    else:
        assert wrong
