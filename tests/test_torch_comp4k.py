"""BASELINE config 5, the four-pad 4K compositor (``vfbench`` cell
``comp4k-batch``), on the CPU.

- The program against the benchmark's plain torch reference
  (``vfbench/references/compositor.py``): a whole run of the cell
  (``vfbench.harness.run_cell``, the harness's own set-up, window and check)
  at a twentieth of the size (``vfbench/tests/small.py``), three seeds.
- A fault planted under the timed path (``vfbench/faults.py`` ``slot``: one
  batch slot altered) turns the run's ``correct`` false.
- The compositor's host work has spans of its own: each frame's
  ``_frame_tables`` is ``tpuvf_torch.params.tables`` and each frame's
  ``_select_buffers`` ``tpuvf_torch.params.select``, both inside
  ``tpuvf_torch.params``, the frame index in their args, neither adding to
  ``step`` beyond ``params``; a chain without a compositor leaves
  ``params.tables`` at 0.
- The readers of the cell's new per-layer metrics on made-up contexts, and
  K4's bytes on config 5's shapes.
"""

import json
from types import SimpleNamespace

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from tpuvf_torch.cli.launch import parse_pipeline
from tpuvf_torch.parallel.mesh import make_mesh
from tpuvf_torch.runtime.observability import EDGE_PARTS
from vfbench import faults, harness, spec
from vfbench.tests import small

torch.set_num_threads(1)

SEEDS = (2**33 + 17, 1, 2**31 + 5)  # one wider than 32 bits
PREFIX = "tpuvf_torch."
# four pads of two formats over a checker, an overlay folded into K4
COMP = ("vfmetalcompositor name=c background=checker sink_1::xpos=16 "
        "sink_1::ypos=8 sink_2::alpha=0.7 sink_3::operator=add "
        "sink_3::xpos=24 sink_3::ypos=12 ! video/x-raw,format=BGRA,width=48,"
        "height=32 ! vfmetaloverlay location={png} x=4 y=4 ! fakesink "
        "videotestsrc num-buffers=8 pattern=ball ! video/x-raw,format=BGRA,"
        "width=48,height=32 ! c.sink_0 "
        "videotestsrc num-buffers=8 ! video/x-raw,format=NV12,width=24,"
        "height=16 ! c.sink_1 "
        "videotestsrc num-buffers=8 pattern=snow ! video/x-raw,format=BGRA,"
        "width=16,height=12 ! c.sink_2 "
        "videotestsrc num-buffers=8 pattern=ball ! video/x-raw,format=NV12,"
        "width=16,height=12 ! c.sink_3")
PLAIN = ("videotestsrc num-buffers=8 pattern=ball ! "
         "video/x-raw,format=NV12,width=40,height=24 ! vfmetalconvertscale ! "
         "video/x-raw,format=BGRA,width=40,height=24 ! "
         "vfmetalvideofilter brightness=0.1 ! fakesink")
LOOPS = ("run", "run_batched", "mesh")


@pytest.fixture
def threads():
    """`run_cell` sets the traffic's host threads; give the worker back its
    own count."""
    n = torch.get_num_threads()
    yield
    torch.set_num_threads(n)


def run_cell(seed):
    return harness.run_cell(small.cell("compositor_4k", "batch8"), seed, 0.3,
                            False, "cpu")


# -- the program against the reference ---------------------------------------

@pytest.mark.parametrize("seed", SEEDS)
def test_comp4k_batch_matches_the_reference(seed, threads):
    r = run_cell(seed)
    assert r["correct"], r["check"]
    assert r["check"]["missing"]["value"] == 0
    assert r["check"]["max_lsb"]["value"] <= 2
    assert r["check_frames"] >= 8 and r["failed"] == 0


def test_comp4k_batch_one_slot_altered_is_not_correct(monkeypatch, threads):
    faults.plant("slot", monkeypatch.setattr)
    r = run_cell(SEEDS[0])
    assert not r["correct"]
    assert r["check"]["max_lsb"]["value"] > r["check"]["max_lsb"]["limit"]


# -- the compositor's spans ---------------------------------------------------

def _drive(desc, loop, tmp_path):
    """-> (a fresh pipeline of `desc`, its call of `loop` over 8 frames)."""
    from vfbench import inputs

    png = tmp_path / "o.png"
    inputs.write_png(png, inputs.overlay_image(
        {"width": 8, "height": 8, "rgba": [255, 0, 0, 128]}))
    pipe = parse_pipeline(desc.format(png=png), device="cpu")
    if loop == "run":
        return pipe, lambda: pipe.run(8)
    if loop == "run_batched":
        return pipe, lambda: pipe.run_batched(8, batch_size=4)
    mesh = make_mesh({"dp": 2}, devices=["cpu"] * 2)
    return pipe, lambda: pipe.run_batched(8, batch_size=4, mesh=mesh)


@pytest.mark.parametrize("loop", LOOPS)
def test_compositor_spans_feed_tables_and_select(loop, tmp_path):
    pipe, go = _drive(COMP, loop, tmp_path)
    assert go() == 8
    edge = pipe.stats.edge_seconds
    assert set(edge) == set(EDGE_PARTS)
    assert edge["params.tables"] > 0 and edge["params.select"] > 0
    assert edge["params"] > edge["params.tables"] + edge["params.select"]
    assert edge["step"] == pytest.approx(edge["params"] + edge["enqueue"],
                                         rel=1e-9)


@pytest.mark.parametrize("loop", LOOPS)
def test_compositor_spans_nest_in_params_with_the_frame(loop, tmp_path,
                                                        monkeypatch):
    pipe, go = _drive(COMP, loop, tmp_path)
    go()
    real, args = torch.profiler.record_function, {}

    def recording(name, arg=None):
        args.setdefault(name[len(PREFIX):], []).append(arg)
        return real(name, arg)

    monkeypatch.setattr(torch.profiler, "record_function", recording)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        assert go() == 8
    for part in ("params.tables", "params.select"):
        assert sorted(args[part], key=int) == [str(i) for i in range(8)]
    spans = {}
    for e in prof.profiler.kineto_results.events():
        if e.name().startswith(PREFIX):
            a = e.start_ns()
            spans.setdefault(e.name()[len(PREFIX):], []).append(
                (a, a + e.duration_ns()))
    for part in ("params.tables", "params.select"):
        assert len(spans[part]) == 8, part  # one a frame
        for a, b in spans[part]:
            assert any(pa <= a and b <= pb for pa, pb in spans["params"])


def test_a_chain_without_a_compositor_leaves_tables_at_zero(tmp_path):
    pipe, go = _drive(PLAIN, "run_batched", tmp_path)
    assert go() == 8
    edge = pipe.stats.edge_seconds
    assert edge["params.tables"] == 0 and edge["params.select"] > 0


# -- the cell's readers --------------------------------------------------------

def _ctx(frames=8, edge=None, ops=None, peak=3.35e12):
    edge = dict.fromkeys(EDGE_PARTS, 0.0) if edge is None else edge
    trace = None if ops is None else {"device_ops": ops}
    return SimpleNamespace(frames=frames, edge=edge, trace=trace,
                           peak_bytes_s=peak)


@pytest.mark.parametrize("metric,part", [("tables_ms.batch", "params.tables"),
                                         ("select_ms.batch", "params.select")])
def test_params_part_readers(metric, part):
    read = spec.load_reader(metric).read
    edge = dict.fromkeys(EDGE_PARTS, 0.0)
    edge[part] = 0.004
    assert read(_ctx(edge=edge)) == pytest.approx(0.5)  # ms a frame
    assert read(_ctx(frames=0, edge=edge)) is None
    # a program without the span (the parent of the spans) reads nothing
    assert read(_ctx(edge={"params": 0.1, "step": 0.1})) is None


CONFIG5_FOLD_BYTES = (
    3840 * 2160 * 4  # the 4K BGRA pad at identity, uint8 RGBA
    + 1920 * 1080 * 16  # the 1080p NV12 pad after the emit, float32 RGBA
    + 1280 * 720 * 4  # the 720p BGRA pad, uint8 RGBA
    + 1280 * 720 * 16  # the 720p NV12 pad, float32 RGBA
    + 256 * 256 * 16  # the folded overlay's rect, float32 RGBA
    + 3840 * 2160 * 4)  # the canvas, written once


def test_fold_bytes_of_config_5():
    fold = spec.load_reader("fold_roofline_pct.batch")
    with open(spec.HERE / "configs" / "compositor_4k.json") as fh:
        ref = json.load(fh)["reference"]
    assert fold.fold_bytes(ref) == CONFIG5_FOLD_BYTES == 119_013_376
    # a pad placed half off the canvas is read over its clipped rect only
    moved = json.loads(json.dumps(ref))
    moved["pads"][1]["xpos"] = 2880
    assert fold.fold_bytes(ref) - fold.fold_bytes(moved) == 960 * 1080 * 16


def test_fold_roofline_pct_on_a_synthetic_reduction(monkeypatch):
    read = spec.load_reader("fold_roofline_pct.batch").read
    monkeypatch.setattr("sys.argv", ["vfbench.run", "--workload",
                                     "comp4k-batch", "--seed", "3"])
    least_s = CONFIG5_FOLD_BYTES / 3.35e12  # 35.5 us
    ops = [["Memcpy DtoH (Device -> Pinned)", 1.0],
           ["composite_fold_kernel(FoldParams, unsigned char*)",
            8 * 2 * least_s]]
    assert read(_ctx(ops=ops)) == pytest.approx(50.0)
    assert read(_ctx(ops=ops[:1])) is None  # K4 did not run
    assert read(_ctx(ops=ops, peak=None)) is None  # a card not in the table
    assert read(_ctx()) is None  # no trace
    assert read(_ctx(frames=0, ops=ops)) is None
    # a cell without pads, and a process that names no cell
    monkeypatch.setattr("sys.argv", ["x", "--workload", "cf4k-batch"])
    assert read(_ctx(ops=ops)) is None
    monkeypatch.setattr("sys.argv", ["pytest"])
    assert read(_ctx(ops=ops)) is None
