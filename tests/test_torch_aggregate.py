"""The port's multi-source runtime and named-pad CLI on the CPU: the
behaviours of tests/test_compositor.py's pipeline cases (pad properties,
forward pad references, timestamp-driven aggregation, EOS freeze,
ignore-inactive-pads, late start, moving pads without a rebuild) through
`parse_pipeline(..., device="cpu")`, appsrc's per-buffer pts, the keyed
upload/step calls, and one pipeline against tpuvf built under
TPUVF_NO_SPLIT_LINKS=1 (every boundary canonical, the dataflow the port
implements).

Tolerance against tpuvf: <= 1 LSB (its compiled fold may contract OVER into
an FMA; tests/test_torch_compositor.py).  Everything else is exact.
"""

import numpy as np
import pytest
import torch

from tpuvf.cli.launch import parse_pipeline as tpuvf_parse
from tpuvf_torch.cli.launch import (
    ParseError,
    launch,
    main as port_main,
    parse_pipeline,
)

torch.set_num_threads(1)

TWO_RATES = (
    "vfmetalcompositor name=c background=black {props} sink_1::xpos=32 "
    "! video/x-raw,format=RGBA,width=64,height=24 ! appsink "
    "videotestsrc num-buffers=4 pattern=ball "
    "! video/x-raw,format=RGBA,width=32,height=24,framerate={r0}/1 ! c.sink_0 "
    "videotestsrc num-buffers=2 {pattern} "
    "! video/x-raw,format=RGBA,width=32,height=24,framerate={r1}/1 ! c.sink_1 ")


def _run_collect(desc, n=None):
    pipe = parse_pipeline(desc, device="cpu")
    pipe.negotiate()
    pipe.build()
    pipe.run(n)
    return pipe, [f.copy() for f in pipe.sinks[0].frames]


def _two_rates(props="", r0=25, r1=25, pattern="pattern=snow"):
    return _run_collect(TWO_RATES.format(props=props, r0=r0, r1=r1,
                                         pattern=pattern))


def test_pipeline_string_two_inputs():
    n = launch(
        "vfmetalcompositor name=comp sink_1::xpos=32 sink_1::ypos=16 "
        "sink_1::alpha=0.5 ! video/x-raw,format=BGRA ! fakesink "
        "videotestsrc num-buffers=2 ! video/x-raw,format=BGRA,width=64,height=48 "
        "! comp.sink_0 "
        "videotestsrc num-buffers=2 pattern=snow "
        "! video/x-raw,format=NV12,width=32,height=24 ! comp.sink_1",
        device="cpu", quiet=True)
    assert n == 2


def test_pad_refs_both_directions_and_forward():
    """Sources link to pads of a compositor declared later; the compositor's
    src pad is a chain head (`c. ! ...`)."""
    pipe, frames = _run_collect(
        "videotestsrc num-buffers=1 pattern=red "
        "! video/x-raw,format=BGRA,width=32,height=24 ! c.sink_1 "
        "videotestsrc num-buffers=1 pattern=white "
        "! video/x-raw,format=RGBA,width=16,height=16 ! c.sink_0 "
        "vfmetalcompositor name=c background=black sink_1::xpos=16 "
        "c. ! video/x-raw,format=RGBA ! appsink")
    pads = {ln.upstream.name: ln.sink_pad for ln in pipe.links
            if ln.downstream is pipe["c"]}
    assert pads == {"videotestsrc0": "sink_1", "videotestsrc1": "sink_0"}
    (f,) = frames
    assert f.shape == (24, 48, 4)
    assert (f[:16, :16, :3] == 255).all()  # sink_0: white
    assert (f[:, 16:, 0] == 255).all() and (f[:, 16:, 1:3] == 0).all()
    assert (f[16:, :16, :3] == 0).all()  # black background


def test_unnamed_links_take_request_pad_names_in_order():
    pipe = parse_pipeline(
        "vfmetalcompositor name=c sink_0::xpos=8 ! fakesink "
        "videotestsrc num-buffers=1 ! video/x-raw,width=16,height=8 ! c. "
        "videotestsrc num-buffers=1 ! video/x-raw,width=16,height=8 ! c.",
        device="cpu")
    pipe.negotiate()
    assert [ln.sink_pad for ln in pipe.links if ln.downstream is pipe["c"]] \
        == ["sink_0", "sink_1"]
    assert pipe._outgoing(pipe["c"])[0].spec.width == 24


def test_pipeline_mixed_formats_and_yuv_output():
    pipe, frames = _run_collect(
        "vfmetalcompositor name=c background=white "
        "! video/x-raw,format=I420 ! appsink "
        "videotestsrc num-buffers=1 ! video/x-raw,format=BGRA,width=64,height=48 ! c.sink_0 "
        "videotestsrc num-buffers=1 ! video/x-raw,format=I420,width=32,height=24 ! c.sink_1")
    (f,) = frames
    assert {k: v.shape for k, v in f.items()} == {
        "y": (48, 64), "u": (24, 32), "v": (24, 32)}


def test_pipeline_compositor_then_chain():
    n = launch(
        "vfmetalcompositor name=c ! video/x-raw,format=NV12 "
        "! vfmetalvideofilter brightness=0.1 ! vfmetalconvertscale "
        "! video/x-raw,format=RGBA,width=32,height=24 ! fakesink "
        "videotestsrc num-buffers=2 ! video/x-raw,format=RGBA,width=64,height=48 ! c.sink_0",
        device="cpu", quiet=True)
    assert n == 2


@pytest.mark.parametrize("fmt", ["BGRA", "RGBA", "NV12", "I420"])
def test_single_input_all_formats(fmt):
    n = launch(
        "vfmetalcompositor name=c ! video/x-raw,format=BGRA ! fakesink "
        f"videotestsrc num-buffers=2 ! video/x-raw,format={fmt},width=48,height=32 "
        "! c.sink_0", device="cpu", quiet=True)
    assert n == 2


def test_timestamp_aggregation_mixed_rates():
    """30 fps + 15 fps pads into a 30 fps composite: each slow-pad buffer is
    shown twice (latest buffer by pts, the GstVideoAggregator model)."""
    pipe, frames = _two_rates(r0=30, r1=15)
    assert float(pipe._outgoing(pipe["c"])[0].spec.fps) == 30.0
    assert len(frames) == 4
    slow = [f[:, 32:, :] for f in frames]
    np.testing.assert_array_equal(slow[0], slow[1])
    np.testing.assert_array_equal(slow[2], slow[3])
    assert (slow[0] != slow[2]).any()


def test_eos_pad_freezes_last_frame_by_default():
    _, frames = _two_rates()
    assert len(frames) == 4  # runs until ALL pads are past their last buffer
    slow = [f[:, 32:, :] for f in frames]
    assert (slow[0] != slow[1]).any()
    np.testing.assert_array_equal(slow[1], slow[2])  # frozen last buffer
    np.testing.assert_array_equal(slow[1], slow[3])


def test_ignore_inactive_pads_drops_eos_pad():
    _, frames = _two_rates(props="ignore-inactive-pads=true")
    assert len(frames) == 4
    slow = [f[:, 32:, :] for f in frames]
    assert (slow[0] != slow[1]).any()
    assert (slow[2][..., :3] == 0).all()  # background where the pad was
    assert (slow[3][..., :3] == 0).all()


def test_late_start_pad_skipped_until_first_buffer():
    offset_ns = int(2 / 25 * 1e9)  # starts at output frame 2 (25 fps)
    _, frames = _two_rates(
        pattern=f"pattern=white timestamp-offset={offset_ns}")
    assert len(frames) == 4
    late = [f[:, 32:, :] for f in frames]
    assert (late[0][..., :3] == 0).all()  # not started: background
    assert (late[1][..., :3] == 0).all()
    assert (late[2][..., :3] == 255).all()
    assert (late[3][..., :3] == 255).all()


def test_moving_pads_between_runs_rebuilds_nothing():
    """xpos/ypos reach each frame as params: moving a pad keeps the built
    stages; a structural pad property (width) rebuilds."""
    pipe = parse_pipeline(
        "vfmetalcompositor name=c background=black "
        "! video/x-raw,format=RGBA,width=64,height=24 ! appsink "
        "videotestsrc num-buffers=8 pattern=white "
        "! video/x-raw,format=RGBA,width=8,height=8 ! c.sink_0", device="cpu")
    pipe.negotiate()
    pipe.build()
    stage = pipe.stages[0]
    bag = pipe["c"].get_pad("sink_0")
    sink = pipe.sinks[0]
    pipe.run(num_frames=1)
    assert (sink.frames[-1][:8, :8, 0] == 255).all()
    for (x, y), lit, dark in [
            ((40, 8), np.s_[8:16, 40:48], np.s_[:8, :8]),
            ((-4, -4), np.s_[:4, :4], np.s_[:4, 4:8]),  # cropped, not shifted
            ((200, 0), None, np.s_[:, :])]:  # fully offscreen
        bag.set("xpos", x)
        bag.set("ypos", y)
        pipe.run(num_frames=1)
        assert pipe.stages[0] is stage
        f = sink.frames[-1]
        if lit is not None:
            assert (f[lit][..., 0] == 255).all()
        assert (f[dark][..., :3] == 0).all()
    bag.set("width", 16)
    pipe.run(num_frames=1)
    assert pipe.stages[0] is not stage  # a structural change rebuilt


def test_appsrc_pts_drive_buffer_selection():
    """appsrc buffers with explicit pts: each output frame takes the latest
    buffer due by its deadline; per-buffer tff travels in buffer_meta."""
    pipe = parse_pipeline(
        "vfmetalcompositor name=c background=black sink_1::xpos=4 "
        "! video/x-raw,format=RGBA,width=8,height=4 ! appsink "
        "appsrc name=a format=RGBA width=4 height=4 ! c.sink_0 "
        "appsrc name=b format=RGBA width=4 height=4 ! c.sink_1", device="cpu")
    fps = 30.0  # appsrc's default frame rate, the output clock's

    def opaque(value):
        frame = np.full((4, 4, 4), value, np.uint8)
        frame[..., 3] = 255
        return frame

    for i in range(5):
        pipe["a"].push(opaque(10 * (i + 1)))
    pipe["a"].end_of_stream()
    for i, pts in enumerate((0.0, 1.5 / fps, 3 / fps, 3.5 / fps)):
        pipe["b"].push(opaque(100 + i), pts=pts, tff=bool(i))
    pipe["b"].end_of_stream()
    pipe.negotiate()
    spec = pipe._outgoing(pipe["b"])[0].spec
    assert pipe["b"].buffer_pts(1, spec) == pytest.approx(1.5 / fps)
    assert pipe["b"].buffer_meta(0, spec)["tff"] is False
    assert pipe["b"].buffer_meta(1, spec)["tff"] is True
    assert pipe.run() == 5
    right = [int(f[0, 4, 0]) for f in pipe["appsink0"].frames]
    assert right == [100, 100, 101, 102, 103]  # buffer 1 due at 1.5/fps


def test_sparse_pts_do_not_end_a_stream_early():
    """A source whose last buffer's pts lies past the index its frame rate
    gives is not ended before that pts: each output frame still shows the
    latest buffer that is due (tpuvf shows buffer 1 at frame 2 here, before
    its pts, and marks the stream ended)."""
    pipe = parse_pipeline(
        "vfmetalcompositor name=c background=black sink_1::xpos=4 "
        "! video/x-raw,format=RGBA,width=8,height=4 ! appsink "
        "appsrc name=a format=RGBA width=4 height=4 ! c.sink_0 "
        "appsrc name=b format=RGBA width=4 height=4 ! c.sink_1", device="cpu")
    frame = np.full((4, 4, 4), 255, np.uint8)
    for _ in range(5):
        pipe["a"].push(frame)
    pipe["a"].end_of_stream()
    for i, pts in enumerate((0.0, 3 / 30.0)):  # 30 fps: the default rate
        pipe["b"].push(np.full((4, 4, 4), 100 + i, np.uint8), pts=pts)
    pipe["b"].end_of_stream()
    pipe.negotiate()
    pipe.build()
    _, infos = pipe._clock()
    picked = [pipe._select_buffers(k, 30.0, infos)["b"] for k in range(5)]
    assert [j for j, _ in picked] == [0, 0, 0, 1, 1]
    assert [meta["eos"] for _, meta in picked] == [0.0, 0.0, 0.0, 0.0, 1.0]


def test_keyed_upload_and_step():
    """upload_sources/step_sources drive a multi-source graph; a source's
    '__meta__' reaches the compositor (not started: not drawn)."""
    pipe = parse_pipeline(
        "vfmetalcompositor name=c background=black sink_1::xpos=4 "
        "! video/x-raw,format=RGBA,width=8,height=4 ! appsink "
        "appsrc name=a format=RGBA width=4 height=4 ! c.sink_0 "
        "appsrc name=b format=RGBA width=4 height=4 ! c.sink_1", device="cpu")
    pipe.build()
    white = np.full((4, 4, 4), 255, np.uint8)
    inputs = pipe.upload_sources({"a": white, "b": white})
    out, state = pipe.step_sources(inputs, pipe.state, pipe.params())
    assert set(out) == {"rgba"} and (out["rgba"][:3] == 255).all()
    inputs["b"] = dict(inputs["b"], __meta__={"active": 0.0, "eos": 0.0})
    out, _ = pipe.step_sources(inputs, state, pipe.params())
    assert (out["rgba"][:3, :, 4:] == 0).all()
    assert (out["rgba"][:3, :, :4] == 255).all()
    with pytest.raises(ValueError, match="upload_sources"):
        pipe.upload(white)
    with pytest.raises(ValueError, match="step_sources"):
        pipe.step(inputs["a"], state, pipe.params())


def test_pipeline_matches_tpuvf(monkeypatch):
    """Three appsrc pads (BGRA, a scaled NV12 at a negative position, RGBA
    ADD) of two frame rates against tpuvf's pipeline on the same frames."""
    monkeypatch.setenv("TPUVF_NO_SPLIT_LINKS", "1")
    desc = ("vfmetalcompositor name=c background=checker "
            "sink_1::xpos=-5 sink_1::ypos=7 sink_1::width=40 "
            "sink_1::height=24 sink_1::alpha=0.6 "
            "sink_2::xpos=21 sink_2::ypos=3 sink_2::operator=add "
            "! video/x-raw,format=BGRA ! appsink "
            "appsrc name=a format=BGRA width=48 height=32 ! c.sink_0 "
            "appsrc name=b format=NV12 width=32 height=18 "
            "! video/x-raw,framerate=15/1 ! c.sink_1 "
            "appsrc name=d format=RGBA width=17 height=11 ! c.sink_2")
    rng = np.random.default_rng(12)
    feeds = {
        "a": [rng.integers(0, 256, (32, 48, 4), dtype=np.uint8)
              for _ in range(4)],
        "b": [{"y": rng.integers(0, 256, (18, 32), dtype=np.uint8),
               "uv": rng.integers(0, 256, (9, 32), dtype=np.uint8)}
              for _ in range(2)],
        "d": [rng.integers(0, 256, (11, 17, 4), dtype=np.uint8)
              for _ in range(4)],
    }
    outs = []
    for parse, kw in ((tpuvf_parse, {}), (parse_pipeline, {"device": "cpu"})):
        pipe = parse(desc, **kw)
        for name, frames in feeds.items():
            for f in frames:
                pipe[name].push(f)
            pipe[name].end_of_stream()
        pipe.negotiate()
        pipe.build()
        assert pipe.run() == 4
        outs.append(pipe["appsink0"].frames)
    want, got = outs
    assert len(got) == len(want) == 4
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.shape == w.shape == (32, 48, 4)
        d = np.abs(g.astype(np.int32) - w.astype(np.int32))
        print(f"frame {i}: max {int(d.max())} LSB, "
              f"{float((d > 0).mean()):.4%} differ")
        assert int(d.max()) <= 1  # (module doc)


def test_cli_compositor_on_cpu(capsys):
    rc = port_main([
        "--device", "cpu", "-v",
        "vfmetalcompositor name=c sink_1::xpos=16 sink_1::alpha=0.5 "
        "! video/x-raw,format=BGRA ! fakesink "
        "videotestsrc num-buffers=3 ! video/x-raw,format=NV12,width=32,height=24 "
        "! c.sink_0 videotestsrc num-buffers=3 pattern=ball "
        "! video/x-raw,format=BGRA,width=32,height=24 ! c.sink_1"])
    out = capsys.readouterr().out
    assert rc == 0
    assert "videotestsrc0 -> c.sink_0: " in out
    assert "processed 3 frames on cpu, reached end of stream" in out


def test_graph_errors():
    with pytest.raises(ParseError, match="unknown element"):
        parse_pipeline("videotestsrc ! nope.sink_0", device="cpu")
    with pytest.raises(ParseError, match="request pads"):
        parse_pipeline("videotestsrc ! vfmetalvideofilter sink_0::xpos=1 "
                       "! fakesink", device="cpu")
    # two independent chains run now (multi-sink); a src pad linked twice
    # without a tee is refused, as in tpuvf
    pipe = parse_pipeline("videotestsrc ! fakesink videotestsrc ! fakesink",
                          device="cpu")
    pipe.negotiate()
    pipe = parse_pipeline("videotestsrc name=s ! fakesink s. ! fakesink",
                          device="cpu")
    with pytest.raises(ValueError, match="links once"):
        pipe.negotiate()
