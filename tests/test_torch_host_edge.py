"""The port's host edge: the 4:2:2 repack, the host layout computed with
torch on the planes' device, and `Pipeline.run`'s one-frame overlap loop
(tpuvf's `run` with `_flush_pending`), on the CPU.

Tolerances: every case here is bitwise (repacks are permutations; the loop
delivers the frames a synchronous loop computes).
"""

import numpy as np
import pytest
import torch

from tests.util import random_host_frame
from tpuvf.core.formats import VideoFormat as TFormat
from tpuvf.core.frame import host_to_planes as t_host_to_planes
from tpuvf.core.frame import planes_to_host as t_planes_to_host
from tpuvf.core.spec import FrameSpec as TSpec
from tpuvf_torch.cli.launch import parse_pipeline
from tpuvf_torch.core.formats import VideoFormat as PFormat
from tpuvf_torch.core.frame import (
    HostLayout,
    from_host_layout,
    host_layout,
    host_to_planes,
    planes_to_host,
    to_host,
)
from tpuvf_torch.core.spec import FrameSpec as PSpec
from tpuvf_torch.runtime import observability
from tpuvf_torch.runtime.pipeline import PipelineError

torch.set_num_threads(1)

ALL = ("BGRA", "RGBA", "NV12", "I420", "UYVY", "YUY2")
SIZES = ((64, 48), (38, 37), (2, 1))  # odd heights for every format


def _same(a, b):
    if isinstance(b, dict):
        assert set(a) == set(b)
        return all(np.array_equal(a[k], b[k]) for k in b)
    return a.shape == b.shape and np.array_equal(a, b)


@pytest.mark.parametrize("fmt", ["UYVY", "YUY2"])
@pytest.mark.parametrize("size", SIZES)
def test_packed_422_matches_tpuvf(fmt, size):
    w, h = size
    tspec, pspec = TSpec(TFormat(fmt), w, h), PSpec(PFormat(fmt), w, h)
    host = random_host_frame(np.random.default_rng(w * h), tspec)
    got, want = host_to_planes(host, pspec), t_host_to_planes(host, tspec)
    assert _same(got, {k: np.asarray(v) for k, v in want.items()})
    assert got["u"].shape == (h, w // 2)
    assert np.array_equal(planes_to_host(got, pspec),
                          t_planes_to_host(want, tspec))
    assert np.array_equal(planes_to_host(got, pspec), host)


@pytest.mark.parametrize("fmt", ["UYVY", "YUY2"])
def test_packed_422_odd_width_is_refused_as_in_tpuvf(fmt):
    with pytest.raises(ValueError, match="even width"):
        TSpec(TFormat(fmt), 37, 24)
    with pytest.raises(ValueError, match="even width"):
        PSpec(PFormat(fmt), 37, 24)


@pytest.mark.parametrize("fmt,size", [
    (f, s) for f in ALL for s in SIZES + ((7, 5),)
    if f not in ("UYVY", "YUY2") or s[0] % 2 == 0])
def test_torch_host_layout_matches_numpy(fmt, size):
    w, h = size
    pspec = PSpec(PFormat(fmt), w, h)
    host = random_host_frame(np.random.default_rng(7), TSpec(TFormat(fmt), w, h))
    planes = host_to_planes(host, pspec)
    tplanes = {k: torch.from_numpy(v) for k, v in planes.items()}
    layout = HostLayout(pspec)
    pieces = host_layout(tplanes, pspec)
    assert [tuple(p.shape) for p in pieces] == layout.shapes
    flat = layout.readback(pieces, layout.buffer(pinned=False))
    assert _same(layout.payload(flat), planes_to_host(planes, pspec))
    assert _same(layout.payload(flat, copy=True), planes_to_host(planes, pspec))
    back = from_host_layout(layout.upload(host, torch.device("cpu")), pspec)
    assert _same(to_host(back), planes)
    with pytest.raises(ValueError, match="host frame"):
        bad = ({k: v[:0] for k, v in host.items()} if isinstance(host, dict)
               else host[:0])
        layout.upload(bad, torch.device("cpu"))


FILTER = ("videotestsrc num-buffers=4 pattern=ball ! "
          "video/x-raw,format=BGRA,width=40,height=24 ! "
          "vfmetalvideofilter brightness=0.1 noise=0.3 ! ")


def _sync_reference(desc, n):
    """The frames of a loop with no overlap: step, then read back and repack
    in numpy (the plain versions), frame by frame."""
    pipe = parse_pipeline(desc, device="cpu")
    pipe.build()
    src, sink = pipe.sources[0], pipe.sinks[0]
    spec_in = pipe._source_spec(src)
    spec_out = pipe._incoming(sink)[0].spec
    params, state, out = pipe.params(), pipe.state, []
    for i in range(n):
        planes = pipe.upload(src.generate(i, spec_in))
        tail, state = pipe.step(planes, state, params, i)
        out.append(planes_to_host(to_host(tail), spec_out))
    return out


def test_overlap_loop_equals_a_synchronous_loop():
    desc = FILTER + "appsink"
    pipe = parse_pipeline(desc, device="cpu")
    kept = []
    sink = pipe["appsink0"]
    consume = sink.consume

    def keep(frame, spec, index):
        kept.append((index, frame.copy()))
        consume(frame, spec, index)

    sink.consume = keep
    assert pipe.run() == 4
    want = _sync_reference(desc, 4)
    assert [i for i, _ in kept] == [0, 1, 2, 3]
    for got, copy, w in zip(sink.frames, (f for _, f in kept), want):
        assert np.array_equal(got, w)
        assert np.array_equal(got, copy)  # not overwritten by a later frame
    assert not any(np.shares_memory(a, b) for a in sink.frames
                   for b in sink.frames if a is not b)
    stats = pipe.stats
    assert stats.frames == pipe.frames == 4 and pipe.wall_seconds > 0
    assert set(stats.edge_seconds) == set(observability.EDGE_PARTS)
    assert all(v >= 0 for v in stats.edge_seconds.values())
    assert stats.per_element_active == {"vfmetalvideofilter0": True}
    assert "4 frames in" in stats.summary()
    pipe.frames, pipe.wall_seconds = 0, 0.0  # chip_smoke's run_fps resets
    assert stats.frames == 0 and stats.wall_seconds == 0.0


def test_readback_buffers_alternate_per_sink():
    """Each sink reads back into two buffers taken in turns: a sink that
    does not keep its frames (fakesink, filesink) gets views of them, so
    frame 2's payload lies where frame 0's did; one that keeps them
    (appsink) gets copies."""
    pipe = parse_pipeline(FILTER + "tee name=t t. ! fakesink t. ! appsink",
                          device="cpu")
    seen = []
    sink = pipe["fakesink0"]
    sink.consume = lambda frame, spec, index: seen.append(frame)
    assert pipe.run() == 4
    assert not sink.KEEPS_PAYLOAD and pipe["appsink0"].KEEPS_PAYLOAD
    assert np.shares_memory(seen[0], seen[2])
    assert not np.shares_memory(seen[0], seen[1])
    assert np.array_equal(seen[3], pipe["appsink0"].frames[3])
    assert not np.shares_memory(seen[3], pipe["appsink0"].frames[3])


def _fail_on_call(pipe, name, k):
    """Make element `name`'s stage raise from its k-th call on."""
    st = next(s for s in pipe.stages if s.element.name == name)
    calls = [0]
    process = st.process

    def failing(*a):
        calls[0] += 1
        if calls[0] > k:
            raise RuntimeError("injected failure")
        return process(*a)

    st.process = failing


def test_step_failure_flushes_the_last_good_frame(tmp_path):
    out = tmp_path / "out.bgra"
    pipe = parse_pipeline(FILTER + f"filesink location={out}", device="cpu")
    pipe.build()
    _fail_on_call(pipe, "vfmetalvideofilter0", 2)
    with pytest.raises(PipelineError) as err:
        pipe.run()
    assert err.value.element == "vfmetalvideofilter0"
    assert err.value.frame_index == 2
    assert "failed at frame 2" in str(err.value)
    pipe["filesink0"].finalize()  # the application closes the sink
    want = _sync_reference(FILTER + "appsink", 2)
    assert out.read_bytes() == b"".join(f.tobytes() for f in want)


def test_sink_failure_reports_the_consumed_frame():
    pipe = parse_pipeline(FILTER + "appsink", device="cpu")
    sink = pipe["appsink0"]
    consume = sink.consume

    def fail_at_1(frame, spec, index):
        if index == 1:
            raise ValueError("sink refused")
        consume(frame, spec, index)

    sink.consume = fail_at_1
    with pytest.raises(PipelineError) as err:
        pipe.run()
    assert (err.value.element, err.value.frame_index) == ("appsink0", 1)
    assert len(sink.frames) == 1


def test_second_run_reports_its_own_frame_index():
    """A second run that fails at its frame 0 reports index 0 (tpuvf's loop
    index), not the count of frames the first run made."""
    pipe = parse_pipeline(FILTER + "fakesink", device="cpu")
    assert pipe.run() == 4
    _fail_on_call(pipe, "vfmetalvideofilter0", 0)
    with pytest.raises(PipelineError) as err:
        pipe.run()
    assert (err.value.element, err.value.frame_index) == (
        "vfmetalvideofilter0", 0)
    assert pipe.stats.frames == 4


def test_trace_and_logging():
    observability.configure_from_env()
    log = observability.get_logger("pipeline")
    assert log.name == "tpuvf_torch.pipeline"
    with observability.trace("span"):
        x = torch.ones(3) * 2
    assert float(x.sum()) == 6.0
