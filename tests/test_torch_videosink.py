"""vfvideosink: the port's window buffer against tpuvf's on the same host
frames, its navigation mapping, and the render Pipeline.run enqueues on the
step's planes against the sink's own `consume`.

tpuvf renders op by op here (``jax.disable_jit``).  Tolerance: bitwise
where the display rect is the video's size (no resample: `to_rgba` and
`quant`); <= 1 LSB where the float RGBA is resampled to the rect (tpuvf
samples through blockband/dense matmuls, the port through its 2-tap
kernels: the resampling re-expression class).  The letterbox bars are
exact either way.
"""

import jax
import numpy as np
import pytest
import torch

from tests.util import random_host_frame
from tpuvf.core.formats import VideoFormat as TFormat
from tpuvf.core.spec import FrameSpec as TSpec
from tpuvf.elements.videosink import VideoSink as TSink
from tpuvf.elements.videosink import center_rect as t_center_rect
from tpuvf_torch.cli.launch import parse_pipeline
from tpuvf_torch.core.formats import VideoFormat as PFormat
from tpuvf_torch.core.spec import FrameSpec as PSpec
from tpuvf_torch.elements.videosink import VideoSink as PSink
from tpuvf_torch.elements.videosink import center_rect
from tpuvf_torch.io import png

torch.set_num_threads(1)

CASES = [
    # (format, video w, h, props, render rectangle)
    ("NV12", 64, 48, {}, None),
    ("I420", 64, 36, {"window-width": 80, "window-height": 80}, None),
    ("BGRA", 48, 32, {"window-width": 100, "window-height": 40}, None),
    ("RGBA", 40, 30, {"window-width": 40, "window-height": 30}, None),
    ("UYVY", 64, 48, {"window-width": 96, "window-height": 50}, None),
    ("NV12", 37, 23, {"window-width": 50, "window-height": 41}, None),
    ("I420", 38, 22, {"window-width": 61, "window-height": 33,
                      "force-aspect-ratio": False}, None),
    ("BGRA", 32, 24, {"window-width": 90, "window-height": 70},
     (10, 6, 51, 40)),
    ("NV12", 64, 48, {"window-width": 90, "window-height": 70,
                      "force-aspect-ratio": False}, (3, 5, 77, 61)),
]


def _render_both(fmt, w, h, props, rect, seed=0):
    host = random_host_frame(np.random.default_rng(seed),
                             TSpec(TFormat(fmt), w, h))
    tspec, pspec = TSpec(TFormat(fmt), w, h), PSpec(PFormat(fmt), w, h)
    tsink, psink = TSink(**props), PSink(device="cpu", **props)
    for sink, spec in ((tsink, tspec), (psink, pspec)):
        sink.prepare(spec)
        if rect is not None:
            sink.set_render_rectangle(*rect)
    with jax.disable_jit():
        tsink.consume(host, tspec, 0)
    psink.consume(host, pspec, 0)
    return tsink, psink, host


@pytest.mark.parametrize("case", range(len(CASES)))
def test_window_matches_tpuvf(case):
    fmt, w, h, props, rect = CASES[case]
    tsink, psink, _ = _render_both(fmt, w, h, props, rect, seed=case)
    assert psink._display_rect == tsink._display_rect
    got, want = psink.window, tsink.window
    assert got.shape == want.shape and got.dtype == np.uint8
    d = np.abs(got.astype(np.int32) - want.astype(np.int32))
    dx, dy, dw, dh = psink._display_rect
    inside = np.zeros(got.shape[:2], bool)
    inside[dy:dy + dh, dx:dx + dw] = True
    assert not d[~inside].any()  # the bars, exact
    assert (got[~inside] == (0, 0, 0, 255)).all()
    tol = 0 if (dw, dh) == (w, h) else 1
    assert int(d.max()) <= tol, f"{int(d.max())} LSB"


def test_center_rect_and_navigation_match_tpuvf():
    for args in ((64, 48, 100, 40), (48, 64, 40, 100), (37, 23, 50, 41),
                 (16, 9, 16, 9), (64, 48, 30, 30, False)):
        assert center_rect(*args) == t_center_rect(*args)
    tsink, psink, _ = _render_both("NV12", 64, 48,
                                   {"window-width": 100, "window-height": 40},
                                   None)
    for wx, wy in ((0, 0), (50, 20), (99.5, 39), (30.25, 7.5), (-5, 60)):
        assert psink.navigation_to_video_coords(wx, wy) == \
            tsink.navigation_to_video_coords(wx, wy)
    seen = []
    psink.navigation_callback = seen.append
    ev = psink.send_navigation_event("mouse-move", 50, 20)
    assert seen == [ev]
    assert ev == tsink.send_navigation_event("mouse-move", 50, 20)
    psink.props.set("enable-navigation-events", False)
    assert psink.send_navigation_event("mouse-move", 50, 20) is None


def test_expose_rerenders_the_last_frame():
    tsink, psink, host = _render_both("I420", 64, 36, {}, None, seed=4)
    for sink in (tsink, psink):
        sink.set_window_size(90, 90)
    with jax.disable_jit():
        tsink.expose()
    psink.expose()
    assert psink.window.shape == (90, 90, 4)
    assert int(np.abs(psink.window.astype(int) - tsink.window).max()) <= 1
    fresh = PSink()
    fresh.expose()  # nothing rendered yet: no-op
    assert fresh.window is None


def test_pipeline_renders_the_step_planes(tmp_path):
    """Pipeline.run renders each frame's device planes (the sink's device
    hook) and reads back only the window: the same windows as the sink's
    own consume of the host frames, and the snapshots are those windows."""
    desc = ("videotestsrc num-buffers=3 pattern=ball ! "
            "video/x-raw,format=NV12,width=64,height=48 ! tee name=t "
            "t. ! queue ! vfmetalvideosink window-width=80 window-height=50 "
            f"snapshot-location={tmp_path}/w%d.png t. ! queue ! appsink")
    pipe = parse_pipeline(desc, device="cpu")
    sink = pipe["vfmetalvideosink0"]
    shown = []
    present = sink.present

    def keep(window, index):
        shown.append(window)
        present(window, index)

    sink.present = keep
    assert pipe.run() == 3
    assert sink.frame_count == 3
    spec = pipe._incoming(sink)[0].spec
    ref = PSink(device="cpu", **{"window-width": 80, "window-height": 50})
    ref.prepare(spec)
    for i, frame in enumerate(pipe["appsink0"].frames):
        ref.consume(frame, spec, i)
        assert np.array_equal(shown[i], ref.window)
        assert np.array_equal(png.read(str(tmp_path / f"w{i}.png")),
                              ref.window)
    assert sink.window is shown[-1]
    assert sink._display_rect == (6, 0, 67, 50)


def test_consume_defaults_to_cuda():
    """A sink used on its own renders on "cuda" unless the caller asks for
    the CPU; without a card its consume raises instead of falling back."""
    host = random_host_frame(np.random.default_rng(5),
                             TSpec(TFormat.I420, 32, 18))
    spec = PSpec(PFormat.I420, 32, 18)
    sink = PSink()
    sink.prepare(spec)
    assert sink.device == "cuda"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            sink.consume(host, spec, 0)
        assert sink.window is None
    sink.bind_device("cpu")
    sink.consume(host, spec, 0)
    cpu = PSink(device="cpu")
    cpu.prepare(spec)
    cpu.consume(host, spec, 0)
    assert np.array_equal(sink.window, cpu.window)
