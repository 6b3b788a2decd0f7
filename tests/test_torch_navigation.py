"""Navigation routing in the port (`Pipeline._wire_navigation`, tpuvf's
``tpuvf/runtime/pipeline.py:607-664``): a vfvideosink's pointer event
goes upstream through the compositors' pad hit tests and the resizing
elements' rescale to a source.  Each routed event (source, coordinates) is
compared with tpuvf's for the same pipeline string and pointer position;
the coordinates are host floats computed by the same arithmetic, so they
are compared exactly.
"""

import numpy as np
import pytest
import torch

from tpuvf.cli.launch import parse_pipeline as tpuvf_parse
from tpuvf_torch.cli.launch import parse_pipeline as port_parse_on

torch.set_num_threads(1)

COMPOSITE = (
    "vfmetalcompositor name=c background=black sink_1::xpos=100 "
    "sink_1::ypos=50 sink_1::width=64 sink_1::height=48 "
    "! video/x-raw,format=RGBA,width=200,height=120 ! vfmetalvideosink "
    "videotestsrc name=srcA num-buffers=1 "
    "! video/x-raw,format=RGBA,width=200,height=120 ! c.sink_0 "
    "videotestsrc name=srcB num-buffers=1 "
    "! video/x-raw,format=NV12,width=32,height=24 ! c.sink_1 ")
# a resizing vfconvertscale before a letterboxing window
SCALED = ("videotestsrc name=src num-buffers=1 ! video/x-raw,format=NV12,"
          "width=64,height=48 ! vfmetalconvertscale ! video/x-raw,format=BGRA,"
          "width=160,height=90 ! vfmetalvideosink window-width=200 "
          "window-height=150")
# a resized branch into a compositor pad, and a tee
SCALED_PAD = (
    "vfmetalcompositor name=c background=black sink_1::xpos=20 "
    "sink_1::ypos=10 ! video/x-raw,format=BGRA ! tee name=t t. ! queue ! "
    "vfmetalvideosink t. ! queue ! fakesink "
    "videotestsrc name=base num-buffers=1 ! video/x-raw,format=BGRA,"
    "width=96,height=64 ! c.sink_0 "
    "videotestsrc name=small num-buffers=1 ! video/x-raw,format=NV12,"
    "width=32,height=24 ! vfmetalconvertscale ! video/x-raw,format=BGRA,"
    "width=48,height=36 ! c.sink_1")


@pytest.fixture(autouse=True)
def _canonical(monkeypatch):
    monkeypatch.setenv("TPUVF_NO_SPLIT_LINKS", "1")


def _run(parse, desc, **kw):
    pipe = parse(desc, **kw)
    pipe.negotiate()
    pipe.build()
    pipe.run()
    return pipe


def _both(desc):
    return (_run(port_parse_on, desc, device="cpu"), _run(tpuvf_parse, desc))


def _sink(pipe):
    return next(s for s in pipe.sinks if s.ELEMENT_NAME == "vfvideosink")


def test_navigation_routed_to_compositor_pad_source():
    """The port of tests/test_videosink_codecs.py's routing case: the sink
    maps window to video coordinates, the compositor hit-tests its pads and
    rescales into the hit pad's input, and the event lands at that pad's
    source; tpuvf routes each event the same way."""
    port, ref = _both(COMPOSITE)
    for pipe in (port, ref):
        _sink(pipe).send_navigation_event("mouse-move", 132.0, 74.0)
        _sink(pipe).send_navigation_event("mouse-move", 10.0, 10.0)
    ev = port.navigation_events[-2]
    assert ev["source"] == "srcB"
    assert ev["pointer_x"] == pytest.approx((132 - 100) * 32 / 64)
    assert ev["pointer_y"] == pytest.approx((74 - 50) * 24 / 48)
    assert port.navigation_events[-1]["source"] == "srcA"
    assert port.navigation_events == ref.navigation_events


@pytest.mark.parametrize("desc", [COMPOSITE, SCALED, SCALED_PAD],
                         ids=["composite", "scaled", "scaled_pad"])
def test_navigation_grid_matches_tpuvf(desc):
    """A grid of pointer positions over the window, past its edges too:
    every routed event, and every event that stops at a compositor with no
    pad under it, is tpuvf's; each routed one reaches the source's
    navigation_callback."""
    port, ref = _both(desc)
    seen = []
    for src in port.sources:
        src.navigation_callback = seen.append
    window = _sink(port).window.shape
    xs = np.linspace(-10.0, window[1] + 10.0, 13)
    ys = np.linspace(-10.0, window[0] + 10.0, 11)
    for x in xs:
        for y in ys:
            for pipe in (port, ref):
                _sink(pipe).send_navigation_event("mouse-button-press",
                                                  float(x), float(y))
    assert port.navigation_events == ref.navigation_events
    assert seen == port.navigation_events
    assert len({ev["source"] for ev in seen}) == len(port.sources)


def test_navigation_callback_write_takes_effect():
    """A source's navigation callback that writes a property takes effect
    like any write during a run: an event sent while frame 0 is presented
    changes the windows from frame 2 on."""
    desc = ("videotestsrc name=src num-buffers=4 pattern=ball ! "
            "video/x-raw,format=BGRA,width=64,height=48 ! vfmetalvideofilter "
            "saturation=1.2 ! vfmetalvideosink")

    def windows(send):
        pipe = port_parse_on(desc, device="cpu")
        pipe.negotiate()
        pipe.build()
        sink, vf = _sink(pipe), pipe["vfmetalvideofilter0"]
        pipe["src"].navigation_callback = (
            lambda ev: vf.set_property("brightness", 0.3))
        shown, present = [], sink.present

        def keep(window, index):
            shown.append(window.copy())
            present(window, index)
            if send and index == 0:
                sink.send_navigation_event("mouse-move", 5.0, 5.0)

        sink.present = keep
        pipe.run()
        return shown

    got, plain = windows(True), windows(False)
    assert [not np.array_equal(g, p) for g, p in zip(got, plain)] == [
        False, False, True, True]
