"""Carried state across a rebuild: the port's `Pipeline.build` keeps each
element's old state whose structure and tensor shapes still match, as
tpuvf's build does (``tpuvf/runtime/pipeline.py:311-327``).  Each case
drives the same pipeline string through tpuvf (under TPUVF_NO_SPLIT_LINKS=1,
canonical boundaries) and the port on the CPU, runs, writes a property that
rebuilds, and runs again.

Tolerances: <= 1 LSB per value (tpuvf's compiled grain hash and greedy-H
may contract an FMA; ROADMAP "Hazards").  Weave and bob move no arithmetic
a contraction could change.
"""

import numpy as np
import pytest
import torch

from tpuvf.cli.launch import parse_pipeline as tpuvf_parse
from tpuvf.core.spec import CapsFilter as TCaps
from tpuvf_torch.cli.launch import parse_pipeline as port_parse
from tpuvf_torch.core.spec import CapsFilter as PCaps
from tpuvf_torch.runtime.pipeline import same_layout

torch.set_num_threads(1)


def _frames(n, w, h, seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, (h, w, 4), dtype=np.uint8) for _ in range(n)]


def _pipe(parse, desc, frames=None, **kw):
    pipe = parse(desc, **kw)
    if frames is not None:
        for f in frames:
            pipe["appsrc0"].push(f)
        pipe["appsrc0"].end_of_stream()
    pipe.negotiate()
    pipe.build()
    return pipe


def _drive(parse, desc, steps, frames=None, **kw):
    """Run `desc`, then for each (element, property, value, frames) write the
    property and run that many frames -> the sink's frames."""
    pipe = _pipe(parse, desc, frames, **kw)
    for name, prop, value, n in steps:
        if name is not None:
            pipe[name].set_property(prop, value)
        assert pipe.run(n) == n
    return pipe["appsink0"].frames


def _max_lsb(a, b):
    assert a.shape == b.shape and a.dtype == b.dtype == np.uint8
    return int(np.abs(a.astype(np.int32) - b.astype(np.int32)).max())


GRAIN = ("videotestsrc pattern=smpte ! video/x-raw,format=RGBA,width=32,"
         "height=24 ! vfmetalvideofilter name=f noise=0.5 ! appsink")


def test_grain_counter_survives_a_rebuild(monkeypatch):
    """`invert` is a static gate: writing it rebuilds, and the grain counter
    goes on from 2 (before the repair the port restarted it at 0 and frame 2
    was 63 LSB from tpuvf)."""
    monkeypatch.setenv("TPUVF_NO_SPLIT_LINKS", "1")
    steps = [(None, None, None, 2), ("f", "invert", True, 1)]
    want = _drive(tpuvf_parse, GRAIN, steps)
    got = _drive(port_parse, GRAIN, steps, device="cpu")
    assert len(got) == len(want) == 3
    for i, (g, w) in enumerate(zip(got, want)):
        assert _max_lsb(g, w) <= 1, i  # module doc
    # the counter matters: a fresh pipeline's frame 0 is not frame 2
    fresh = _drive(port_parse, GRAIN.replace("noise=0.5",
                                             "noise=0.5 invert=true"),
                   [(None, None, None, 1)], device="cpu")
    assert _max_lsb(fresh[0], got[2]) > 1


DEINTERLACE = ("appsrc format=RGBA width=16 height=12 ! vfmetaldeinterlace "
               "name=d method=greedyh motion-threshold=0.3 ! appsink")


BOB, WEAVE = 0, 1  # vfdeinterlace's method enum


@pytest.mark.parametrize("to,carried", [(WEAVE, True), (BOB, False)])
def test_deinterlace_prev_carried_or_reset(to, carried, monkeypatch):
    """greedy-H -> weave keeps {"prev", "has_prev"}, so the first weave frame
    weaves against the carried previous frame (tpuvf/elements/
    deinterlace.py:140-151); greedy-H -> bob -> weave reshapes the state
    ({} for bob), so the weave frame after it falls back to bob on both
    sides."""
    monkeypatch.setenv("TPUVF_NO_SPLIT_LINKS", "1")
    frames = _frames(3, 16, 12, seed=31)
    steps = [(None, None, None, 2), ("d", "method", to, 1)]
    if to == BOB:
        steps.append(("d", "method", WEAVE, 1))
    want = _drive(tpuvf_parse, DEINTERLACE, steps, frames)
    got = _drive(port_parse, DEINTERLACE, steps, frames, device="cpu")
    assert len(got) == len(want) == len(steps) + 1
    for i, (g, w) in enumerate(zip(got, want)):
        assert _max_lsb(g, w) <= 1, i  # module doc
    # the last frame is buffer 0 again: woven against buffer 1 where the
    # state was carried, bob (a fresh weave's first frame) where it was not
    fresh = _drive(port_parse, DEINTERLACE.replace("greedyh", "weave"),
                   [(None, None, None, 1)], frames, device="cpu")
    assert np.array_equal(got[-1], fresh[0]) != carried


def test_caps_change_resets_the_previous_frame(monkeypatch):
    """A caps change that reshapes vfdeinterlace's previous frame carries
    nothing: the first frame after it is weave's bob fallback, on both
    sides."""
    monkeypatch.setenv("TPUVF_NO_SPLIT_LINKS", "1")
    desc = ("appsrc format=RGBA width=16 height=12 ! vfmetalconvertscale "
            "! video/x-raw,width=16,height=12 ! vfmetaldeinterlace "
            "method=weave ! appsink")
    frames = _frames(2, 16, 12, seed=32)
    outs = []
    for parse, caps, kw in ((tpuvf_parse, TCaps, {}),
                            (port_parse, PCaps, {"device": "cpu"})):
        pipe = _pipe(parse, desc, frames, **kw)
        assert pipe.run(2) == 2
        link = next(ln for ln in pipe.links if ln.caps is not None)
        link.caps = caps.parse("video/x-raw,width=8,height=6")
        pipe.negotiate()
        pipe.build()
        assert pipe.run(1) == 1
        outs.append(pipe["appsink0"].frames)
    want, got = outs
    assert [f.shape for f in got] == [f.shape for f in want] == [
        (12, 16, 4), (12, 16, 4), (6, 8, 4)]
    for i, (g, w) in enumerate(zip(got, want)):
        assert _max_lsb(g, w) <= 1, i
    fresh = _drive(port_parse, desc.replace("width=16,height=12",
                                            "width=8,height=6"),
                   [(None, None, None, 1)], frames, device="cpu")
    assert np.array_equal(got[-1], fresh[0])  # bob fallback: nothing carried


def test_carried_tensors_are_the_old_objects():
    """No copy and no host round trip: the carried entry is the tensor the
    last frame left, on its device."""
    pipe = _pipe(port_parse, GRAIN, device="cpu")
    assert pipe.run(2) == 2
    counter = pipe.state["f"]["frame_index"]
    assert int(counter) == 2
    pipe["f"].set_property("invert", True)
    pipe.build()
    assert pipe.state["f"]["frame_index"] is counter


@pytest.mark.parametrize("old,new,same", [
    ({"prev": torch.zeros(4, 6, 8), "has_prev": True},
     {"prev": torch.zeros(4, 6, 8), "has_prev": False}, True),
    ({"prev": torch.zeros(4, 6, 8), "has_prev": True},
     {"prev": torch.zeros(4, 3, 4), "has_prev": False}, False),
    ({}, {"prev": torch.zeros(4, 6, 8), "has_prev": False}, False),
    ({"frame_index": torch.zeros((), dtype=torch.int64)},
     {"frame_index": 0}, True),
    ((torch.zeros(2), torch.zeros(3)), (torch.zeros(2), torch.zeros(3)),
     True),
    ((torch.zeros(2),), [torch.zeros(2)], False),
    ((torch.zeros(2),), (torch.zeros(2), torch.zeros(2)), False),
    (None, None, True),
    (None, torch.zeros(()), False),
    ((), (), True),
])
def test_same_layout_is_tpuvfs_rule(old, new, same):
    assert same_layout(old, new) is same
