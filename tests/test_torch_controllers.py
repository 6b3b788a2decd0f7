"""Per-frame property control in the port: `Element.control`, `sync_frame`,
the per-frame params of `Pipeline.run` and `Pipeline.run_batched` (ports
of tests/test_controllers.py's cases without a mesh), property writes in
the middle of a run, and the carried state across batches and calls.

Each case runs the same pipeline string through the port on the CPU and,
where it compares with tpuvf, through tpuvf under TPUVF_NO_SPLIT_LINKS=1
(canonical boundaries).  `run_batched` equals `run` bitwise in the port;
each is within 1 LSB of tpuvf (the b/c/s fold and the resampling
re-expressions, ROADMAP's parity contract).  With film grain, <= 2 LSB on
all but an outlier share under 1% (tests/test_torch_elements.py: the hash
is chaotic under tpuvf's FMA contraction).
"""

import numpy as np
import pytest
import torch

from tpuvf.cli.launch import parse_pipeline as tpuvf_parse
from tpuvf_torch.cli.launch import parse_pipeline as port_parse_on
from tpuvf_torch.parallel.mesh import make_mesh
from tpuvf_torch.runtime.observability import PipelineError
from tpuvf_torch.runtime.params import controllers_from_tpuvf

torch.set_num_threads(1)

DESC = ("videotestsrc num-buffers=8 pattern=ball ! "
        "video/x-raw,format=BGRA,width=96,height=64 ! "
        "vfmetalvideofilter saturation=1.2 ! appsink")
RAMP = np.linspace(0.02, 0.3, 8).astype(np.float32)
# chip_smoke's chain (b) cut to 128x72: NV12 -> BGRA identity + b/c/s
CHAIN_B = ("videotestsrc num-buffers=8 pattern=ball ! "
           "video/x-raw,format=NV12,width=128,height=72 ! vfmetalconvertscale "
           "! video/x-raw,format=BGRA,width=128,height=72 ! vfmetalvideofilter "
           "brightness=0.05 contrast=1.1 saturation=1.2 ! appsink")
COMP_DESC = (
    "videotestsrc num-buffers=8 pattern=smpte ! "
    "video/x-raw,format=BGRA,width=64,height=48 ! comp.sink_0 "
    "videotestsrc num-buffers=8 pattern=ball ! "
    "video/x-raw,format=BGRA,width=32,height=24 ! comp.sink_1 "
    "vfcompositor name=comp sink_1::xpos=4 sink_1::ypos=6 ! appsink")
XPOS_RAMP = list(range(0, 32, 4))


@pytest.fixture(autouse=True)
def _canonical(monkeypatch):
    monkeypatch.setenv("TPUVF_NO_SPLIT_LINKS", "1")


def port_parse(desc):
    return port_parse_on(desc, device="cpu")


def _vf(p):
    return next(e for e in p.elements if e.ELEMENT_NAME == "vfvideofilter")


def _comp(p):
    return next(e for e in p.elements if e.ELEMENT_NAME == "vfcompositor")


def _frames(p):
    return [np.asarray(f) for f in p.sinks[0].frames]


def _run(parse, schedule, batched, batch_size=8, calls=1, desc=DESC,
         prop="brightness", elem=_vf):
    p = parse(desc)
    elem(p).control(prop, schedule)
    p.negotiate()
    p.build()
    for _ in range(calls):
        if batched:
            p.run_batched(8 // calls, batch_size=batch_size)
        else:
            p.run(8 // calls)
    return _frames(p)


def _max_lsb(a, b):
    assert a.shape == b.shape and a.dtype == b.dtype == np.uint8
    return int(np.abs(a.astype(np.int32) - b.astype(np.int32)).max())


def _equal(got, want):
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_array_equal(g, w, err_msg=f"frame {i}")


def _near_tpuvf(got, want):
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        assert _max_lsb(g, w) <= 1, f"frame {i}"  # module doc


def _near_tpuvf_grain(got, want):
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        d = np.abs(g.astype(np.int32) - w.astype(np.int32))
        assert (d > 2).mean() < 0.01, f"frame {i}"  # module doc


@pytest.mark.parametrize("desc", [DESC, CHAIN_B], ids=["bgra", "chain_b"])
def test_ramp_batched_matches_run_bitwise(desc):
    """A brightness ramp over an 8-frame batch equals 8 frames of run()
    bitwise, and both are within 1 LSB of tpuvf's run."""
    a = _run(port_parse, RAMP, batched=False, desc=desc)
    b = _run(port_parse, RAMP, batched=True, desc=desc)
    _equal(b, a)
    _near_tpuvf(a, _run(tpuvf_parse, RAMP, batched=False, desc=desc))
    _near_tpuvf(b, _run(tpuvf_parse, RAMP, batched=True, desc=desc))


def test_ramp_actually_animates():
    frames = _run(port_parse, RAMP, batched=True)
    assert any(not np.array_equal(frames[0], f) for f in frames[1:])


def test_callable_schedule_and_clamping():
    """Callable schedules work; a sequence clamps at its last entry."""
    a = _run(port_parse, lambda i: float(RAMP[min(i, 7)]), batched=True)
    b = _run(port_parse, list(RAMP[:4]), batched=True)  # RAMP[3] from 4 on
    c = _run(port_parse, list(RAMP[:4]) + [RAMP[3]] * 4, batched=True)
    np.testing.assert_array_equal(a[3], b[3])
    _equal(b, c)
    _near_tpuvf(b, _run(tpuvf_parse, list(RAMP[:4]), batched=True))


def test_schedule_rides_the_pipeline_clock():
    """Schedules index the output frame on the pipeline clock, which each
    call restarts: two 4-frame calls each replay frames 0-3 of both the
    source and the schedule (tpuvf's rule)."""
    a = _run(port_parse, RAMP, batched=True)
    b = _run(port_parse, RAMP, batched=True, batch_size=4, calls=2)
    for i in range(4):
        np.testing.assert_array_equal(b[i], a[i], err_msg=f"frame {i}")
        np.testing.assert_array_equal(b[4 + i], a[i], err_msg=f"frame {i}")
    _near_tpuvf(b, _run(tpuvf_parse, RAMP, batched=True, batch_size=4,
                        calls=2))


def test_multi_batch_single_call_spans_schedule():
    """One call in two batches of 4 walks the whole 8-entry schedule, and
    so do batches of 3 (the last one short)."""
    a = _run(port_parse, RAMP, batched=True, batch_size=8)
    _equal(_run(port_parse, RAMP, batched=True, batch_size=4), a)
    _equal(_run(port_parse, RAMP, batched=True, batch_size=3), a)


def test_mixed_run_then_batched_same_clock():
    """run(4) then run_batched(4) both restart the clock, so both emit
    schedule frames 0-3."""
    p = port_parse(DESC)
    _vf(p).control("brightness", RAMP)
    p.negotiate()
    p.build()
    p.run(4)
    p.run_batched(4)
    got = _frames(p)
    assert len(got) == 8
    for i in range(4):
        np.testing.assert_array_equal(got[4 + i], got[i], err_msg=f"{i}")


def test_structure_flip_raises_at_control_time():
    """A sequence that flips a static gate (gamma crossing 1.0) raises at
    control() with the offending frame; nothing stays attached."""
    p = port_parse(DESC)
    with pytest.raises(ValueError, match="frame 2"):
        _vf(p).control("gamma", [1.0, 1.0, 1.5, 1.5, 1.5, 1.5, 1.5, 1.5])
    assert not _vf(p)._controllers
    assert _vf(p).get_property("gamma") == 1.0


def test_structure_flip_raises_in_batched_for_callable():
    """A callable schedule is checked at dispatch, at the first frame
    whose structure differs; the frames of the batches before are
    delivered."""
    p = port_parse(DESC)
    _vf(p).control("gamma", lambda i: 1.0 if i < 5 else 1.5)
    p.negotiate()
    p.build()
    with pytest.raises(ValueError, match="structure at frame 5"):
        p.run_batched(8, batch_size=4)
    assert len(p.sinks[0].frames) == 4


def test_passthrough_flip_raises_at_control_time():
    p = port_parse(DESC.replace(" saturation=1.2", ""))
    with pytest.raises(ValueError, match="frame 1"):
        _vf(p).control("brightness", [0.0, 0.1, 0.2])


def test_structure_flip_ok_in_run():
    """run() rebuilds per frame, so an allowed gate-flipping schedule
    animates like per-frame property writes: each frame equals a pipeline
    built with that gamma, and tpuvf's run within 1 LSB."""
    sched = [1.0, 1.0, 1.5, 1.5, 1.5, 1.5, 1.5, 1.5]
    got = []
    for parse in (port_parse, tpuvf_parse):
        p = parse(DESC)
        _vf(p).control("gamma", sched, allow_structure_change=True)
        p.negotiate()
        p.build()
        p.run()
        got.append(_frames(p))
    _near_tpuvf(got[0], got[1])
    for i, g in enumerate(sched):
        q = port_parse(DESC.replace("saturation=1.2",
                                    f"saturation=1.2 gamma={g}"))
        q.negotiate()
        q.build()
        q.run(i + 1)
        np.testing.assert_array_equal(got[0][i], _frames(q)[i],
                                      err_msg=f"frame {i}")


def test_control_validates_property_name():
    p = port_parse(DESC)
    with pytest.raises(KeyError):
        _vf(p).control("no-such-prop", [0.1])
    el = _vf(p)
    el.control("brightness", [0.1])
    el.control("brightness", None)  # clears
    assert not el._controllers
    with pytest.raises(ValueError, match="empty"):
        el.control("brightness", [])


def test_pad_xpos_ramp_run_matches_per_frame_writes():
    """A pad schedule ("sink_1::xpos") animates in run() like per-frame
    writes (xpos reaches the prepare pass each frame: no rebuild), and
    matches tpuvf's run within 1 LSB."""
    p = port_parse(COMP_DESC)
    _comp(p).control("sink_1::xpos", XPOS_RAMP)
    p.negotiate()
    p.build()
    sig = p._built_signature
    p.run()
    assert p._built_signature is sig  # no rebuild
    got = _frames(p)
    for i, x in enumerate(XPOS_RAMP):
        q = port_parse(COMP_DESC.replace("sink_1::xpos=4",
                                         f"sink_1::xpos={x}"))
        q.negotiate()
        q.build()
        q.run(i + 1)
        np.testing.assert_array_equal(got[i], _frames(q)[i],
                                      err_msg=f"frame {i}")
    _near_tpuvf(got, _run(tpuvf_parse, XPOS_RAMP, batched=False,
                          desc=COMP_DESC, prop="sink_1::xpos", elem=_comp))


def test_pad_xpos_ramp_batched_matches_run():
    """The same pad ramp under run_batched equals run bitwise, and tpuvf's
    run_batched within 1 LSB; the draw moves with the ramp."""
    kw = dict(desc=COMP_DESC, prop="sink_1::xpos", elem=_comp)
    ref = _run(port_parse, XPOS_RAMP, batched=False, **kw)
    got = _run(port_parse, XPOS_RAMP, batched=True, batch_size=3, **kw)
    _equal(got, ref)
    _near_tpuvf(got, _run(tpuvf_parse, XPOS_RAMP, batched=True, **kw))
    assert not np.array_equal(got[0], got[1])


def test_pad_control_validates_static_pad_props():
    """zorder is a static pad prop (the draw order): a zorder schedule
    raises at control() time; an unknown pad prop is a KeyError."""
    p = port_parse(COMP_DESC)
    with pytest.raises(ValueError, match="frame 1"):
        _comp(p).control("sink_1::zorder", [0, 1])
    with pytest.raises(KeyError):
        _comp(p).control("sink_1::no-such-prop", [0])


def test_controllers_from_tpuvf():
    """A schedule set up once on tpuvf's element runs on the port's."""
    t = tpuvf_parse(DESC)
    _vf(t).control("brightness", RAMP)
    _vf(t).control("contrast", lambda i: 1.0 + 0.05 * i)
    p = port_parse(DESC)
    controllers_from_tpuvf(_vf(t), _vf(p))
    assert _vf(p)._controllers["brightness"] == [float(v) for v in RAMP]
    for pipe in (t, p):
        pipe.negotiate()
        pipe.build()
        pipe.run()
    _near_tpuvf(_frames(p), _frames(t))


# -- property writes while a run is in progress ------------------------------


MIDRUN = ("videotestsrc num-buffers=4 pattern=ball ! "
          "video/x-raw,format=BGRA,width=64,height=48 ! "
          "vfmetalvideofilter saturation=1.2 ! appsink")
GRAIN = ("videotestsrc num-buffers=4 pattern=smpte ! video/x-raw,format=RGBA,"
         "width=32,height=24 ! vfmetalvideofilter name=f noise=0.5 ! appsink")


def _write_at_frame_0(parse, desc, prop, value, batched=False):
    """Run `desc` with the appsink writing `prop` while it consumes frame
    0 -> the sink's frames."""
    p = parse(desc)
    p.negotiate()
    p.build()
    vf, sink = _vf(p), p.sinks[0]
    consume = sink.consume

    def write_after_0(frame, spec, index):
        consume(frame, spec, index)
        if index == 0:
            vf.set_property(prop, value)

    sink.consume = write_after_0
    if batched:
        p.run_batched(4, batch_size=2)
    else:
        p.run()
    return _frames(p)


def test_midrun_write_takes_effect_one_frame_later():
    """A property written while frame 0 is delivered takes effect at frame
    2 (frame 1 is already enqueued), as in tpuvf: 0 LSB from tpuvf on every
    frame.  Before the repair the port read the params once per run and
    its frames 2 and 3 were 76 LSB from tpuvf's."""
    want = _write_at_frame_0(tpuvf_parse, MIDRUN, "brightness", 0.3)
    got = _write_at_frame_0(port_parse, MIDRUN, "brightness", 0.3)
    assert [_max_lsb(g, w) for g, w in zip(got, want)] == [0, 0, 0, 0]
    plain = _write_at_frame_0(port_parse, MIDRUN, "brightness", 0.0)
    assert [_max_lsb(g, w) > 0 for g, w in zip(got, plain)] == [
        False, False, True, True]


def test_midrun_structural_write_rebuilds_with_state_kept():
    """A static write in the middle of a run (invert, a gate) rebuilds
    before frame 2, and the grain counter goes on from 2: tpuvf's frames
    (grain tolerance, module doc), and frame 2 is not a fresh counter's."""
    want = _write_at_frame_0(tpuvf_parse, GRAIN, "invert", True)
    got = _write_at_frame_0(port_parse, GRAIN, "invert", True)
    _near_tpuvf_grain(got, want)
    fresh = port_parse(GRAIN.replace("noise=0.5", "noise=0.5 invert=true"))
    fresh.run(1)
    assert _max_lsb(_frames(fresh)[0], got[2]) > 1
    assert _max_lsb(got[1], got[2]) > 1


def test_state_carries_across_batches_calls_and_run():
    """The grain counter runs through the frames in order whatever the
    loop: run_batched over batches and calls, then run, equals run alone
    bitwise, and tpuvf's the same loops (grain tolerance, module doc)."""
    def drive(parse, loops):
        p = parse(GRAIN.replace("num-buffers=4", "num-buffers=3"))
        p.negotiate()
        p.build()
        for loop in loops:
            loop(p)
        return _frames(p)

    runs = [lambda p: p.run(3)] * 3
    mixed = [lambda p: p.run_batched(3, batch_size=2),
             lambda p: p.run_batched(3, batch_size=3), lambda p: p.run(3)]
    ref = drive(port_parse, runs)
    _equal(drive(port_parse, mixed), ref)
    _near_tpuvf_grain(ref, drive(tpuvf_parse, mixed))


def test_batched_failure_names_the_batch_first_frame():
    """A step failure inside a batch raises PipelineError at the batch's
    first frame index (tpuvf's one dispatch a batch); the batch before it
    is delivered."""
    p = port_parse(DESC)
    p.negotiate()
    p.build()
    st = next(s for s in p.stages if not s.passthrough)
    process, calls = st.process, []

    def failing(planes, state, params):
        calls.append(1)
        if len(calls) == 6:
            raise RuntimeError("boom")
        return process(planes, state, params)

    st.process = failing
    with pytest.raises(PipelineError) as err:
        p.run_batched(8, batch_size=4)
    assert err.value.frame_index == 4
    assert err.value.element == st.element.name
    assert len(p.sinks[0].frames) == 4


def test_batched_with_a_mesh_raises():
    """tpuvf's refusals of a mesh run: no 'dp' axis, a batch that does not
    split over dp, an sp axis the mesh does not have; `sp_axis` without a
    mesh runs, as in tpuvf (it reads the axis only under a mesh)."""
    p = port_parse(DESC)
    cpu4 = ["cpu"] * 4
    with pytest.raises(ValueError, match="has no 'dp' axis"):
        p.run_batched(8, mesh=make_mesh({"sp": 4}, devices=cpu4))
    with pytest.raises(ValueError, match="must divide by dp=4"):
        p.run_batched(8, batch_size=6, mesh=make_mesh({"dp": 4},
                                                       devices=cpu4))
    with pytest.raises(ValueError, match="not in mesh axes"):
        p.run_batched(8, mesh=make_mesh({"dp": 2}, devices=cpu4),
                      sp_axis="sp")
    assert p.run_batched(8, sp_axis="sp") == 8
    assert len(p.sinks[0].frames) == 8


@pytest.mark.parametrize("desc,elem,prop,schedule", [
    (CHAIN_B, _vf, "brightness", RAMP),
    (COMP_DESC, _comp, "sink_1::xpos", XPOS_RAMP),
], ids=["videofilter", "compositor"])
def test_controllers_under_dp_sp_match_run(desc, elem, prop, schedule):
    """Per-frame schedules under a {dp: 2, sp: 2} mesh (tpuvf's
    ``frame_params``: the rows split over dp, replicated over sp) give
    run()'s frames, 0 LSB."""
    want = _run(port_parse, schedule, batched=False, desc=desc, prop=prop,
                elem=elem)
    p = port_parse(desc)
    elem(p).control(prop, schedule)
    mesh = make_mesh({"dp": 2, "sp": 2}, devices=["cpu"] * 4)
    assert p.run_batched(8, batch_size=4, mesh=mesh, sp_axis="sp") == 8
    got = _frames(p)
    assert len(got) == len(want) == 8
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert not np.array_equal(got[0], got[1])
