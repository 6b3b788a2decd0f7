"""Multi-sink graphs in the port against tpuvf: tee, queue and identity, the
link rules tpuvf's `negotiate` enforces, the host codec chains, the output
clock at the fastest branch tail, and the element registry.

tpuvf runs under TPUVF_NO_SPLIT_LINKS=1 (every boundary canonical).
Tolerance per sink: bitwise where the branch only moves bytes
(tee/queue/identity, codecs of a passthrough stream); <= 1 LSB where it
resamples or runs vfvideofilter's b/c/s fold (as in test_torch_pipeline).
"""

import numpy as np
import pytest
import torch

from tpuvf.cli.launch import parse_pipeline as tpuvf_parse
from tpuvf.core import registry as t_registry
from tpuvf.core.formats import VideoFormat as TFormat
from tpuvf.core.spec import FrameSpec as TSpec
from tpuvf_torch.cli.launch import main as port_main
from tpuvf_torch.cli.launch import parse_pipeline as port_parse
from tpuvf_torch.core import registry as p_registry
from tpuvf_torch.runtime.params import from_tpuvf

torch.set_num_threads(1)

TEE = ("videotestsrc num-buffers=3 pattern=ball ! "
       "video/x-raw,format=NV12,width=64,height=48 ! tee name=t "
       "t. ! queue ! vfmetalconvertscale ! "
       "video/x-raw,format=BGRA,width=32,height=24 ! appsink name=a "
       "t. ! identity ! vfmetalconvertscale ! video/x-raw,format=RGBA ! "
       "vfmetalvideofilter brightness=0.1 contrast=1.2 ! appsink name=b "
       "t. ! queue ! appsink name=c "
       "t. ! queue max-size-buffers=3 leaky=downstream ! appsink name=d")
TOL = {"a": 1, "b": 1, "c": 0, "d": 0}


def _run(parse, desc, **kw):
    pipe = parse(desc, **kw)
    pipe.negotiate()
    pipe.build()
    n = pipe.run()
    return pipe, n


def _diff(got, want):
    if isinstance(want, dict):
        return max(_diff(got[k], want[k]) for k in want)
    assert got.shape == want.shape
    return int(np.abs(got.astype(np.int32) - want.astype(np.int32)).max())


def test_tee_branches_match_tpuvf(monkeypatch):
    monkeypatch.setenv("TPUVF_NO_SPLIT_LINKS", "1")
    tpipe, tn = _run(tpuvf_parse, TEE)
    ppipe, pn = _run(port_parse, TEE, device="cpu")
    assert tn == pn == 3
    for name, tol in TOL.items():
        want, got = tpipe[name].frames, ppipe[name].frames
        assert len(got) == len(want) == 3
        for g, w in zip(got, want):
            assert _diff(g, w) <= tol, name
    # every sink its own payload, even of one tee value
    assert not np.shares_memory(ppipe["c"].frames[0]["y"],
                                ppipe["d"].frames[0]["y"])
    step_out, _ = ppipe.step(ppipe.upload(ppipe.sources[0].generate(
        0, ppipe._source_spec(ppipe.sources[0]))), ppipe.state,
        ppipe.params())
    assert sorted(step_out) == ["a", "b", "c", "d"]
    assert step_out["c"]["y"] is step_out["d"]["y"]


def _negotiate_error(parse, desc, **kw):
    pipe = parse(desc, **kw)
    with pytest.raises(ValueError) as err:
        pipe.negotiate()
        pipe.build()
    return str(err.value)


@pytest.mark.parametrize("desc,match", [
    # a src pad links once: fan out through a tee
    ("videotestsrc name=s ! fakesink s. ! fakesink", "links once"),
    # tee never converts
    ("videotestsrc ! video/x-raw,format=NV12,width=32,height=24 ! tee name=t "
     "t. ! video/x-raw,format=BGRA ! fakesink t. ! fakesink", "cannot convert"),
    # a tee with no branch
    ("videotestsrc ! tee", "at least one output"),
    # a codec upstream of a tee would encode every branch
    ("videotestsrc ! video/x-raw,format=BGRA,width=32,height=24 ! pngenc ! "
     "tee name=t t. ! fakesink t. ! fakesink", "contiguous chain"),
    # a codec with a processing element between it and its sink
    ("videotestsrc ! video/x-raw,format=BGRA,width=32,height=24 ! pngenc ! "
     "vfmetalvideofilter brightness=0.1 ! fakesink", "contiguous chain"),
    ("videotestsrc ! video/x-raw,format=NV12,width=32,height=24 ! y4menc ! "
     "fakesink", "I420 only"),
])
def test_negotiation_errors_match_tpuvf(desc, match):
    assert match in _negotiate_error(tpuvf_parse, desc)
    assert match in _negotiate_error(port_parse, desc, device="cpu")


def test_codec_before_a_videosink_is_refused():
    """vfvideosink reads back its window, not the host byte layout, so a
    host codec before it would be skipped: the port refuses it at build."""
    desc = ("videotestsrc ! video/x-raw,format=BGRA,width=32,height=24 ! "
            "pngenc ! vfmetalvideosink")
    assert "cannot precede" in _negotiate_error(port_parse, desc,
                                                device="cpu")


def test_clock_runs_at_the_fastest_branch_tail(monkeypatch):
    monkeypatch.setenv("TPUVF_NO_SPLIT_LINKS", "1")
    desc = ("videotestsrc num-buffers=3 pattern=ball ! "
            "video/x-raw,format=BGRA,width=16,height=8,framerate=10/1 ! "
            "appsink name=slow "
            "videotestsrc num-buffers=6 pattern=snow ! "
            "video/x-raw,format=BGRA,width=16,height=8,framerate=20/1 ! "
            "appsink name=fast")
    tpipe, tn = _run(tpuvf_parse, desc)
    ppipe, pn = _run(port_parse, desc, device="cpu")
    assert ppipe._clock()[0] == 20.0
    assert tn == pn == 6
    for name in ("slow", "fast"):
        assert len(ppipe[name].frames) == 6
        for g, w in zip(ppipe[name].frames, tpipe[name].frames):
            assert np.array_equal(g, w)
    # the slow stream repeats each buffer for two output frames
    slow = ppipe["slow"].frames
    assert np.array_equal(slow[0], slow[1]) and not np.array_equal(
        slow[1], slow[2])


def _descriptors(cls):
    return [(d.name, d.type, d.default, d.minimum, d.maximum, d.enum_values,
             d.controllable, d.traced) for d in cls.PROPERTIES]


def test_registries_list_the_same_elements():
    t_registry._ensure_loaded()
    p_registry._ensure_loaded()
    assert sorted(t_registry._REGISTRY) == sorted(p_registry._REGISTRY)
    for name, tcls in sorted(t_registry._REGISTRY.items()):
        pcls = p_registry.lookup(name)
        assert pcls.ELEMENT_NAME == tcls.ELEMENT_NAME, name
        assert pcls.ALIASES == tcls.ALIASES, name
        assert _descriptors(pcls) == _descriptors(tcls), name
        assert getattr(pcls, "FAN_OUT", False) == getattr(tcls, "FAN_OUT",
                                                          False), name
        assert getattr(pcls, "HOST_CODEC", False) == getattr(
            tcls, "HOST_CODEC", False), name


@pytest.mark.parametrize("name", ["queue", "identity", "tee", "filesink",
                                  "multifilesink", "pngenc", "jpegenc",
                                  "y4menc", "rawvideosrc", "y4msrc",
                                  "vfvideosink"])
def test_from_tpuvf_accepts_the_new_elements(name):
    el = t_registry.make(name)
    spec = TSpec(TFormat.I420, 64, 48)
    params, state = from_tpuvf(el.traced_params(), el.init_state(spec, spec),
                               "cpu")
    assert params == {} and state == ()
    assert p_registry.make(name).traced_params() == {}


def test_cli_runs_a_tee_with_a_videosink_and_a_y4m_file(tmp_path, capsys,
                                                        monkeypatch):
    monkeypatch.setenv("TPUVF_NO_SPLIT_LINKS", "1")
    tmpl = ("videotestsrc num-buffers=2 pattern=ball ! "
            "video/x-raw,format=I420,width=64,height=48 ! tee name=t "
            "t. ! queue ! vfmetalvideosink window-width=96 window-height=96 "
            "t. ! queue ! y4menc ! filesink location={}")
    out = tmp_path / "port.y4m"
    assert port_main(["--device", "cpu", "-v", tmpl.format(out)]) == 0
    text = capsys.readouterr().out
    assert "processed 2 frames on cpu, reached end of stream" in text
    assert "passthrough-elided: t, queue0, queue1, y4menc0" in text
    want = tmp_path / "tpuvf.y4m"
    _run(tpuvf_parse, tmpl.format(want))
    assert out.read_bytes() == want.read_bytes()
    assert out.read_bytes().startswith(b"YUV4MPEG2 W64 H48 F30:1 Ip A1:1 "
                                       b"C420mpeg2\nFRAME\n")
