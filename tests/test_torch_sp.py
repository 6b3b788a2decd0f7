"""Spatial (sp) row sharding in the port: every vf element class, and
chains of them, through ``run_batched(mesh=make_mesh({"dp": 1, "sp": n},
devices=["cpu"] * n), sp_axis="sp")``, each held bitwise to the port's own
unsharded ``run_batched`` on the same frames.

The cases cover each band build's form: the row-local and stencil
elements with their halos (the 4:2:0 chroma row upsample, the 9-tap blur,
the deinterlacers' field stencil and their banded previous frame), the
frame-global row structure (a resampling over H, every vftransform method),
the coordinate fields (vignette, grain, the letterbox mask, an overlay
rect across band edges) and the compositor (a banded canvas, replicated
pad branches, a folded overlay).  Three frames at batch 2, so a short last
batch and the carried state are in every run; the frames are seeded colour
noise (a gray pattern would leave the chroma halos untested) whose top
half stands still.  64x16 NV12 with sharpness
on sp=4 is the 4-rows-a-band case, where the 6-row reach of the chroma
upsample and the blur spans two neighbours.
"""

import numpy as np
import pytest
import torch

from tpuvf_torch.cli.launch import parse_pipeline
from tpuvf_torch.elements.testsrc import rgba_to_host
from tpuvf_torch.io import png
from tpuvf_torch.parallel.mesh import make_mesh

torch.set_num_threads(1)

def _src(fmt, w=64, h=48, pattern="noise"):
    """A source: an appsrc fed seeded colour noise whose top half stands
    still (`_feed`), or a videotestsrc `pattern`."""
    if pattern == "noise":
        return f"appsrc format={fmt} width={w} height={h}"
    return (f"videotestsrc num-buffers=3 pattern={pattern} ! video/x-raw,"
            f"format={fmt},width={w},height={h}")


def _feed(pipe):
    """Push 3 frames of seeded RGBA noise, in each appsrc's format, whose
    top half repeats frame 0's (so greedy-H weaves there and bobs below)."""
    rng = np.random.default_rng(7)
    for src in pipe.sources:
        if src.ELEMENT_NAME != "appsrc":
            continue
        spec = pipe._outgoing(src)[0].spec
        first = rng.integers(0, 256, (spec.height, spec.width, 4),
                             dtype=np.uint8)
        for _ in range(3):
            rgba = first.copy()
            rgba[spec.height // 2:] = rng.integers(
                0, 256, rgba[spec.height // 2:].shape, dtype=np.uint8)
            src.push(rgba_to_host(rgba, spec))
        src.end_of_stream()


CASES = {
    # vfconvertscale
    "cs-nv12-bgra": _src("NV12") + " ! vfmetalconvertscale ! "
                    "video/x-raw,format=BGRA ! appsink",
    "cs-scale-down": _src("NV12") + " ! vfmetalconvertscale ! "
                     "video/x-raw,format=BGRA,width=40,height=32 ! appsink",
    "cs-scale-up-nearest": _src("I420", 32, 24) + " ! vfmetalconvertscale "
                           "method=nearest ! video/x-raw,format=I420,"
                           "width=48,height=32 ! appsink",
    "cs-letterbox": _src("BGRA") + " ! vfmetalconvertscale add-borders=true "
                    "border-color=0xFF2040C0 ! video/x-raw,width=32,"
                    "height=32 ! appsink",
    "cs-uyvy-in": _src("UYVY") + " ! vfmetalconvertscale ! "
                  "video/x-raw,format=BGRA ! appsink",
    "cs-yuy2-out": _src("NV12") + " ! vfmetalconvertscale ! "
                   "video/x-raw,format=YUY2 ! appsink",
    # vfvideofilter
    "vf-rgb-effects": _src("BGRA") + " ! vfmetalvideofilter sharpness=0.7 "
                      "saturation=1.4 vignette=0.3 hue=0.2 gamma=1.3 "
                      "sepia=0.3 invert=true chroma-key-enabled=true ! "
                      "appsink",
    "vf-nv12-blur": _src("NV12") + " ! vfmetalvideofilter "
                    "sharpness=-0.6 brightness=0.1 vignette=0.2 ! appsink",
    "vf-noise": _src("NV12") + " ! vfmetalvideofilter noise=0.4 "
                "contrast=1.1 ! appsink",
    "vf-lut": _src("I420") + " ! vfmetalvideofilter lut-file={lut} "
              "contrast=1.1 ! appsink",
    "vf-4-rows-a-band": _src("NV12", 64, 16) + " ! vfmetalvideofilter "
                        "sharpness=0.8 ! appsink",
    "vf-bgra-odd-width": _src("BGRA", 63, 16) + " ! vfmetalvideofilter "
                         "sharpness=0.6 vignette=0.5 ! appsink",
    # vfdeinterlace
    **{f"di-{m}-{fmt.lower()}": _src(fmt)
       + f" ! vfmetaldeinterlace method={m} motion-threshold=0.3 ! appsink"
       for m in ("bob", "weave", "linear", "greedyh")
       for fmt in ("I420", "BGRA")},
    "di-bff-nv12": _src("NV12") + " ! vfmetaldeinterlace "
                   "method=greedyh field-layout=bottom-field-first ! appsink",
    # vftransform
    "tr-vflip": _src("BGRA") + " ! vfmetaltransform method=vertical-flip "
                "! appsink",
    "tr-180-nv12": _src("NV12") + " ! vfmetaltransform method=rotate-180 ! "
                   "appsink",
    "tr-cw-square": _src("NV12", 48, 48) + " ! vfmetaltransform "
                    "method=clockwise ! appsink",
    "tr-diag-square": _src("BGRA", 32, 32) + " ! vfmetaltransform "
                      "method=upper-right-diagonal ! appsink",
    "tr-cw-crop": _src("BGRA") + " ! vfmetaltransform method=clockwise "
                  "crop-left=8 crop-top=4 ! appsink",
    "tr-ccw-nv12": _src("NV12") + " ! vfmetaltransform "
                   "method=counterclockwise crop-right=6 ! appsink",
    "tr-hflip-crop": _src("I420") + " ! vfmetaltransform "
                     "method=horizontal-flip crop-bottom=10 ! appsink",
    # vfoverlay: the rect crosses band edges
    "ov-rgb": _src("BGRA") + " ! vfmetaloverlay location={png} x=5 y=9 "
              "alpha=0.7 ! appsink",
    "ov-nv12-stretched": _src("NV12") + " ! vfmetaloverlay location={png} "
                         "relative-x=0.3 y=7 width=30 height=31 ! appsink",
    # vfcompositor: a banded canvas, replicated pads
    "comp-nv12-checker": (
        "vfcompositor name=c background=checker sink_0::xpos=-3 "
        "sink_0::ypos=-5 sink_1::xpos=10 sink_1::ypos=13 sink_1::alpha=0.6 "
        "sink_1::operator=add ! video/x-raw,format=NV12,width=64,height=48 "
        "! appsink " + _src("NV12", 60, 40, "smpte") + " ! c.sink_0 "
        + _src("BGRA", 24, 20) + " ! vfmetalvideofilter contrast=1.3 ! "
        "c.sink_1"),
    "comp-folded-overlay": (
        "vfcompositor name=c background=checker sink_1::xpos=10 "
        "sink_1::ypos=13 sink_1::width=30 sink_1::height=17 "
        "! video/x-raw,format=BGRA,width=64,height=48 ! vfmetaloverlay "
        "location={png} x=3 y=21 ! appsink " + _src("NV12", 60, 40, "smpte")
        + " ! c.sink_0 " + _src("I420", 24, 20) + " ! vfmetaldeinterlace "
        "method=weave ! c.sink_1"),
    "comp-odd-pads": (
        "vfcompositor name=c sink_1::xpos=7 sink_1::ypos=21 ! video/x-raw,"
        "format=I420,width=64,height=48 ! appsink " + _src("NV12", 61, 37)
        + " ! vfmetalvideofilter contrast=1.2 ! c.sink_0 "
        + _src("BGRA", 30, 25) + " ! c.sink_1"),
    # chains and fan-out
    "chain-mixed": _src("NV12") + " ! vfmetaldeinterlace method=linear ! "
                   "vfmetalvideofilter sharpness=0.5 vignette=0.4 ! "
                   "vfmetalconvertscale ! video/x-raw,format=BGRA,width=48,"
                   "height=32 ! appsink",
    "tee-two-sinks": _src("NV12") + " ! vfmetalvideofilter sharpness=0.4 ! "
                     "tee name=t t. ! queue ! appsink name=a t. ! queue ! "
                     "vfmetalconvertscale ! video/x-raw,format=BGRA ! "
                     "appsink name=b",
}


@pytest.fixture(scope="module")
def assets(tmp_path_factory):
    d = tmp_path_factory.mktemp("sp")
    rng = np.random.default_rng(3)
    art = rng.integers(0, 256, (10, 12, 4), dtype=np.uint8)
    art[..., 3] = 180
    png.write(str(d / "ov.png"), art)
    size = 5
    g = np.linspace(0.0, 1.0, size)
    table = np.stack(np.meshgrid(g, g, g, indexing="ij"), -1)[..., ::-1]
    table = np.clip(table ** 0.8 + rng.normal(0, 0.02, table.shape), 0, 1)
    lines = [f"LUT_3D_SIZE {size}"] + [
        " ".join(f"{v:.6f}" for v in table[b, gg, r])
        for b in range(size) for gg in range(size) for r in range(size)]
    (d / "lut.cube").write_text("\n".join(lines) + "\n")
    return {"png": str(d / "ov.png"), "lut": str(d / "lut.cube")}


def _frames(pipe):
    out = {}
    for sink in pipe.sinks:
        out[sink.name] = [f if isinstance(f, dict) else {"rgba": f}
                          for f in sink.frames]
    return out


def _run(desc, mesh=None):
    p = parse_pipeline(desc, device="cpu")
    p.negotiate()
    _feed(p)
    p.build()
    assert p.run_batched(3, batch_size=2, mesh=mesh,
                         sp_axis=None if mesh is None else "sp") == 3
    return _frames(p)


@pytest.mark.parametrize("sp", [2, 4])
@pytest.mark.parametrize("case", sorted(CASES))
def test_sp_bitwise_against_unsharded(case, sp, assets):
    desc = CASES[case].format(**assets)
    want = _run(desc)
    got = _run(desc, make_mesh({"dp": 1, "sp": sp}, devices=["cpu"] * sp))
    assert got.keys() == want.keys()
    for name in want:
        assert len(got[name]) == len(want[name]) == 3
        for i, (g, w) in enumerate(zip(got[name], want[name])):
            assert g.keys() == w.keys()
            for k in w:
                assert g[k].shape == w[k].shape, (name, i, k)
                np.testing.assert_array_equal(g[k], w[k],
                                              err_msg=f"{name} {i} {k}")
    # a distinct output per frame: the frames are not one repeated
    first = next(iter(want.values()))
    assert any(not np.array_equal(first[0][k], first[1][k])
               for k in first[0])
