"""The port's sp/dp gate against tpuvf's, under TPUVF_NO_SPLIT_LINKS=1
(tpuvf's canonical builds, where its predicates answer with `_linked_quad`
False and `_validate_sp` runs at phase granularity 1).

Over a grid of pipelines and meshes, each built in both packages: every
active stage's `sp_row_shardable` and `dp_shard_safe`, the sp plan
(`_sp_plan`'s replicated branches and graph check), and whether
`_validate_sp` accepts the mesh or refuses it with the same error (an
element's refusal compared up to its specs, whose text differs between
the packages).  Then the dp guard's refusal, word for word.
"""

import numpy as np
import pytest

import jax

from tpuvf.cli.launch import parse_pipeline as tpuvf_parse
from tpuvf.io import png as tpuvf_png
from tpuvf.parallel import mesh as tpuvf_mesh
from tpuvf_torch.cli.launch import parse_pipeline as port_parse
from tpuvf_torch.parallel.mesh import make_mesh


@pytest.fixture(autouse=True)
def _canonical(monkeypatch):
    monkeypatch.setenv("TPUVF_NO_SPLIT_LINKS", "1")
    if len(jax.devices()) < 8:
        pytest.skip("tpuvf's mesh needs 8 host devices")


@pytest.fixture(scope="module")
def ov_png(tmp_path_factory):
    path = tmp_path_factory.mktemp("gate") / "ov.png"
    img = np.full((6, 8, 4), 200, np.uint8)
    tpuvf_png.write(str(path), img)
    return str(path)


def _src(fmt, w, h):
    return (f"videotestsrc num-buffers=2 ! video/x-raw,format={fmt},"
            f"width={w},height={h}")


GRID = {
    "vf-nv12": _src("NV12", 64, 48) + " ! vfmetalvideofilter contrast=1.2 "
               "! appsink",
    "vf-nv12-40": _src("NV12", 64, 40) + " ! vfmetalvideofilter "
                  "sharpness=0.3 ! appsink",
    "vf-nv12-odd-width": _src("NV12", 63, 48) + " ! vfmetalvideofilter "
                         "contrast=1.2 ! appsink",
    "vf-i420-36": _src("I420", 64, 36) + " ! vfmetalvideofilter "
                  "noise=0.2 ! appsink",
    "vf-bgra-odd": _src("BGRA", 63, 16) + " ! vfmetalvideofilter "
                   "contrast=1.2 ! appsink",
    "di-i420-62": _src("I420", 62, 48) + " ! vfmetaldeinterlace "
                         "method=greedyh ! appsink",
    "di-i420-odd": _src("I420", 63, 48) + " ! vfmetaldeinterlace "
                   "method=bob ! appsink",
    "di-bgra-weave": _src("BGRA", 63, 32) + " ! vfmetaldeinterlace "
                     "method=weave ! appsink",
    "cs-scale-30": _src("NV12", 64, 48) + " ! vfmetalconvertscale ! "
                   "video/x-raw,format=BGRA,width=40,height=30 ! appsink",
    "cs-uyvy": _src("UYVY", 64, 32) + " ! vfmetalconvertscale ! "
               "video/x-raw,format=NV12 ! appsink",
    "tr-cw": _src("BGRA", 64, 48) + " ! vfmetaltransform method=clockwise "
             "crop-top=4 ! appsink",
    "ov-nv12": _src("NV12", 64, 48) + " ! vfmetaloverlay location={png} "
               "x=3 y=5 ! appsink",
    "ov-nv12-odd": _src("NV12", 63, 48) + " ! vfmetaloverlay "
                   "location={png} ! appsink",
    "ov-missing": _src("NV12", 63, 48) + " ! vfmetaloverlay "
                  "location=/nonexistent.png ! vfmetalvideofilter "
                  "contrast=1.1 ! appsink",
    "comp-pads": ("vfcompositor name=c sink_1::xpos=7 ! video/x-raw,"
                  "format=NV12,width=64,height=48 ! appsink "
                  + _src("NV12", 61, 37) + " ! vfmetalvideofilter "
                  "contrast=1.2 ! c.sink_0 " + _src("BGRA", 30, 25)
                  + " ! c.sink_1"),
    "comp-tee-both": ("vfcompositor name=c ! video/x-raw,format=BGRA,"
                      "width=64,height=48 ! appsink name=a "
                      + _src("BGRA", 64, 48) + " ! tee name=t t. ! queue ! "
                      "c.sink_0 t. ! queue ! appsink name=b"),
}
MESHES = [{"dp": 1, "sp": 2}, {"dp": 2, "sp": 4}, {"dp": 1, "sp": 8},
          {"dp": 4, "sp": 1}]


def _build(parse, desc):
    p = parse(desc)
    p.negotiate()
    p.build()
    return p


def _verdict(p, mesh, sp_axis):
    try:
        p._validate_sp(mesh, sp_axis)
    except ValueError as exc:
        return str(exc).split(" for its negotiated specs")[0]
    return "ok"


@pytest.mark.parametrize("case", sorted(GRID))
def test_gate_matches_tpuvf(case, ov_png):
    desc = GRID[case].format(png=ov_png)
    tp = _build(tpuvf_parse, desc)
    pp = _build(lambda d: port_parse(d, device="cpu"), desc)
    t_stages = {st.element.name: st for st in tp._stages
                if not st.passthrough}
    p_stages = {st.element.name: st for st in pp.stages if not st.passthrough}
    assert t_stages.keys() == p_stages.keys()
    for name, pst in p_stages.items():
        tst = t_stages[name]
        assert (pst.element.sp_row_shardable(pst.in_spec, pst.out_spec)
                == tst.element.sp_row_shardable(tst.in_spec, tst.out_spec)
                ), name
        if pst.in_spec is not None:
            assert (pst.element.dp_shard_safe(pst.in_spec, pst.out_spec)
                    == tst.element.dp_shard_safe(tst.in_spec,
                                                 tst.out_spec)), name
    assert (pp._sp_replicated, pp._sp_rep_sources, pp._sp_graph_ok) == (
        tp._sp_replicated, tp._sp_rep_sources, tp._sp_graph_ok)
    assert sorted(pp._sp_heights()) == sorted(tp._sp_heights())
    for axes in MESHES:
        port_mesh = make_mesh(axes, devices=["cpu"] * 8)
        tpuvf_mesh_ = tpuvf_mesh.make_mesh(axes)
        assert (_verdict(pp, port_mesh, "sp")
                == _verdict(tp, tpuvf_mesh_, "sp")), axes
    # an sp axis the mesh lacks
    assert _verdict(pp, make_mesh({"dp": 2}, devices=["cpu"] * 2), "sp") \
        == _verdict(tp, tpuvf_mesh.make_mesh({"dp": 2}), "sp")


@pytest.mark.parametrize("case", ["di-i420-62", "vf-i420-36"])
def test_dp_guard_message_matches_tpuvf(case):
    errors = []
    for parse, mesh in ((tpuvf_parse, tpuvf_mesh.make_mesh({"dp": 2})),
                        (lambda d: port_parse(d, device="cpu"),
                         make_mesh({"dp": 2}, devices=["cpu"] * 2))):
        p = _build(parse, GRID[case])
        with pytest.raises(ValueError) as err:
            p.run_batched(2, batch_size=2, mesh=mesh)
        errors.append(str(err.value))
    assert errors[0] == errors[1]
    assert "independent_streams=True" in errors[1]
