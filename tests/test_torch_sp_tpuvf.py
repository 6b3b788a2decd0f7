"""The port's mesh runs against tpuvf's own (``tpuvf.parallel``, on the
8 virtual host devices of tests/conftest.py), under TPUVF_NO_SPLIT_LINKS=1
(every element boundary canonical, the dataflow the port implements).

tpuvf's sharded run is bitwise equal to its unsharded run
(tests/test_sp_sharding.py) and the port's to its own
(tests/test_torch_sp.py); between the two packages the contract is
ROADMAP's: at most 1 LSB for the knife-edge classes (the b/c/s fold, the
resampling re-expressions, FMA contraction in tpuvf's compiled code), and
for film grain tpuvf's tolerance with an outlier allowance
(test_sp_sharding.py:172).  The port's mesh runs on ``["cpu"] * n``.
tpuvf's shard_map programs compile slowly, so the cases are few.
"""

import numpy as np
import pytest
import torch

import jax

from tpuvf.cli.launch import parse_pipeline as tpuvf_parse
from tpuvf.io import png as tpuvf_png
from tpuvf.parallel import mesh as tpuvf_mesh
from tpuvf_torch.cli.launch import parse_pipeline as port_parse
from tpuvf_torch.elements.testsrc import rgba_to_host
from tpuvf_torch.parallel.mesh import make_mesh
from tpuvf_torch.runtime.params import from_tpuvf

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _canonical(monkeypatch):
    monkeypatch.setenv("TPUVF_NO_SPLIT_LINKS", "1")
    if len(jax.devices()) < 8:
        pytest.skip("tpuvf's mesh needs 8 host devices")


def _frames(p):
    return [f if isinstance(f, dict) else {"rgba": f}
            for f in p.sinks[0].frames]


def _both(desc, n, axes, batch_size=None):
    """(tpuvf frames, port frames, the two pipelines) of one mesh call of
    n frames each."""
    out = []
    for parse, mesh in ((tpuvf_parse, tpuvf_mesh.make_mesh(axes)),
                        (lambda d: port_parse(d, device="cpu"),
                         make_mesh(axes, devices=["cpu"] * 8))):
        p = parse(desc)
        p.negotiate()
        _feed(p, n)
        p.build()
        p.run_batched(n, batch_size=batch_size or n, mesh=mesh,
                      sp_axis="sp" if "sp" in axes else None)
        out.append(p)
    return _frames(out[0]), _frames(out[1]), out


def _feed(p, n):
    """Push n frames of seeded colour noise into each appsrc (the same
    frames into both packages' pipelines)."""
    rng = np.random.default_rng(9)
    for src in p.sources:
        if src.ELEMENT_NAME == "appsrc":
            spec = p._outgoing(src)[0].spec
            for _ in range(n):
                src.push(rgba_to_host(rng.integers(
                    0, 256, (spec.height, spec.width, 4), dtype=np.uint8),
                    spec))
            src.end_of_stream()


def _within(got, want, lsb=1):
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for k in w:
            d = np.abs(g[k].astype(np.int32) - w[k].astype(np.int32))
            assert d.max() <= lsb, (k, int(d.max()))


@pytest.mark.parametrize("desc,axes", [
    # tpuvf's test_sp_dp_full_pipeline_bit_exact: both stencil classes
    ("videotestsrc num-buffers=4 pattern=ball ! video/x-raw,format=NV12,"
     "width=64,height=48 ! vfmetaldeinterlace method=bob ! "
     "vfmetalvideofilter sharpness=0.5 contrast=1.2 vignette=0.4 ! appsink",
     {"dp": 4, "sp": 2}),
    # the RGB blur halo with saturation and vignette (test_sp_rgb_chain)
    ("videotestsrc num-buffers=4 pattern=snow ! video/x-raw,format=BGRA,"
     "width=64,height=64 ! vfmetalvideofilter sharpness=0.7 saturation=1.4 "
     "vignette=0.3 ! appsink", {"dp": 2, "sp": 4}),
    # the 4:2:0 chroma row upsample halo into a conversion (colour noise:
    # a gray pattern has constant chroma)
    ("appsrc format=NV12 width=64 height=64 ! vfmetalconvertscale ! "
     "video/x-raw,format=BGRA ! vfmetalvideofilter contrast=1.1 ! appsink",
     {"dp": 2, "sp": 4}),
    # a resampling over H: every row gathered, the band's rows computed
    ("appsrc format=NV12 width=64 height=48 ! vfmetalconvertscale ! "
     "video/x-raw,format=BGRA,width=32,height=24 ! appsink",
     {"dp": 2, "sp": 2}),
    # a rotation with crops
    ("videotestsrc num-buffers=4 pattern=snow ! video/x-raw,format=BGRA,"
     "width=64,height=48 ! vfmetaltransform method=clockwise crop-left=8 "
     "crop-top=4 ! appsink", {"dp": 1, "sp": 4}),
], ids=["bob-blur", "rgb-blur", "nv12-convert", "scaled", "transform"])
def test_mesh_run_matches_tpuvf(desc, axes):
    want, got, _ = _both(desc, 4, axes)
    _within(got, want)


def test_overlay_rect_across_bands_matches_tpuvf(tmp_path):
    """tpuvf's test_sp_overlay_chain_bit_exact: the rect straddles band
    edges, in both formats."""
    img = np.zeros((20, 24, 4), np.uint8)
    img[..., 0] = 230
    img[..., 3] = 150
    ov = str(tmp_path / "ov.png")
    tpuvf_png.write(ov, img)
    for fmt in ("BGRA", "NV12"):
        want, got, _ = _both(
            f"videotestsrc num-buffers=2 pattern=smpte ! video/x-raw,"
            f"format={fmt},width=64,height=64 ! vfmetaloverlay "
            f"location={ov} x=10 y=20 alpha=0.7 ! appsink", 2,
            {"dp": 2, "sp": 4})
        _within(got, want)


def test_stateful_chain_two_batches_matches_tpuvf():
    """tpuvf's test_sp_stateful_full_chain_bit_exact (weave): rows over
    sp=8, two batches of 3 on dp=1, so the banded previous frame crosses a
    batch; then tpuvf's tiled state, carried into the port through
    from_tpuvf(tiled=True) and load_mesh_state, gives tpuvf's next call."""
    desc = ("videotestsrc num-buffers=6 pattern=ball ! video/x-raw,format="
            "NV12,width=64,height=48 ! vfmetaldeinterlace method=weave ! "
            "vfmetalvideofilter sharpness=0.5 contrast=1.2 ! appsink")
    axes = {"dp": 1, "sp": 8}
    want, got, (tp, pp) = _both(desc, 6, axes, batch_size=3)
    _within(got, want)
    # the port's second call from tpuvf's carried state
    key, tiled = tp._mesh_state
    shards = [{} for _ in range(axes["dp"])]
    for name, st in tiled.items():
        for d, s in enumerate(from_tpuvf({}, st, "cpu", tiled=True)[1]):
            shards[d][name] = s
    fresh = port_parse(desc, device="cpu")
    fresh.load_mesh_state(make_mesh(axes, devices=["cpu"] * 8), "sp", shards)
    tp.sinks[0].frames.clear()
    tp.run_batched(6, batch_size=3, mesh=tpuvf_mesh.make_mesh(axes),
                   sp_axis="sp")
    fresh.run_batched(6, batch_size=3, mesh=make_mesh(
        axes, devices=["cpu"] * 8), sp_axis="sp")
    _within(_frames(fresh), _frames(tp))
    # and the port's own continuation agrees with it bitwise
    pp.sinks[0].frames.clear()
    pp.run_batched(6, batch_size=3, mesh=make_mesh(axes, devices=["cpu"] * 8),
                   sp_axis="sp")
    for a, b in zip(_frames(fresh), _frames(pp)):
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])


def test_grain_within_tpuvf_tolerance():
    """tpuvf's test_sp_grain_within_tolerance (<= 4 LSB, an outlier share
    under 1%: the grain hash is chaotic under FMA) on top of the 1-LSB
    knife edge of the contrast fold, which the port's unsharded run already
    shows against tpuvf's on 1.2% of these luma values: under 1% of values
    more than 1 LSB apart."""
    want, got, _ = _both(
        "videotestsrc num-buffers=2 pattern=ball ! video/x-raw,format=NV12,"
        "width=64,height=48 ! vfmetalvideofilter noise=0.4 contrast=1.1 ! "
        "appsink", 2, {"dp": 1, "sp": 8})
    for g, w in zip(got, want):
        for k in w:
            d = np.abs(g[k].astype(np.int32) - w[k].astype(np.int32))
            assert d.max() <= 4
            assert (d > 1).mean() < 0.01
