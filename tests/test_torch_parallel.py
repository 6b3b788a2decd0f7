"""The port's dp/sp machinery on a mesh of CPU devices (``tpuvf_torch.
parallel``): `make_mesh`, the row bands and their halos, the standalone
`sharded_blur9` against tpuvf's, and data parallelism (`run_batched` with a
dp axis): contiguous sub-batches, per-shard state across batches and calls,
the tail-pad freeze, the `dp_shard_safe` guard, and a dp=1 run publishing
its state.  A device may repeat in a mesh: ``["cpu"] * n`` is the port's
counterpart of tpuvf's 8 virtual host devices.

Every sharded run is held bitwise to the port's own unsharded run.
"""

import numpy as np
import pytest
import torch

from tpuvf_torch.cli.launch import parse_pipeline
from tpuvf_torch.kernels import filter as kfilter
from tpuvf_torch.kernels import resample, sample
from tpuvf_torch.parallel import bands, halo, mesh as pmesh
from tpuvf_torch.parallel.mesh import make_mesh
from tpuvf_torch.runtime.params import from_tpuvf

torch.set_num_threads(1)

CPU8 = ["cpu"] * 8
BGRA = ("videotestsrc num-buffers={n} pattern=ball ! video/x-raw,format=BGRA,"
        "width=48,height=32 ! vfmetalvideofilter contrast=1.2 vignette=0.3 "
        "! appsink")
GREEDY = ("videotestsrc num-buffers={n} pattern=ball ! video/x-raw,format="
          "I420,width=48,height=32 ! vfmetaldeinterlace method=greedyh "
          "motion-threshold=0.3 ! appsink")


def _frames(p):
    return [f if isinstance(f, dict) else {"rgba": f}
            for f in p.sinks[0].frames]


def _run(desc, n, calls=None, batch_size=4, **kw):
    """The pipeline on the CPU, one run_batched call of each count in
    `calls` (default: one call of n)."""
    p = parse_pipeline(desc.format(n=n), device="cpu")
    p.negotiate()
    p.build()
    for count in calls or (n,):
        assert p.run_batched(count, batch_size=batch_size, **kw) == count
    return p


def _fed(frames):
    """GREEDY's chain on pushed I420 frames (an appsrc stream)."""
    p = parse_pipeline(
        "appsrc format=I420 width=48 height=32 ! vfmetaldeinterlace "
        "method=greedyh motion-threshold=0.3 ! appsink", device="cpu")
    for f in frames:
        p["appsrc0"].push(f)
    p["appsrc0"].end_of_stream()
    return p


def _i420(n, seed):
    rng = np.random.default_rng(seed)
    return [{"y": rng.integers(0, 256, (32, 48), dtype=np.uint8),
             "u": rng.integers(0, 256, (16, 24), dtype=np.uint8),
             "v": rng.integers(0, 256, (16, 24), dtype=np.uint8)}
            for _ in range(n)]


def _equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for k in w:
            np.testing.assert_array_equal(g[k], w[k])


# -- make_mesh ----------------------------------------------------------------


def test_make_mesh_shapes_and_order():
    m = make_mesh({"dp": 4, "sp": 2}, devices=CPU8)
    assert m.axis_names == ("dp", "sp")
    assert m.shape == {"dp": 4, "sp": 2}
    assert m.devices.shape == (4, 2)
    assert all(d == torch.device("cpu") for d in m.devices.flat)
    assert make_mesh(devices=CPU8[:3]).shape == {"dp": 3}
    # axes in either order: the runner reads dp first, then sp
    m2 = make_mesh({"sp": 2, "dp": 3}, devices=CPU8)
    lay = pmesh.layout(m2, "sp")
    assert (lay.dp, lay.sp) == (3, 2)
    assert lay.key == ((("dp", 3), ("sp", 2)), "sp")
    assert pmesh.layout(m2, None).sp == 1
    # a size-1 sp axis or an absent one: no bands
    assert pmesh.layout(make_mesh({"dp": 2, "sp": 1}, devices=CPU8),
                        "sp").sp == 1


def test_make_mesh_errors():
    with pytest.raises(ValueError, match="needs 8 devices, have 4"):
        make_mesh({"dp": 4, "sp": 2}, devices=CPU8[:4])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make_mesh({"dp": 1})
    with pytest.raises(ValueError, match="has no 'dp' axis"):
        pmesh.layout(make_mesh({"sp": 2}, devices=CPU8), "sp")


# -- bands --------------------------------------------------------------------


def test_plan_bands_windows():
    got = [(b.lo, b.hi, b.in_lo, b.in_hi)
           for b in bands.plan_bands(16, 16, 4, 6)]
    # 4 rows a band with a reach of 6: the halo spans two neighbours, and
    # the frame's edges take none
    assert got == [(0, 4, 0, 10), (4, 8, 0, 14), (8, 12, 2, 16),
                   (12, 16, 6, 16)]
    assert [(b.in_lo, b.in_hi) for b in bands.plan_bands(
        8, 24, 2, bands.ALL)] == [(0, 24), (0, 24)]
    with pytest.raises(ValueError, match="do not split"):
        bands.plan_bands(18, 18, 4, 0)
    with pytest.raises(ValueError, match="even"):
        bands.plan_bands(16, 16, 2, 3)
    assert bands.plane_rows(4, 12, 8, 16) == (2, 6)
    assert bands.plane_rows(10, 16, 8, 16) == (5, 8)


@pytest.mark.parametrize("lo,hi", [(0, 16), (3, 13), (6, 7), (0, 5)])
def test_window_and_halo_gather(lo, hi):
    x = torch.arange(2 * 16 * 3, dtype=torch.float32).reshape(2, 16, 3)
    pieces = bands.split_rows(x, ["cpu"] * 4)
    assert [tuple(p.shape) for p in pieces] == [(2, 4, 3)] * 4
    torch.testing.assert_close(bands.window(pieces, lo, hi, "cpu"),
                               x[:, lo:hi], rtol=0, atol=0)
    torch.testing.assert_close(bands.all_rows(pieces, "cpu"), x,
                               rtol=0, atol=0)
    # pad_rows_halo: the neighbours' rows, the frame's edge row replicated
    for s in range(4):
        got = bands.pad_rows_halo(pieces, s, 6, 5, "cpu")
        rows = torch.arange(s * 4 - 6, s * 4 + 4 + 5).clamp(0, 15)
        torch.testing.assert_close(got, x[:, rows], rtol=0, atol=0)


def test_band_trim_and_tables():
    band = bands.plan_bands(16, 16, 4, 2)[1]  # rows 4..8 from 2..10
    planes = {"y": torch.arange(8 * 2).reshape(8, 2),
              "u": torch.arange(4 * 1).reshape(4, 1)}
    out = band.trim(planes)
    torch.testing.assert_close(out["y"], planes["y"][2:6])
    torch.testing.assert_close(out["u"], planes["u"][1:3])
    assert bands.global_rows(band).tolist() == [4.0, 5.0, 6.0, 7.0]
    assert bands.global_rows(band, window=True).tolist() == list(
        np.arange(2.0, 10.0))
    table = np.arange(16)[:, None]
    assert bands.shard_rows(table, band).ravel().tolist() == [4, 5, 6, 7]


def test_band_taps_slice_and_rebase():
    """A band's row taps: the frame table's rows, rebased into the window,
    give the frame's rows bit for bit where the window holds their taps."""
    rng = np.random.default_rng(2)
    x = torch.from_numpy(rng.random((3, 12, 5), dtype=np.float32))
    t = sample.texcoords(24)
    taps = resample.make_taps(sample.plan_taps(t, 12, sample.LINEAR), 12,
                              "cpu")
    full = resample.resample_rows(x, taps)
    # output rows 8..16 read input rows 3..8; the window 2..10 holds them
    sub = resample.band_taps(taps, 8, 16, 2, 8)
    assert sub.in_size == 8 and sub.out_size == 8
    torch.testing.assert_close(resample.resample_rows(x[:, 2:10], sub),
                               full[:, 8:16], rtol=0, atol=0)
    with pytest.raises(ValueError, match="row taps only"):
        resample.band_taps(resample.make_col_taps(
            sample.plan_taps(t, 12, sample.LINEAR), 12, "cpu"), 0, 2, 0, 12)


# -- the standalone sharded blur ----------------------------------------------


@pytest.mark.parametrize("axes", [{"sp": 8}, {"dp": 2, "sp": 4}])
def test_sharded_blur9_matches_local_and_tpuvf(axes):
    import jax

    from tpuvf.parallel import halo as tpuvf_halo
    from tpuvf.parallel import mesh as tpuvf_mesh

    rng = np.random.default_rng(1)
    img = rng.random((4, 64, 40), np.float32)
    x = torch.from_numpy(img)
    got = halo.sharded_blur9(x, make_mesh(axes, devices=CPU8))
    local = kfilter.blur9(kfilter.blur9(x, axis=-1), axis=-2)
    torch.testing.assert_close(got, local, rtol=0, atol=0)
    if len(jax.devices()) < 8:
        pytest.skip("tpuvf's mesh needs 8 host devices")
    want = np.asarray(tpuvf_halo.sharded_blur9(
        jax.numpy.asarray(img), tpuvf_mesh.make_mesh(axes)))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=0)


# -- data parallelism ---------------------------------------------------------


@pytest.mark.parametrize("dp,sp", [(4, 1), (2, 2), (8, 1)])
def test_dp_batch_equals_unsharded(dp, sp):
    want = _frames(_run(BGRA, 8, batch_size=8))
    axes = {"dp": dp, "sp": sp} if sp > 1 else {"dp": dp}
    p = _run(BGRA, 8, batch_size=8, mesh=make_mesh(axes, devices=CPU8),
             sp_axis="sp" if sp > 1 else None)
    _equal(_frames(p), want)


def test_dp_shards_take_contiguous_frames_across_calls():
    """With independent streams, shard d runs frames [d*b/dp, (d+1)*b/dp)
    of each batch as its own stream, and its state resumes in the next
    call on a mesh of the same axes (`_mesh_state`): two calls of 8 on
    dp=2 equal each shard's 4 frames run twice as a stream of their own
    (each call's clock restarts at buffer 0, as tpuvf's)."""
    frames = _i420(8, seed=5)
    m = make_mesh({"dp": 2, "sp": 2}, devices=CPU8)
    p = _fed(frames)
    for _ in range(2):
        assert p.run_batched(8, batch_size=8, mesh=m, sp_axis="sp",
                             independent_streams=True) == 8
    got = _frames(p)
    for d in range(2):
        own = _fed(frames[4 * d:4 * d + 4])
        own.run_batched(4, batch_size=4)
        own.run_batched(4, batch_size=4)
        _equal(got[4 * d:4 * d + 4] + got[8 + 4 * d:12 + 4 * d],
               _frames(own))
    # dp > 1 leaves the stream state alone; each band carries its own
    key, states = p._mesh_state
    assert key == ((("dp", 2), ("sp", 2)), "sp")
    assert p.state["vfmetaldeinterlace0"]["has_prev"] is False
    assert len(states) == 2 and all(len(s) == 2 for s in states)
    assert all(b["vfmetaldeinterlace0"]["has_prev"] for s in states
               for b in s)
    # a call on other axes starts from the stream state, not the shards'
    p.sinks[0].frames.clear()
    p.run_batched(4, batch_size=4, mesh=make_mesh({"dp": 1, "sp": 2},
                                                  devices=CPU8),
                  sp_axis="sp")
    fresh = _fed(frames)
    fresh.run_batched(4, batch_size=4)
    _equal(_frames(p), _frames(fresh))


def test_dp_guard_and_optin():
    """tpuvf's dp_shard_safe guard: a stateful element refuses dp > 1
    unless independent_streams; a stateless chain needs no opt-in."""
    m = make_mesh({"dp": 4}, devices=CPU8)
    for desc, name in ((GREEDY, "vfmetaldeinterlace0"),
                       (BGRA.replace("vignette=0.3", "noise=0.2"),
                        "vfmetalvideofilter0")):
        p = parse_pipeline(desc.format(n=4), device="cpu")
        with pytest.raises(ValueError, match=name):
            p.run_batched(4, batch_size=4, mesh=m)
        assert p.run_batched(4, batch_size=4, mesh=m,
                             independent_streams=True) == 4
    p = parse_pipeline(GREEDY.format(n=4).replace("greedyh", "bob"),
                       device="cpu")
    assert p.run_batched(4, batch_size=4, mesh=m) == 4
    # dp == 1 needs no opt-in either
    p = parse_pipeline(GREEDY.format(n=4), device="cpu")
    assert p.run_batched(4, batch_size=4, mesh=make_mesh(
        {"dp": 1}, devices=CPU8)) == 4


@pytest.mark.parametrize("sp", [1, 2])
def test_tail_pad_freezes_state(sp):
    """A short last batch (6 frames at batch 4) pads in tpuvf with the
    state frozen across the phantom frames; dp=1 publishes the stream
    state, so the mesh calls followed by run() equal one sequential run
    (tpuvf's test_run_batched_tail_pad_freezes_state)."""
    want = _frames(_run(GREEDY, 10, calls=(6, 4)))
    axes = {"dp": 1, "sp": sp} if sp > 1 else {"dp": 1}
    p = parse_pipeline(GREEDY.format(n=10), device="cpu")
    m = make_mesh(axes, devices=CPU8)
    assert p.run_batched(6, batch_size=4, mesh=m,
                         sp_axis="sp" if sp > 1 else None) == 6
    key, states = p._mesh_state
    assert key == (tuple(sorted(axes.items())), "sp" if sp > 1 else None)
    assert len(states) == 1 and len(states[0]) == sp
    # the published stream state is the bands' joined
    prev = p.state["vfmetaldeinterlace0"]["prev"]
    assert tuple(prev.shape) == (4, 32, 48)
    assert p.run_batched(4, batch_size=4) == 4  # without a mesh: self.state
    _equal(_frames(p), want)


def test_dp1_publishes_and_resumes_state():
    want = _frames(_run(GREEDY, 12, calls=(4, 4, 4)))
    m = make_mesh({"dp": 1, "sp": 2}, devices=CPU8)
    p = parse_pipeline(GREEDY.format(n=12), device="cpu")
    p.run_batched(4, batch_size=4, mesh=m, sp_axis="sp")
    p.run_batched(4, batch_size=4, mesh=m, sp_axis="sp")  # _mesh_state
    p.run(4)  # the published state
    _equal(_frames(p), want)
    p.reset()
    assert p._mesh_state is None


def test_from_tpuvf_tiled_state():
    """tpuvf's tiled mesh state (a leading dp axis) -> one whole-frame port
    state per shard, which load_mesh_state cuts into bands."""
    prev = tuple(np.full((2, 32, 48), c, np.uint8) for c in range(4))
    tiled = {"prev": prev, "has_prev": np.array([True, False])}
    _, shards = from_tpuvf({}, tiled, "cpu", tiled=True)
    assert len(shards) == 2
    assert tuple(shards[0]["prev"].shape) == (4, 32, 48)
    assert shards[0]["prev"][3].eq(3).all()
    assert shards[0]["has_prev"] is True and shards[1]["has_prev"] is False
    _, counters = from_tpuvf({}, {"frame_index": np.array([5, 9], np.uint32)},
                             "cpu", tiled=True)
    assert [int(c["frame_index"]) for c in counters] == [5, 9]
    assert from_tpuvf({}, {}, "cpu", tiled=True)[1] == []
    p = parse_pipeline(GREEDY.format(n=4), device="cpu")
    m = make_mesh({"dp": 2, "sp": 2}, devices=CPU8)
    p.load_mesh_state(m, "sp", [{"vfmetaldeinterlace0": s} for s in shards])
    key, states = p._mesh_state
    band = states[1][1]["vfmetaldeinterlace0"]
    assert tuple(band["prev"].shape) == (4, 16, 48)
    assert band["has_prev"] is False
    with pytest.raises(ValueError, match="2 shard states for dp=4"):
        p.load_mesh_state(make_mesh({"dp": 4}, devices=CPU8), None,
                          [{}, {}])
