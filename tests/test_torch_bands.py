"""K1b's band plan (`sample.plan_col_bands`, `sample.stage_plan`) and K2's
choice of path, on the CPU.

The column kernel (csrc/resample.cu) reads each tile's input span from
shared memory at indices relative to the span, so the plan must hold every
index a tile reads inside that span; at tile 128 the spans are tpuvf's
`blockband_plan` of the same sampling matrix.  A CPU rendering of the
kernel's reads (each staged tile gathers from its rows' [lo4, lo4 + width)
slice, a direct tile from the whole row, with the kernel's separate
multiplies and add) must be torch.equal to `resample_cols_plain`: the plan
changes where the kernel reads, never what it computes.
"""

import re

import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from tpuvf.kernels import sample as tsample
from tpuvf_torch.core.formats import VideoFormat
from tpuvf_torch.core.spec import FrameSpec
from tpuvf_torch.kernels import _build, convert, emit, resample, sample

torch.set_num_threads(1)

GEOMETRIES = [
    # (in, out, filter, scale, descending)
    (1920, 3840, sample.LINEAR, 1.0, False),   # 4K chroma cols
    (959, 1918, sample.LINEAR, 1.0, False),    # 1918-wide NV12 chroma
    (1920, 640, sample.LINEAR, 1.0, False),    # chain (a) luma
    (1920, 1280, sample.LINEAR, 1.0, True),    # rotate-180
    (1440, 1920, sample.LINEAR, 0.75, False),  # pillarbox
    (960, 3840, sample.LINEAR, 0.25, False),   # whole tiles masked
    (3840, 480, sample.LINEAR, 1.0, False),    # spans wider than the budget
    (1920, 640, sample.NEAREST, 1.0, False),
    (37, 23, sample.NEAREST, 0.6, True),
    (5, 700, sample.LINEAR, 1.0, False),       # clamp-merged edge taps
]
IDS = [f"{i}-{o}-{f}-s{s}{'-desc' if d else ''}"
       for i, o, f, s, d in GEOMETRIES]


def table_of(in_size, out_size, filt, scale, descending):
    t = sample.texcoords(out_size, scale)
    mask = sample.coverage_mask(out_size, scale)
    if descending:
        t, mask = t[::-1].copy(), mask[::-1].copy()
    return sample.plan_taps(t, in_size, filt, mask)


def reference_spans(table, tile):
    """The spans by a loop over tiles: min and max + 1 of the live taps."""
    i0, i1, w0, w1 = table
    spans = []
    for c0 in range(0, len(i0), tile):
        cols = slice(c0, c0 + tile)
        live = np.concatenate([i0[cols][w0[cols] != 0],
                               i1[cols][w1[cols] != 0]])
        spans.append((live.min(), live.max() + 1) if len(live) else (0, 0))
    return np.array(spans, np.int64).reshape(-1, 2)


def check_bands(table, tile):
    i0, i1, w0, w1 = table
    span, k0, k1 = sample.plan_col_bands(table, tile)
    assert span.dtype == k0.dtype == k1.dtype == np.int32
    assert np.array_equal(span, reference_spans(table, tile))
    owner = np.arange(len(i0)) // tile
    lo, hi = span[owner, 0], span[owner, 1]
    for i, k, w in ((i0, k0, w0), (i1, k1, w1)):
        live = w != 0
        assert ((lo <= i) & (i < hi))[live].all()  # live taps in the span
        assert np.array_equal(k[live], i[live])  # and kept as they are
        # every index the tile reads is inside its span; an empty tile's 0
        assert np.where(hi > lo, (lo <= k) & (k < hi), k == 0).all()
    masked = (w0 == 0) & (w1 == 0)
    assert np.array_equal(k0[masked], lo[masked])
    assert np.array_equal(k1[masked], lo[masked])
    return span


def check_stages(span, in_size):
    stage, pitch = sample.stage_plan(span, in_size)
    lo4, width = stage[:, 0].astype(np.int64), stage[:, 1].astype(np.int64)
    lo, hi = span[:, 0], span[:, 1]
    assert pitch % 4 == 0 and 0 <= pitch <= sample.MAX_PITCH
    assert (width <= pitch).all() and (lo4 % 4 == 0).all()
    staged = width > 0
    assert ((lo4 <= lo) & (hi <= lo4 + width) & (lo4 + width <= in_size)
            )[staged].all()
    # the staged rows start and end on 16-byte boundaries where the row does
    assert (((lo4 + width) % 4 == 0) | (lo4 + width == in_size))[staged].all()
    hi4 = np.minimum(-(-hi // 4) * 4, in_size)
    assert np.array_equal(staged,
                          (hi > lo) & (hi4 - lo // 4 * 4 <= sample.MAX_PITCH))
    assert pitch == (-(-width.max(initial=0) // 4) * 4)
    return stage


def kernel_reads(x, taps):
    """The column kernel's reads and arithmetic, tile by tile, on the CPU."""
    out = torch.empty(x.shape[:-1] + (taps.out_size,), dtype=torch.float32)
    for t, (lo4, width) in enumerate(taps.stage.tolist()):
        cols = slice(t * sample.COL_TILE, (t + 1) * sample.COL_TILE)
        k0, k1 = taps.k[0, cols].long(), taps.k[1, cols].long()
        src = x[..., lo4:lo4 + width] if width else x
        if width:
            k0, k1 = k0 - lo4, k1 - lo4
            assert k0.min() >= 0 and k1.max() < width
        a = src.index_select(-1, k0)
        b = src.index_select(-1, k1)
        out[..., cols] = taps.w0[cols] * a + taps.w1[cols] * b
    return out


def check_kernel_reads(table, in_size, seed):
    taps = resample.make_col_taps(table, in_size, "cpu")
    x = torch.from_numpy(np.random.default_rng(seed).random(
        (2, 3, in_size), dtype=np.float32))
    assert torch.equal(kernel_reads(x, taps), resample.resample_cols_plain(
        x, taps))
    return taps


@pytest.mark.parametrize("in_size,out_size,filt,scale,descending",
                         GEOMETRIES, ids=IDS)
@pytest.mark.parametrize("tile", [128, sample.COL_TILE])
def test_band_plan_holds_every_tap_inside_its_tile(in_size, out_size, filt,
                                                   scale, descending, tile):
    check_bands(table_of(in_size, out_size, filt, scale, descending), tile)


@pytest.mark.parametrize("in_size,out_size,filt,scale,descending",
                         GEOMETRIES, ids=IDS)
def test_stage_plan_and_the_kernels_reads(in_size, out_size, filt, scale,
                                          descending):
    table = table_of(in_size, out_size, filt, scale, descending)
    stage = check_stages(check_bands(table, sample.COL_TILE), in_size)
    taps = check_kernel_reads(table, in_size, seed=in_size + out_size)
    assert torch.equal(taps.stage, torch.from_numpy(stage))
    assert resample.col_paths(taps) == (int((stage[:, 1] > 0).sum()),
                                        int((stage[:, 1] == 0).sum()))


def test_paths_of_the_chip_cases():
    """The geometries chip_smoke uses to drive each path of the kernel."""
    def paths(*geometry):
        taps = resample.make_col_taps(table_of(*geometry), geometry[0],
                                      "cpu")
        return resample.col_paths(taps)

    assert paths(1920, 3840, sample.LINEAR, 1.0, False) == (15, 0)
    assert paths(3840, 480, sample.LINEAR, 1.0, False) == (0, 2)  # too wide
    staged, direct = paths(960, 3840, sample.LINEAR, 0.25, False)
    assert direct >= 5 and staged >= 4  # masked tiles go direct


BLOCKBAND = [
    # (in, out, filter, scale, descending) where tpuvf returns a plan
    (960, 320, sample.LINEAR, 1.0, False),
    (640, 1280, sample.LINEAR, 1.0, False),
    (1920, 1280, sample.LINEAR, 1.0, True),
    (480, 640, sample.LINEAR, 0.75, False),
    (1920, 640, sample.NEAREST, 1.0, False),
]


@pytest.mark.parametrize("in_size,out_size,filt,scale,descending",
                         BLOCKBAND)
def test_spans_equal_tpuvf_blockband_plan(in_size, out_size, filt, scale,
                                          descending):
    t = tsample.texcoords(out_size, scale)
    mask = tsample.coverage_mask(out_size, scale)
    if descending:
        t, mask = t[::-1].copy(), mask[::-1].copy()
    plan = tsample.blockband_plan(tsample.sample_matrix(t, in_size, filt,
                                                        mask), tile=128)
    assert plan is not None
    span, _, _ = sample.plan_col_bands(
        sample.plan_taps(t, in_size, filt, mask), tile=128)
    assert [[lo, hi] for _, _, lo, hi in plan] == span.tolist()
    assert [(o0, o1) for o0, o1, _, _ in plan] == [
        (o0, min(o0 + 128, out_size)) for o0 in range(0, out_size, 128)]


@settings(max_examples=60, deadline=None, database=None, derandomize=True)
@given(in_size=st.integers(1, 900), out_size=st.integers(1, 900),
       filt=st.sampled_from([sample.LINEAR, sample.NEAREST]),
       scale=st.sampled_from([1.0, 0.9, 0.75, 0.5, 0.3]),
       descending=st.booleans(), tile=st.sampled_from([64, 128, 256]))
def test_band_plan_property(in_size, out_size, filt, scale, descending, tile):
    table = table_of(in_size, out_size, filt, scale, descending)
    check_bands(table, tile)
    check_stages(check_bands(table, sample.COL_TILE), in_size)
    check_kernel_reads(table, in_size, seed=in_size * 7 + out_size)


def test_stage_plan_budget_edges():
    # a span of exactly MAX_PITCH floats is staged, one float more is not
    span = np.array([[0, sample.MAX_PITCH], [4, sample.MAX_PITCH + 5],
                     [9, 9], [2, 7]], np.int32)
    stage, pitch = sample.stage_plan(span, 4096)
    assert stage.tolist() == [[0, sample.MAX_PITCH], [0, 0], [0, 0], [0, 8]]
    assert pitch == sample.MAX_PITCH
    # a row that ends off a 16-byte boundary: hi4 stops at the row's end
    stage, pitch = sample.stage_plan(np.array([[952, 959]], np.int32), 959)
    assert stage.tolist() == [[952, 7]] and pitch == 8


def test_kernel_constants_are_the_plans():
    src = (_build.SOURCE_DIR / "resample.cu").read_text()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))

    assert const("kColTile") == sample.COL_TILE
    assert const("kMaxPitch") == sample.MAX_PITCH


# -- K2: the vector path or the scalar path ----------------------------------


@pytest.mark.parametrize("w,h,vector", [(640, 480, True), (637, 479, False),
                                        (1918, 1080, True), (962, 541, False)])
def test_vector_path_of_the_samplers_stacked_chroma(w, h, vector):
    """convert.plan_rgba_sampler hands K2 `u` and `v` as views into one
    stacked (2, H, W) float32 tensor: `v` starts at H*W*4 bytes, on the 16
    bytes of the kernel's float4 access only when H*W % 4 == 0, which its
    vector path also needs of the (4, H, W) output (csrc/emit.cu
    `vector_path`); otherwise the launch takes the scalar path."""
    spec = FrameSpec(VideoFormat.NV12, w, h)
    run = convert.plan_rgba_sampler(spec, w, h, "cpu")
    rng = np.random.default_rng(w)
    cw, ch = (w + 1) // 2, (h + 1) // 2
    planes = {k: torch.from_numpy(rng.integers(0, 256, shape, np.uint8))
              .clone() for k, shape in (("y", (h, w)), ("u", (ch, cw)),
                                        ("v", (ch, cw)))}
    src = run(planes)
    assert src["u"]._base is src["v"]._base is not None  # one stacked tensor
    assert (src["v"].data_ptr() - src["u"].data_ptr()) == h * w * 4
    assert (src["v"].data_ptr() % 16 == 0) == vector
    assert ((h * w) % 4 == 0) == vector


def test_vector_path_is_exported_for_reports():
    """chip_smoke names each K2 case's path by asking the library the rule
    the launch applies; the export's arity is the declaration's."""
    src = (_build.SOURCE_DIR / "emit.cu").read_text()
    decl = re.search(r'^extern "C" int emit_vector_path\(([^)]*)\)', src,
                     re.M)
    assert decl is not None
    assert len(decl.group(1).split(",")) == len(
        _build.SIGNATURES["emit_vector_path"])
    assert "vector_path(src, sizeof(T)" in src  # the launch's own choice


# -- which axis carries the band plan -----------------------------------------


def test_row_taps_carry_no_band_plan():
    table = table_of(1080, 2160, sample.LINEAR, 1.0, False)
    rows = resample.make_taps(table, 1080, "cpu")
    assert rows.k is None and rows.stage is None and rows.pitch == 0
    cols = resample.make_col_taps(table, 1080, "cpu")
    assert all(torch.equal(a, b) for a, b in zip(rows[:4], cols[:4]))
    assert cols.k.shape == (2, 2160) and cols.pitch > 0
    with pytest.raises(ValueError, match="band plan"):
        resample.resample_cols(torch.zeros(2, 4, 1080), rows)


@pytest.mark.parametrize("fmt,w,h,out_w,out_h", [
    (VideoFormat.NV12, 64, 36, 32, 48),
    (VideoFormat.RGBA, 40, 30, 96, 24),
    (VideoFormat.I420, 37, 23, 37, 41),
])
def test_samplers_plan_bands_for_columns_only(fmt, w, h, out_w, out_h,
                                              monkeypatch):
    """convert's samplers hand K1 row taps without a band plan and K1b
    column taps with one."""
    seen = set()
    for name in ("resample_rows", "resample_cols"):
        real = getattr(convert, name)
        monkeypatch.setattr(
            convert, name, lambda x, taps, _n=name, _f=real:
            seen.add((_n, taps.k is not None)) or _f(x, taps))
    rng = np.random.default_rng(w * h)

    def u8(*shape):
        return torch.from_numpy(rng.integers(0, 256, shape, np.uint8))

    if fmt == VideoFormat.RGBA:
        planes = {"rgba": u8(4, h, w)}
    else:
        cw, ch = (w + 1) // 2, (h + 1) // 2
        planes = {"y": u8(h, w), "u": u8(ch, cw), "v": u8(ch, cw)}
    run = convert.plan_rgba_sampler(FrameSpec(fmt, w, h), out_w, out_h, "cpu")
    run(planes)
    assert seen == {("resample_rows", False), ("resample_cols", True)}
    seen.clear()
    run = convert.plan_texcoord_sampler(w, h, sample.texcoords(out_h),
                                        sample.texcoords(out_w), "cpu")
    assert run(u8(2, h, w)).shape == (2, out_h, out_w)
    assert seen == {("resample_rows", False), ("resample_cols", True)}
