"""The vfoverlay fold: a vfoverlay after a vfcompositor with an RGB output
becomes a final mix draw of the compositor's K4 fold (port of tpuvf's
``_plan_overlay_folds``, ``tpuvf/runtime/pipeline.py:541-606``, and its
``apply_folds``, ``tpuvf/elements/compositor.py:676-686``), and K4's
per-draw choice of the vector path.

Tolerances, per case:
- the fold's plain version against a transcription of tpuvf's
  ``render_fast`` + ``apply_folds`` run op by op (``jax.disable_jit``):
  bitwise;
- the port's pipeline against tpuvf's pipeline run op by op: bitwise for
  RGB pads at identity (tests/test_torch_compositor.py);
- against tpuvf's compiled pipeline, where XLA may contract the blends into
  an FMA: <= 1 LSB.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_composite import (
    BG_FLOATS,
    make_draw,
    tpuvf_fold,
)
from tpuvf.cli.launch import parse_pipeline as tpuvf_parse
from tpuvf.io import png as tpng
from tpuvf.kernels.color import dequant as t_dequant, quant as t_quant
from tpuvf_torch.cli.launch import parse_pipeline as port_parse
from tpuvf_torch.elements import overlay as eov
from tpuvf_torch.kernels.composite import (
    OP_ADD,
    OP_OVER,
    Background,
    Draw,
    background_colors,
    composite_fold_plain,
    draw_vector_path,
    pack_draws,
)
from tpuvf_torch.kernels.overlay import overlay_rect

torch.set_num_threads(1)


def tpuvf_apply_folds(dst, mixes):
    """tpuvf's apply_folds (compositor.py:676-686) on a (4, H, W) uint8
    canvas, op by op: [(planes (4, h, w) float32, rect (x0, x1, y0, y1),
    alpha)]."""
    dst = [jnp.asarray(dst[c]) for c in range(4)]
    with jax.disable_jit():
        for planes, (fx0, fx1, fy0, fy1), alpha in mixes:
            ov = jnp.asarray(planes)
            a = ov[3] * np.float32(alpha)
            for c in range(3):  # alpha channel untouched
                v = t_dequant(dst[c][fy0:fy1, fx0:fx1])
                dst[c] = dst[c].at[fy0:fy1, fx0:fx1].set(
                    t_quant(v * (1.0 - a) + ov[c] * a))
    return np.stack([np.asarray(d) for d in dst])


@pytest.mark.parametrize("mode,places", [
    ("black", [(4, 3, 12, 9, 0.6), (30, 20, 16, 16, 1.0)]),
    ("transparent", [(0, 0, 40, 30, 0.35)]),
    ("checker", [(-5, 25, 20, 12, 0.8), (33, -2, 9, 9, 0.0)]),  # clipped
])
def test_mix_draws_match_tpuvf_apply_folds(mode, places):
    h, w = 30, 40
    rng = np.random.default_rng(len(places) + len(mode))
    pads = [make_draw(rng, h, w, 40, 30, 0, 0, OP_OVER, 0.9),
            make_draw(rng, h, w, 17, 11, 9, 5, OP_ADD, 0.7, f32=True)]
    mixes, draws = [], list(pads)
    for ox, oy, ow, oh, alpha in places:
        image = rng.integers(0, 256, (7, 5, 4), dtype=np.uint8)
        image[..., :3] = (image[..., :3].astype(np.uint16) * image[..., 3:]
                          // 255).astype(np.uint8)  # premultiplied
        rect, planes = overlay_rect(image, w, h, ox, oy, ow, oh)
        x0, x1, y0, y1 = rect
        mixes.append((planes, rect, alpha))
        if x1 > x0 and y1 > y0:
            draws.append(Draw(torch.from_numpy(planes), x0, y0,
                              (x0, y0, x1, y1), OP_OVER,
                              float(np.float32(alpha)), keep_alpha=True))
    bg = Background(background_colors(BG_FLOATS[mode]))
    got = composite_fold_plain(h, w, bg, *pack_draws(h, w, draws),
                               "cpu").numpy()
    before = tpuvf_fold(h, w, mode, True, pads, jit=False)
    want = tpuvf_apply_folds(before, mixes)
    assert np.array_equal(got, want)  # bitwise (module doc)
    assert np.array_equal(got[3], before[3])  # the mix keeps the alpha
    assert not np.array_equal(got[:3], before[:3])


def _png(tmp_path, name, w, h, seed, alpha=None):
    img = np.random.default_rng(seed).integers(0, 256, (h, w, 4),
                                               dtype=np.uint8)
    if alpha is not None:
        img[..., 3] = alpha
    path = str(tmp_path / name)
    tpng.write(path, img)
    return path


PADS = ("appsrc name=s0 format=BGRA width=40 height=24 ! c.sink_0 "
        "appsrc name=s1 format=RGBA width=20 height=12 ! c.sink_1")


def _feeds(seed):
    rng = np.random.default_rng(seed)
    return {"s0": [rng.integers(0, 256, (24, 40, 4), dtype=np.uint8)
                   for _ in range(2)],
            "s1": [rng.integers(0, 256, (12, 20, 4), dtype=np.uint8)
                   for _ in range(2)]}


def _run(parse, desc, feeds, **kw):
    pipe = parse(desc, **kw)
    for name, frames in feeds.items():
        for f in frames:
            pipe[name].push(f)
        pipe[name].end_of_stream()
    pipe.negotiate()
    pipe.build()
    assert pipe.run() == 2
    return pipe


def _tpuvf_folds(pipe):
    return {c: sorted(ov.name for ov in chain)
            for c, chain in pipe._plan_overlay_folds({})[0].items()}


def _port_folds(pipe):
    return {c: sorted(ov.name for ov in chain)
            for c, chain in pipe._plan_overlay_folds().items()}


def _no_k6(*args, **kwargs):
    raise AssertionError("K6 ran for an overlay that should be folded")


COMP = ("vfmetalcompositor name=c background=checker sink_1::xpos=13 "
        "sink_1::ypos=5 sink_1::alpha=0.7 ! video/x-raw,format={fmt} ")
FOLD_CASES = {
    # (pipeline tail after the compositor, folded overlays, K6 stages)
    "direct": ("! vfmetaloverlay name=o1 location={a} x=3 y=2 alpha=0.6 "
               "! appsink", ["o1"], []),
    "through passthroughs, two overlays": (
        "! vfmetalconvertscale ! vfmetaloverlay name=o1 location={a} x=30 "
        "y=15 ! vfmetalvideofilter ! vfmetaloverlay name=o2 location={b} "
        "relative-x=0.5 relative-y=0.25 width=9 height=5 alpha=0.45 "
        "! appsink", ["o1", "o2"], []),
    "an overlay without an image stops the walk": (
        "! vfmetalconvertscale ! vfmetaloverlay name=o0 ! vfmetalvideofilter "
        "! vfmetaloverlay name=o1 location={a} x=3 y=2 ! appsink", [],
        ["o1"]),
}


@pytest.mark.parametrize("case", sorted(FOLD_CASES))
def test_pipeline_plans_the_fold_as_tpuvf(case, tmp_path, monkeypatch):
    monkeypatch.setenv("TPUVF_NO_SPLIT_LINKS", "1")
    tail, folded, k6 = FOLD_CASES[case]
    a = _png(tmp_path, "a.png", 8, 6, seed=1, alpha=150)
    b = _png(tmp_path, "b.png", 5, 4, seed=2)
    desc = COMP.format(fmt="BGRA") + tail.format(a=a, b=b) + " " + PADS
    feeds = _feeds(3)
    if not k6:  # a folded overlay's own stage never runs K6
        monkeypatch.setattr(eov, "overlay_frame", _no_k6)
    port = _run(port_parse, desc, feeds, device="cpu")
    want_folds = {"c": folded} if folded else {}
    assert _port_folds(port) == want_folds
    stages = {st.element.name: st.passthrough for st in port.stages}
    for name in folded:
        assert stages[name]  # its stage is a passthrough
    assert [n for n in k6 if not stages[n]] == k6
    if folded:
        assert sorted(k for k in port.params()["c"]
                      if k.startswith("fold.")) == [
            f"fold.{n}.alpha" for n in folded]
    ref = _run(tpuvf_parse, desc, feeds)
    assert _tpuvf_folds(ref) == want_folds
    with jax.disable_jit():
        eager = _run(tpuvf_parse, desc, feeds)
    for g, w, e in zip(port["appsink0"].frames, ref["appsink0"].frames,
                       eager["appsink0"].frames):
        assert g.shape == w.shape == (24, 40, 4)
        assert np.array_equal(g, e)  # bitwise, op by op (module doc)
        assert np.abs(g.astype(np.int32) - w.astype(np.int32)).max() <= 1


def test_yuv_output_does_not_fold(tmp_path, monkeypatch):
    """For a YUV output the separate overlay mixes after the YUV round trip
    (other values): neither side folds, and the port's overlay runs K6."""
    monkeypatch.setenv("TPUVF_NO_SPLIT_LINKS", "1")
    a = _png(tmp_path, "a.png", 8, 6, seed=4, alpha=200)
    desc = (COMP.format(fmt="NV12") + f"! vfmetaloverlay name=o1 location={a}"
            f" x=4 y=2 alpha=0.8 ! appsink " + PADS)
    feeds = _feeds(5)
    port = _run(port_parse, desc, feeds, device="cpu")
    assert _port_folds(port) == {}
    assert not {st.element.name: st.passthrough for st in port.stages}["o1"]
    ref = _run(tpuvf_parse, desc, feeds)
    assert _tpuvf_folds(ref) == {}
    for g, w in zip(port["appsink0"].frames, ref["appsink0"].frames):
        for k in w:
            d = np.abs(g[k].astype(np.int32) - w[k].astype(np.int32))
            assert d.max() <= 1, k  # compiled tpuvf (module doc)


def test_folded_alpha_is_read_each_run_without_a_rebuild(tmp_path):
    """The overlay's alpha reaches the compositor's params as a host float
    holding its float32 value; writing it rebuilds nothing."""
    a = _png(tmp_path, "a.png", 8, 6, seed=6, alpha=255)
    desc = (COMP.format(fmt="RGBA") + f"! vfmetaloverlay name=o1 location={a}"
            f" x=5 y=4 alpha=0.3 ! appsink " + PADS)
    feeds = _feeds(7)
    pipe = _run(port_parse, desc, feeds, device="cpu")
    assert pipe.params()["c"]["fold.o1.alpha"] == float(np.float32(0.3))
    built = pipe._built_signature
    pipe["o1"].set_property("alpha", 0.9)
    assert pipe.run() == 2
    assert pipe._built_signature == built
    fresh = _run(port_parse, desc.replace("alpha=0.3", "alpha=0.9"), feeds,
                 device="cpu")
    assert np.array_equal(pipe["appsink0"].frames[-1],
                          fresh["appsink0"].frames[-1])
    assert not np.array_equal(pipe["appsink0"].frames[0],
                              pipe["appsink0"].frames[-1])


def _src(dtype, width, offset=0):
    """A (4, 3, width) source whose base sits `offset` elements into its
    allocation."""
    flat = torch.zeros(4 * 3 * width + offset, dtype=dtype)
    return flat[offset:].view(4, 3, width)


@pytest.mark.parametrize("x,width,dtype,offset,vector", [
    (0, 8, torch.uint8, 0, True),
    (128, 256, torch.float32, 0, True),  # config 5's overlay rect
    (1, 8, torch.uint8, 0, False),  # x off the 4-pixel grid
    (6, 8, torch.float32, 0, False),
    (-100, 1280, torch.float32, 0, True),  # negative multiples of 4 align
    (-101, 1280, torch.float32, 0, False),
    (-3, 8, torch.uint8, 0, False),
    (4, 7, torch.uint8, 0, False),  # odd width: rows start off the grid
    (4, 1918, torch.uint8, 0, False),
    (4, 8, torch.uint8, 4, True),  # base on 4 bytes
    (4, 8, torch.uint8, 2, False),
    (4, 8, torch.float32, 4, True),  # base on 16 bytes
    (4, 8, torch.float32, 1, False),
])
def test_draw_vector_path_rule(x, width, dtype, offset, vector):
    src = _src(dtype, width, offset)
    d = Draw(src, x, 0, (max(x, 0), 0, max(x, 0), 0), OP_OVER, 1.0)
    assert draw_vector_path(d) is vector

