"""The fused routes of K6 (vfoverlay) and K5 (vfdeinterlace): their plain
composites (``overlay.overlay_frame_plain`` and
``deinterlace.deinterlace_frame_plain``, which the wrappers take on the CPU
and which the kernels are held to on the card) against tpuvf's elements
on the same numpy frames, and the sources and build rules the kernels rest
on.

Tolerances, per case: bitwise against tpuvf run op by op
(``jax.disable_jit``), where every float32 op rounds once as in the port
(the overlay blend is an FMA site, and greedy-H's ``motion < threshold`` a
knife edge, that XLA's compiled CPU code may move).
"""

import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.util import random_host_frame
from tpuvf.core.formats import VideoFormat as TFormat
from tpuvf.core.frame import host_to_planes as t_host_to_planes
from tpuvf.core.spec import FrameSpec as TSpec
from tpuvf.elements.deinterlace import Deinterlace as TDeinterlace
from tpuvf.elements.overlay import Overlay as TOverlay
from tpuvf.io import png as tpng
from tpuvf_torch.core.formats import VideoFormat as PFormat
from tpuvf_torch.core.frame import host_to_planes, to_device
from tpuvf_torch.core.spec import FrameSpec as PSpec
from tpuvf_torch.elements.overlay import Overlay as POverlay
from tpuvf_torch.kernels import _build, color, convert
from tpuvf_torch.kernels import deinterlace as kd
from tpuvf_torch.kernels import overlay as ko
from tpuvf_torch.kernels.sample import NEAREST

torch.set_num_threads(1)

MATRICES = {0: "bt601", 1: "bt709"}


def specs(fmt_in, fmt_out, w, h, mi, mo, **kw):
    """(tpuvf in, tpuvf out, port in, port out) specs."""
    t_in = TSpec(TFormat(fmt_in), w, h, matrix=MATRICES[mi], **kw)
    p_in = PSpec(PFormat(fmt_in), w, h, matrix=MATRICES[mi], **kw)
    t_out = TSpec(TFormat(fmt_out), w, h, matrix=MATRICES[mo])
    p_out = PSpec(PFormat(fmt_out), w, h, matrix=MATRICES[mo])
    return t_in, t_out, p_in, p_out


def jnp_planes(host, spec):
    return {k: jnp.asarray(v) for k, v in t_host_to_planes(host, spec).items()}


def np_planes(planes):
    return {k: np.asarray(v) for k, v in planes.items()}


def assert_bitwise(want, got, context=""):
    assert set(want) == set(got), context
    for k in want:
        w, g = np.asarray(want[k]), np.asarray(got[k])
        assert w.shape == g.shape and g.dtype == np.uint8, (context, k)
        d = np.abs(w.astype(np.int32) - g.astype(np.int32))
        assert d.max() == 0, f"{context} {k}: {int(d.max())} LSB"


# -- K6: vfoverlay -------------------------------------------------------------

OVERLAYS = {
    "partly off-frame": {"relative-x": 0.8, "y": 9, "width": 14,
                         "height": 11, "alpha": 0.6},
    "inside, stretched": {"x": 2, "y": 3, "width": 21, "height": 9,
                          "alpha": 0.85},
    "empty rect": {"x": 500, "y": 3, "alpha": 1.0},
    "alpha 0": {"x": 4, "y": 2, "alpha": 0.0},
}
OVERLAY_CASES = [
    (fmt, size, place, mats)
    for fmt in ("NV12", "I420")
    for size in ((32, 18), (63, 37))
    for place in OVERLAYS
    for mats in ((1, 1), (0, 1))
]


@pytest.mark.parametrize(
    "fmt,size,place,mats", OVERLAY_CASES,
    ids=[f"{f}-{w}x{h}-{p.replace(' ', '_')}-m{a}{b}"
         for f, (w, h), p, (a, b) in OVERLAY_CASES])
def test_overlay_frame_plain_matches_tpuvf_op_by_op(fmt, size, place, mats,
                                                     tmp_path):
    w, h = size
    mi, mo = mats
    path = str(tmp_path / "ov.png")
    tpng.write(path, np.random.default_rng(1).integers(0, 256, (8, 12, 4),
                                                       dtype=np.uint8))
    props = dict(OVERLAYS[place], location=path)
    t_in, t_out, p_in, p_out = specs(fmt, fmt, w, h, mi, mo)
    host = random_host_frame(np.random.default_rng(w + mi), t_in)

    tel = TOverlay(**props)
    tproc = tel.make_process(t_in, t_out, tel.static_config(t_in, t_out))
    with jax.disable_jit():
        want, _ = tproc(jnp_planes(host, t_in), (), tel.traced_params())

    pel = POverlay(**props)
    rect, ov = pel.fold_rect(p_in)
    taps = convert.plan_chroma_taps(p_in, "cpu")
    alpha = torch.tensor(np.float32(props["alpha"]))
    args = (to_device(host_to_planes(host, p_in), "cpu"), taps, rect,
            torch.from_numpy(ov), alpha, mi, mo)
    got = ko.overlay_frame_plain(*args)
    assert_bitwise(np_planes(want), {k: v.numpy() for k, v in got.items()},
                   f"{fmt} {place}")
    # the wrapper takes the plain composite for CPU planes
    wrapped = ko.overlay_frame(*args)
    assert all(torch.equal(wrapped[k], got[k]) for k in got)


def test_overlay_round_trip_changes_pixels_outside_the_rect():
    """YUV -> RGBA8 -> YUV is not the identity: every quad is converted,
    so the 4:2:0 route cannot copy the planes outside the rect."""
    spec = PSpec(PFormat.I420, 16, 8)
    host = random_host_frame(np.random.default_rng(3),
                             TSpec(TFormat.I420, 16, 8))
    planes = to_device(host_to_planes(host, spec), "cpu")
    out = ko.overlay_frame(planes, convert.plan_chroma_taps(spec, "cpu"),
                           (0, 0, 0, 0), torch.zeros((4, 0, 0)),
                           torch.tensor(1.0), 0, 0)
    assert any(not torch.equal(out[k], planes[k]) for k in planes)


def test_overlay_frame_rejects_what_the_kernels_do_not_take():
    spec = PSpec(PFormat.NV12, 16, 8)
    planes = {"y": torch.zeros((8, 16), dtype=torch.uint8),
              "u": torch.zeros((4, 8), dtype=torch.uint8),
              "v": torch.zeros((4, 8), dtype=torch.uint8)}
    taps = convert.plan_chroma_taps(spec, "cpu")
    alpha, empty = torch.tensor(1.0), torch.zeros((4, 0, 0))
    with pytest.raises(ValueError, match="taps"):  # the columns' for rows
        ko.overlay_frame(planes, (taps[1], taps[1]), (0, 0, 0, 0), empty,
                         alpha, 0, 0)
    with pytest.raises(ValueError, match="4:2:0"):
        ko.overlay_frame(dict(planes, u=planes["u"][:3]), taps, (0, 0, 0, 0),
                         empty, alpha, 0, 0)
    with pytest.raises(ValueError, match="uint8"):
        ko.overlay_frame({"rgba": torch.zeros((4, 8, 16))}, None,
                         (0, 0, 0, 0), empty, alpha, 0, 0)
    with pytest.raises(ValueError, match="matrices"):
        ko.overlay_frame(planes, taps, (0, 0, 0, 0), empty, alpha, 0, 2)
    with pytest.raises(ValueError, match="ov must be"):
        ko.overlay_frame(planes, taps, (0, 4, 0, 2), torch.zeros((4, 3, 4)),
                         alpha, 0, 0)


# -- K5: vfdeinterlace ---------------------------------------------------------

METHODS = {"bob": 0, "weave": 1, "linear": 2, "greedyh": 3}
DEINTERLACE_CASES = [
    (method, fmts, tff)
    for method in ("bob", "weave", "greedyh")
    for fmts in (("I420", "I420"), ("NV12", "NV12"), ("I420", "RGBA"),
                 ("RGBA", "I420"))
    for tff in (True, False)
]


def run_deinterlace_both(props, fmt_in, fmt_out, w, h, tff, hosts, mi=0,
                         mo=0):
    """-> [(tpuvf planes op by op, tpuvf texture state, port planes, port
    texture)] frame by frame; frame 0 has no previous frame."""
    t_in, t_out, p_in, _ = specs(fmt_in, fmt_out, w, h, mi, mo,
                                 interlaced=True, tff=tff)
    tel = TDeinterlace(**props)
    tproc = tel.make_process(t_in, t_out, tel.static_config(t_in, t_out))
    state, params = tel.init_state(t_in, t_out), tel.traced_params()
    method = props["method"]
    taps = (None if fmt_in in ("RGBA", "BGRA")
            else convert.plan_chroma_taps(p_in, "cpu", NEAREST))
    thr = torch.tensor(np.float32(props["motion-threshold"]))
    prev, has_prev = torch.zeros((4, h, w), dtype=torch.uint8), False
    frames = []
    for host in hosts:
        with jax.disable_jit():
            want, state = tproc(jnp_planes(host, t_in), state, params)
        got, tex = kd.deinterlace_frame_plain(
            to_device(host_to_planes(host, p_in), "cpu"), prev, method, tff,
            has_prev, thr, taps, mi, PFormat(fmt_out), mo)
        t_tex = (np.stack([np.asarray(p) for p in state["prev"]])
                 if state else None)
        frames.append((np_planes(want), t_tex,
                       {k: v.numpy() for k, v in got.items()}, tex))
        if tex is not None:
            prev, has_prev = tex, True
    return frames


@pytest.mark.parametrize(
    "method,fmts,tff", DEINTERLACE_CASES,
    ids=[f"{m}-{a}-{b}-{'tff' if t else 'bff'}"
         for m, (a, b), t in DEINTERLACE_CASES])
@pytest.mark.parametrize("size", [(16, 12), (63, 37)],
                         ids=["16x12", "63x37"])
def test_deinterlace_frame_plain_matches_tpuvf_op_by_op(method, fmts, tff,
                                                        size):
    """Three frames: frame 0 without a previous frame (weave and greedy-H
    fall back to bob), then with the carried texture."""
    w, h = size
    fmt_in, fmt_out = fmts
    props = {"method": METHODS[method], "motion-threshold": 0.3}
    rng = np.random.default_rng(w + len(method))
    spec = TSpec(TFormat(fmt_in), w, h)
    hosts = [random_host_frame(rng, spec) for _ in range(3)]
    for i, (want, t_tex, got, tex) in enumerate(run_deinterlace_both(
            props, fmt_in, fmt_out, w, h, tff, hosts)):
        assert_bitwise(want, got, f"frame {i}")
        assert (t_tex is None) == (tex is None)
        if tex is not None:  # the texture carried to the next frame
            assert np.array_equal(t_tex, tex.numpy()), f"frame {i}"


def test_deinterlace_frame_plain_matrices_differ():
    w, h = 20, 10
    props = {"method": 3, "motion-threshold": 0.25}
    rng = np.random.default_rng(11)
    hosts = [random_host_frame(rng, TSpec(TFormat.I420, w, h))
             for _ in range(2)]
    frames = run_deinterlace_both(props, "I420", "I420", w, h, True, hosts,
                                  mi=0, mo=1)
    for want, _, got, _ in frames:
        assert_bitwise(want, got)


def test_deinterlace_threshold_tie_through_the_4_2_0_pack():
    """Motion equal to the threshold takes bob, one step less takes prev
    (RGB in, 4:2:0 out: the RGB route's pack)."""
    w, h = 8, 6
    prev = np.full((h, w, 4), 100, np.uint8)
    cur = prev.copy()
    cur[..., 0] = 200
    cur[1::2, : w // 2, 0] = 199
    cur[0, :, :3] = 30
    thr = float(np.float32(np.float32(200) * np.float32(1 / 255))
                - np.float32(np.float32(100) * np.float32(1 / 255)))
    props = {"method": 3, "motion-threshold": thr}
    frames = run_deinterlace_both(props, "RGBA", "I420", w, h, True,
                                  [prev, cur])
    want, _, got, _ = frames[1]
    assert_bitwise(want, got)
    rgb = kd.deinterlace_frame_plain(
        {"rgba": torch.from_numpy(np.moveaxis(cur, -1, 0).copy())},
        torch.from_numpy(np.moveaxis(prev, -1, 0).copy()), 3, True, True,
        torch.tensor(np.float32(thr)), None, 0, PFormat.RGBA, 0)[0]["rgba"]
    assert (rgb[:, 1::2, : w // 2] == 100).all()  # below the threshold
    assert (rgb[0, 1::2, w // 2:] != 100).all()  # the tie: bob


def test_deinterlace_frame_returns_the_texture_only_for_stateful_methods():
    spec = PSpec(PFormat.I420, 16, 12)
    host = random_host_frame(np.random.default_rng(2),
                             TSpec(TFormat.I420, 16, 12))
    planes = to_device(host_to_planes(host, spec), "cpu")
    taps = convert.plan_chroma_taps(spec, "cpu", NEAREST)
    thr = torch.tensor(0.1)
    for method, stateful in ((0, False), (2, False), (1, True), (3, True)):
        _, tex = kd.deinterlace_frame(planes, None, method, True, False, thr,
                                      taps, 0, PFormat.NV12, 0)
        assert (tex is not None) == stateful
        if stateful:
            assert tex.shape == (4, 12, 16) and tex.dtype == torch.uint8
    rgba = {"rgba": torch.zeros((4, 12, 16), dtype=torch.uint8)}
    _, tex = kd.deinterlace_frame(rgba, None, 1, True, False, thr, None, 0,
                                  PFormat.RGBA, 0)
    assert tex is rgba["rgba"]  # an RGB input is its own texture


def test_deinterlace_frame_rejects_what_the_kernels_do_not_take():
    spec = PSpec(PFormat.I420, 16, 12)
    planes = {"y": torch.zeros((12, 16), dtype=torch.uint8),
              "u": torch.zeros((6, 8), dtype=torch.uint8),
              "v": torch.zeros((6, 8), dtype=torch.uint8)}
    taps = convert.plan_chroma_taps(spec, "cpu", NEAREST)
    thr = torch.tensor(0.1)
    with pytest.raises(ValueError, match="unsupported output"):
        kd.deinterlace_frame(planes, None, 0, True, False, thr, taps, 0,
                             PFormat.UYVY, 0)
    with pytest.raises(ValueError, match="prev"):
        kd.deinterlace_frame(planes, torch.zeros((4, 12, 15),
                                                 dtype=torch.uint8),
                             1, True, True, thr, taps, 0, PFormat.I420, 0)
    with pytest.raises(ValueError, match="prev is needed"):
        kd.deinterlace_frame(planes, None, 3, True, True, thr, taps, 0,
                             PFormat.I420, 0)
    with pytest.raises(ValueError, match="taps"):
        kd.deinterlace_frame(planes, None, 0, True, False, thr,
                             (taps[1], taps[0]), 0, PFormat.I420, 0)


# -- the launchers' path rules (mirrors) ---------------------------------------


@pytest.mark.parametrize("w,yuv_vec,rgb_vec", [(1920, True, True),
                                                (1919, False, False),
                                                (36, True, False)])
def test_route_mirrors_the_launchers(w, yuv_vec, rgb_vec):
    planes = {"y": torch.zeros((4, w), dtype=torch.uint8),
              "u": torch.zeros((2, (w + 1) // 2), dtype=torch.uint8),
              "v": torch.zeros((2, (w + 1) // 2), dtype=torch.uint8)}
    assert kd.route(planes, None) == (4, yuv_vec)
    assert ko.route(planes) == (4, yuv_vec)
    rgba = {"rgba": torch.zeros((4, 2, w), dtype=torch.uint8)}
    assert kd.route(rgba, None) == ((16, True) if rgb_vec else (4, False))
    assert ko.route(rgba) == ((16, True) if rgb_vec else (1, False))
    # a plane off its access's boundary takes the scalar path
    y = torch.zeros(4 * w + 1, dtype=torch.uint8)[1:].view(4, w)
    assert kd.route(dict(planes, y=y), None) == (4, False)


# -- the CUDA sources --------------------------------------------------------

HEADER = (_build.SOURCE_DIR / "yuv420.cuh").read_text()


def _constant(name):
    """The double literals of `__constant__ float name[...] = {...};`."""
    m = re.search(r"__constant__ float " + name + r"(?:\[\d+\])+ = (\{.*?\});",
                  HEADER, re.S)
    nums = re.findall(r"-?\d+\.\d*(?:e-?\d+)?(?: / \d+\.\d*)?", m.group(1))
    return np.array([eval(n) for n in nums], np.float64).astype(np.float32)


@pytest.mark.parametrize("name,table", [
    ("kRgbToYuv", color.RGB_TO_YUV), ("kYuvOffset", color.YUV_OFFSET),
    ("kYuvToRgb", color.YUV_TO_RGB)])
def test_header_coefficients_are_the_ports_float32_tables(name, table):
    """rgb_to_yuv's and yuv_to_rgb's coefficients and offsets, narrowed to
    float32 from the header's double literals, equal the plain version's
    float32 tables."""
    assert np.array_equal(_constant(name), table.reshape(-1))


def test_every_fused_source_includes_the_header():
    for name in ("emit.cu", "overlay.cu", "deinterlace.cu", "resample.cu",
                 "composite.cu"):
        text = (_build.SOURCE_DIR / name).read_text()
        assert '#include "yuv420.cuh"' in text, name
        # the shared helpers live in the header only
        assert not re.search(r"float mul\(float a, float b\)", text), name


def test_build_is_stale_when_a_header_is_newer(tmp_path, monkeypatch):
    src_dir = tmp_path / "csrc"
    src_dir.mkdir()
    (src_dir / "a.cu").write_text('#include "h.cuh"\n')
    (src_dir / "h.cuh").write_text("// header\n")
    lib = tmp_path / "lib.so"
    lib.write_bytes(b"")
    monkeypatch.setattr(_build, "SOURCE_DIR", src_dir)
    monkeypatch.setattr(_build, "LIBRARY", lib)
    os.utime(src_dir / "a.cu", (1000, 1000))
    os.utime(src_dir / "h.cuh", (1000, 1000))
    os.utime(lib, (2000, 2000))
    assert not _build._stale()
    os.utime(src_dir / "h.cuh", (3000, 3000))
    assert _build._stale()
    assert [p.name for p in _build.headers()] == ["h.cuh"]
