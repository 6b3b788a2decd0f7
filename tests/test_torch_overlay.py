"""vfoverlay: the port's `make_process` on the CPU (K6 and the sampler and
emit kernels take their plain versions) against tpuvf's on the same numpy
frames and PNG files (written with ``tpuvf.io.png.write``), and BASELINE
config 5 at a small size: the port's ``vfcompositor ! vfoverlay`` against
tpuvf's aggregate with the overlay folded into its render pass.

Tolerances, per case:
- bitwise against tpuvf run op by op (``jax.disable_jit``): the blend
  ``v * (1 - a) + o * a`` is an FMA site that XLA's CPU backend may contract
  in compiled code, and the port rounds every op once;
- <= 2 LSB against the numpy oracle of the Metal shaders (tests/oracle).
"""

import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.oracle import element_ref, metal_ref
from tests.util import random_host_frame
from tpuvf.core.formats import VideoFormat as TFormat
from tpuvf.core.frame import host_to_planes as t_host_to_planes
from tpuvf.core.registry import make as t_make
from tpuvf.core.spec import CapsFilter as TCaps, FrameSpec as TSpec
from tpuvf.elements.overlay import Overlay as TOverlay
from tpuvf.io import png as tpng
from tpuvf_torch.cli.launch import parse_pipeline
from tpuvf_torch.core.formats import VideoFormat as PFormat
from tpuvf_torch.core.frame import host_to_planes, to_device, to_host
from tpuvf_torch.core.spec import FrameSpec as PSpec
from tpuvf_torch.elements.overlay import Overlay as POverlay
from tpuvf_torch.kernels import overlay as kov

torch.set_num_threads(1)


def write_png(path, w, h, alpha=200, seed=0):
    rng = np.random.default_rng(seed)
    img = rng.integers(0, 256, (h, w, 4), dtype=np.uint8)
    img[..., 3] = alpha if alpha is not None else img[..., 3]
    tpng.write(str(path), img)
    return str(path)


def run_both(props, fmt, w, h, seed=0):
    """-> (tpuvf planes op by op, port planes, the input's planes)."""
    rng = np.random.default_rng(seed)
    tspec, pspec = TSpec(TFormat(fmt), w, h), PSpec(PFormat(fmt), w, h)
    host = random_host_frame(rng, tspec)
    tel, pel = TOverlay(**props), POverlay(**props)
    assert not pel.is_passthrough(pspec, pspec)
    tproc = tel.make_process(tspec, tspec, tel.static_config(tspec, tspec))
    with jax.disable_jit():
        tout, _ = tproc({k: jnp.asarray(v) for k, v in
                         t_host_to_planes(host, tspec).items()},
                        (), tel.traced_params())
    pout = run_port(pel, pspec, host)
    return ({k: np.asarray(v) for k, v in tout.items()}, pout,
            host_to_planes(host, pspec))


def run_port(pel, spec, host):
    proc = pel.make_process(spec, spec, pel.static_config(spec, spec), "cpu")
    out, _ = proc(to_device(host_to_planes(host, spec), "cpu"), (),
                  pel.traced_params("cpu"))
    return to_host(out)


def max_lsb(want, got):
    assert set(want) == set(got)
    worst = 0
    for k in want:
        assert want[k].shape == got[k].shape and got[k].dtype == np.uint8, k
        worst = max(worst, int(np.abs(want[k].astype(np.int32)
                                      - got[k].astype(np.int32)).max()))
    return worst


PLACEMENTS = {
    "native": {"x": 5, "y": 3, "alpha": 0.7},
    "stretched": {"x": 2, "y": 4, "width": 21, "height": 9, "alpha": 0.85},
    "relative": {"relative-x": 0.5, "relative-y": 0.25, "width": 10,
                 "height": 6},
    "off-frame": {"relative-x": 0.8, "y": 9, "width": 14, "height": 11,
                  "alpha": 0.6},
}
CASES = [(fmt, p) for fmt in ("RGBA", "NV12", "I420") for p in PLACEMENTS]


@pytest.mark.parametrize("fmt,placement", CASES,
                         ids=[f"{f}-{p}" for f, p in CASES])
def test_matches_tpuvf_op_by_op_bitwise(fmt, placement, tmp_path):
    path = write_png(tmp_path / "ov.png", 12, 8, alpha=None, seed=1)
    props = dict(PLACEMENTS[placement], location=path)
    want, got, _ = run_both(props, fmt, 32, 18, seed=2)
    assert max_lsb(want, got) == 0  # bitwise, op by op (module doc)


@pytest.mark.parametrize("fmt", ["RGBA", "NV12"])
def test_matches_oracle(fmt, tmp_path):
    """tests/test_transform_overlay.py's golden case."""
    w, h = 48, 32
    path = write_png(tmp_path / "ov.png", 16, 12, alpha=200, seed=3)
    _, got, planes = run_both({"location": path, "x": 8, "y": 4,
                               "alpha": 0.7}, fmt, w, h, seed=4)
    spec = PSpec(PFormat(fmt), w, h)
    video = metal_ref.sample_rgba(planes, fmt, spec.matrix_index, w, h)
    premult = tpng.decode_premultiplied(open(path, "rb").read())
    out = element_ref.overlay(video, premult, 8, 4, 16, 12, 0.7)
    want = metal_ref.pack_rgba(metal_ref.quant(out).transpose(2, 0, 1), fmt,
                               spec.matrix_index)
    assert max_lsb(want, got) <= 2  # oracle tolerance


def test_alpha_zero_is_identity(tmp_path):
    path = write_png(tmp_path / "ov.png", 12, 8)
    spec = PSpec(PFormat.RGBA, 24, 16)
    host = np.random.default_rng(5).integers(0, 256, (16, 24, 4), np.uint8)
    got = run_port(POverlay(location=path, alpha=0.0), spec, host)
    assert np.array_equal(got["rgba"], host_to_planes(host, spec)["rgba"])


def test_missing_file_stays_passthrough_with_a_warning(caplog):
    el = POverlay()
    with caplog.at_level(logging.WARNING, logger="tpuvf_torch.overlay"):
        el.set_property("location", "/nonexistent/overlay.png")
    assert "failed to load overlay image" in caplog.text
    spec = PSpec(PFormat.BGRA, 32, 24)
    assert el.is_passthrough(spec, spec)
    pipe = parse_pipeline(
        "videotestsrc num-buffers=2 ! video/x-raw,format=BGRA,width=32,"
        "height=24 ! vfmetaloverlay location=/nonexistent/file.png ! appsink",
        device="cpu")
    pipe.build()
    assert [st.passthrough for st in pipe.stages] == [True]
    assert pipe.run() == 2


def test_jpeg_soft_fails_naming_the_decoder(tmp_path, caplog):
    """A JPEG goes through the port's native decoder now; one it refuses
    warns with the decoder's error and leaves the overlay passthrough."""
    path = tmp_path / "ov.jpg"
    path.write_bytes(b"\xff\xd8\xff\xe0" + bytes(64))
    el = POverlay()
    with caplog.at_level(logging.WARNING, logger="tpuvf_torch.overlay"):
        el.set_property("location", str(path))
    assert str(path) in caplog.text
    assert "truncated/invalid segment" in caplog.text  # the decoder's error
    spec = PSpec(PFormat.NV12, 32, 24)
    assert el.is_passthrough(spec, spec)


def test_changing_location_reloads(tmp_path):
    a = write_png(tmp_path / "a.png", 12, 8, seed=6)
    b = write_png(tmp_path / "b.png", 10, 10, seed=7)
    spec = PSpec(PFormat.RGBA, 24, 16)
    host = np.random.default_rng(8).integers(0, 256, (16, 24, 4), np.uint8)
    el = POverlay(location=a, x=3, y=2)
    before = el.static_config(spec, spec)
    got_a = run_port(el, spec, host)
    el.set_property("location", b)
    assert el.static_config(spec, spec) != before
    got_b = run_port(el, spec, host)
    assert not np.array_equal(got_a["rgba"], got_b["rgba"])
    assert np.array_equal(got_b["rgba"],
                          run_port(POverlay(location=b, x=3, y=2), spec,
                                   host)["rgba"])


def test_empty_rect_only_quantizes():
    src = torch.rand((4, 6, 8), generator=torch.Generator().manual_seed(0))
    alpha = torch.tensor(1.0)
    rect, planes = kov.overlay_rect(np.full((4, 4, 4), 255, np.uint8), 8, 6,
                                    20.0, 1.0, 4.0, 4.0)
    assert rect[0] == rect[1] and planes.shape[2] == 0
    ov = torch.from_numpy(planes)
    out = kov.overlay_blend_plain(src, rect, ov, alpha)
    assert torch.equal(out, torch.round(src * 255.0).to(torch.uint8))
    # the RGB route of the wrapper: an empty rect returns the planes as
    # they are (quant(dequant(v)) == v)
    rgba = out.clone()
    got = kov.overlay_frame({"rgba": rgba}, None, rect, ov, alpha, 0, 0)
    assert torch.equal(got["rgba"], rgba)
    with pytest.raises(ValueError, match="rect"):
        kov.overlay_frame({"rgba": rgba}, None, (0, 9, 0, 2),
                          torch.zeros((4, 2, 9)), alpha, 0, 0)


# -- BASELINE config 5 at a small size --------------------------------------

PADS = [  # (format, w, h, pad props): config 5's 2x2 multiview, cut to 64x36
    ("BGRA", 64, 36, {}),
    ("NV12", 32, 18, {"xpos": 32}),
    ("BGRA", 20, 12, {"ypos": 18, "alpha": 0.7}),
    ("NV12", 20, 12, {"xpos": 32, "ypos": 18, "operator": 2}),
]


@pytest.mark.parametrize("ov_props", [
    {"x": 4, "y": 4},  # config 5's overlay: native size, red, alpha 128
    {"x": 50, "y": 30, "width": 20, "height": 9, "alpha": 0.6},  # off-frame
])
def test_config5_compositor_then_overlay_matches_tpuvf_fold(ov_props,
                                                           tmp_path):
    img = np.zeros((8, 8, 4), np.uint8)
    img[..., 0], img[..., 3] = 255, 128
    path = str(tmp_path / "red.png")
    tpng.write(path, img)
    rng = np.random.default_rng(50)
    hosts = [random_host_frame(rng, TSpec(TFormat(f), w, h))
             for f, w, h, _ in PADS]

    tcomp = t_make("vfcompositor")
    tcomp.set_property("background", 1)
    tspecs, tin = {}, {}
    for i, ((fmt, w, h, props), host) in enumerate(zip(PADS, hosts)):
        for k, v in props.items():
            tcomp.get_pad(f"sink_{i}").set(k, v)
        tspecs[f"sink_{i}"] = TSpec(TFormat(fmt), w, h)
        tin[f"sink_{i}"] = {k: jnp.asarray(v) for k, v in t_host_to_planes(
            host, tspecs[f"sink_{i}"]).items()}
    tov = TOverlay(**ov_props)
    tov.set_property("location", path)
    out_spec = tcomp.aggregate_spec(tspecs, TCaps.parse(
        "video/x-raw,format=BGRA"))
    tproc = tcomp.make_aggregate(tspecs, out_spec, fold_overlays=(tov,))
    with jax.disable_jit():
        want, _ = tproc(tin, (), tcomp.traced_params())

    pads = " ".join(f"sink_{i}::{k}={v}" for i, (_, _, _, props)
                    in enumerate(PADS) for k, v in props.items())
    ov = " ".join(f"{k}={v}" for k, v in ov_props.items())
    srcs = " ".join(f"appsrc name=s{i} format={f} width={w} height={h} "
                    f"! c.sink_{i}" for i, (f, w, h, _) in enumerate(PADS))
    pipe = parse_pipeline(
        f"vfmetalcompositor name=c background=black {pads} "
        f"! video/x-raw,format=BGRA ! vfmetaloverlay location={path} {ov} "
        f"! appsink {srcs}", device="cpu")
    for i, host in enumerate(hosts):
        pipe[f"s{i}"].push(host)
        pipe[f"s{i}"].end_of_stream()
    assert pipe.run() == 1
    got = host_to_planes(pipe["appsink0"].frames[0],
                         PSpec(PFormat.BGRA, out_spec.width, out_spec.height))
    assert max_lsb({"rgba": np.asarray(want["rgba"])}, got) == 0  # bitwise
