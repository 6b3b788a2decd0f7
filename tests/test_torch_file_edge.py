"""The port's file edge against tpuvf on the same inputs: the y4m and raw
sources, the PNG/JPEG/Y4M encoders, filesink and multifilesink, the native
JPEG codec, and vfoverlay with a JPEG image.

Every case is byte for byte (sources, encoders and sinks move bytes; zlib
runs at one level; the JPEG library is compiled from the same sources with
the same flags on this machine), except vfoverlay, which is bitwise against
tpuvf run op by op (``jax.disable_jit``, as in test_torch_overlay).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpuvf.cli.launch import parse_pipeline as tpuvf_parse
from tpuvf.core.formats import VideoFormat as TFormat
from tpuvf.core.frame import host_to_planes as t_host_to_planes
from tpuvf.core.spec import FrameSpec as TSpec
from tpuvf.elements.overlay import Overlay as TOverlay
from tpuvf.io import y4m as t_y4m
from tpuvf.native import jpeg as t_jpeg
from tpuvf_torch.cli.launch import parse_pipeline as port_parse
from tpuvf_torch.core.formats import VideoFormat as PFormat
from tpuvf_torch.core.frame import host_to_planes, to_device, to_host
from tpuvf_torch.core.spec import FrameSpec as PSpec
from tpuvf_torch.elements.overlay import Overlay as POverlay
from tpuvf_torch.io import png, y4m
from tpuvf_torch.native import jpeg

torch.set_num_threads(1)


def _run(parse, desc, **kw):
    pipe = parse(desc, **kw)
    pipe.negotiate()
    pipe.build()
    return pipe, pipe.run()


def _both(tmp_path, template, **files):
    """Run `template` (with {out} and any {name} of `files`) through tpuvf
    and the port; -> (tpuvf pipeline, port pipeline, tpuvf dir, port dir)."""
    out = []
    for side, parse, kw in (("t", tpuvf_parse, {}),
                            ("p", port_parse, {"device": "cpu"})):
        d = tmp_path / side
        d.mkdir()
        pipe, n = _run(parse, template.format(out=d, **files), **kw)
        out.append((pipe, n, d))
    (tp, tn, td), (pp, pn, pd) = out
    assert tn == pn
    return tp, pp, td, pd


def _files(d):
    return {p.name: p.read_bytes() for p in sorted(d.iterdir())}


def test_png_encode_matches_tpuvf(tmp_path):
    from tpuvf.io import png as t_png

    rng = np.random.default_rng(3)
    for shape in ((5, 7, 4), (6, 3, 3), (4, 9)):
        img = rng.integers(0, 256, shape, dtype=np.uint8)
        for interlace in (False, True):
            data = png.encode(img, interlace=interlace)
            assert data == t_png.encode(img, interlace=interlace)
            dec = png.decode(data)
            assert np.array_equal(dec, t_png.decode(data))
    path = tmp_path / "a.png"
    png.write(str(path), img[..., None].repeat(4, -1))
    assert np.array_equal(png.read(str(path)), t_png.read(str(path)))


@pytest.mark.parametrize("fmt", ["BGRA", "NV12", "I420", "UYVY"])
def test_filesink_and_multifilesink_bytes_match_tpuvf(tmp_path, fmt,
                                                      monkeypatch):
    monkeypatch.setenv("TPUVF_NO_SPLIT_LINKS", "1")
    tmpl = (f"videotestsrc num-buffers=3 pattern=ball ! "
            f"video/x-raw,format={fmt},width=48,height=26 ! tee name=t "
            f"t. ! queue ! filesink location={{out}}/all.raw "
            f"t. ! multifilesink location={{out}}/f%03d.raw index=5")
    tp, pp, td, pd = _both(tmp_path, tmpl)
    got = _files(pd)
    assert got == _files(td)
    assert sorted(got) == ["all.raw", "f005.raw", "f006.raw", "f007.raw"]
    assert pp["multifilesink0"].paths[-1].endswith("f007.raw")


def test_pngenc_and_y4menc_bytes_match_tpuvf(tmp_path, monkeypatch):
    monkeypatch.setenv("TPUVF_NO_SPLIT_LINKS", "1")
    tmpl = ("videotestsrc num-buffers=2 pattern=ball ! "
            "video/x-raw,format=I420,width=40,height=30,framerate=25/1,"
            "pixel-aspect-ratio=4/3,interlace-mode=interleaved ! tee name=t "
            "t. ! queue ! y4menc ! filesink location={out}/out.y4m "
            "t. ! queue ! vfmetalconvertscale ! video/x-raw,format=BGRA ! "
            "pngenc compression-level=9 ! multifilesink "
            "location={out}/f%d.png")
    tp, pp, td, pd = _both(tmp_path, tmpl)
    got = _files(pd)
    assert got == _files(td)
    assert got["out.y4m"].startswith(b"YUV4MPEG2 W40 H30 F25:1 It A4:3 ")
    # a renegotiation restarts the stream: the header is written again
    pp.negotiate()
    pp.build()
    pp.run()
    assert (pd / "out.y4m").read_bytes() == got["out.y4m"]


def _y4m_file(path, cs, w, h, n, rng, interlacing="p"):
    hdr = (f"YUV4MPEG2 W{w} H{h} F30000:1001 I{interlacing} A10:11 "
           f"C{cs} XCOLORRANGE=LIMITED\n").encode()
    cw, ch = {"420": (w // 2, h // 2), "420jpeg": (w // 2, h // 2),
              "420mpeg2": (w // 2, h // 2), "420paldv": (w // 2, h // 2),
              "422": (w // 2, h), "mono": (0, 0), "444": (w, h)}[cs]
    body = b""
    for i in range(n):
        body += b"FRAME Ixyz\n" if i == 1 else b"FRAME\n"
        body += rng.integers(0, 256, w * h + 2 * cw * ch,
                             dtype=np.uint8).tobytes()
    path.write_bytes(hdr + body + b"FRAME\n" + b"\0" * 5)  # a truncated tail
    return path


@pytest.mark.parametrize("cs", ["420", "420jpeg", "420mpeg2", "420paldv",
                                "422", "mono"])
def test_y4m_reader_matches_tpuvf(tmp_path, cs):
    path = _y4m_file(tmp_path / "in.y4m", cs, 20, 12, 3,
                     np.random.default_rng(len(cs)))
    r, tr = y4m.Reader(str(path)), t_y4m.Reader(str(path))
    assert r.header == tr.header and r.num_frames() == tr.num_frames() == 3
    for i in range(3):
        got, want = r.read_frame(i), tr.read_frame(i)
        if isinstance(want, dict):
            assert all(np.array_equal(got[k], want[k]) for k in want)
        else:
            assert np.array_equal(got, want) and got.shape == (12, 40)


def test_y4m_refuses_c444_and_bad_headers(tmp_path):
    path = _y4m_file(tmp_path / "in.y4m", "444", 8, 4, 1,
                     np.random.default_rng(0))
    for mod in (y4m, t_y4m):
        with pytest.raises(mod.Y4MError, match="C444"):
            mod.Reader(str(path))
        with pytest.raises(mod.Y4MError, match="not a YUV4MPEG2"):
            mod.parse_header(b"RIFF W8 H4\n")
        with pytest.raises(mod.Y4MError, match="even"):
            mod.stream_header(7, 4)


@pytest.mark.parametrize("cs,interlacing", [("420mpeg2", "t"), ("422", "b"),
                                            ("mono", "p")])
def test_y4msrc_matches_tpuvf(tmp_path, cs, interlacing, monkeypatch):
    monkeypatch.setenv("TPUVF_NO_SPLIT_LINKS", "1")
    path = _y4m_file(tmp_path / "in.y4m", cs, 24, 16, 3,
                     np.random.default_rng(5), interlacing)
    desc = f"y4msrc location={path} num-buffers=2 ! appsink"
    tp, tn = _run(tpuvf_parse, desc)
    pp, pn = _run(port_parse, desc, device="cpu")
    assert tn == pn == 2
    spec = pp._source_spec(pp.sources[0])
    assert (spec.format.value, spec.width, spec.height) == (
        "UYVY" if cs == "422" else "I420", 24, 16)
    assert (spec.fps.num, spec.fps.den, spec.par.num, spec.par.den) == (
        30000, 1001, 10, 11)
    assert spec.interlaced == (interlacing != "p")
    assert spec.tff == (interlacing != "b")
    assert str(spec) == str(tp._outgoing(tp.sources[0])[0].spec)
    for g, w in zip(pp["appsink0"].frames, tp["appsink0"].frames):
        if isinstance(w, dict):
            assert all(np.array_equal(g[k], w[k]) for k in w)
        else:
            assert np.array_equal(g, w)
    bad = f"y4msrc location={path} ! video/x-raw,width=32 ! appsink"
    with pytest.raises(ValueError, match="contradicts the stream header"):
        port_parse(bad, device="cpu").negotiate()


@pytest.mark.parametrize("fmt", ["RGBA", "NV12", "I420", "YUY2"])
def test_rawvideosrc_matches_tpuvf(tmp_path, fmt, monkeypatch):
    monkeypatch.setenv("TPUVF_NO_SPLIT_LINKS", "1")
    raw = tmp_path / "in.raw"
    raw.write_bytes(np.random.default_rng(9).integers(
        0, 256, 4 * 22 * 14 * 3 + 17, dtype=np.uint8).tobytes())
    desc = (f"rawsrc location={raw} format={fmt} width=22 height=14 "
            f"num-buffers=3 ! filesink location={{out}}/out.raw")
    tp, pp, td, pd = _both(tmp_path, desc)
    assert _files(pd) == _files(td)
    assert pp.sources[0].num_frames() == tp.sources[0].num_frames()
    assert port_parse(f"rawvideosrc location={tmp_path}/none width=4 "
                      f"height=4 ! fakesink",
                      device="cpu").sources[0].num_frames() == 0


@pytest.mark.parametrize("quality", [10, 85, 100])
def test_jpeg_codec_matches_tpuvf(quality):
    rng = np.random.default_rng(quality)
    for h, w in ((16, 16), (23, 37)):
        img = rng.integers(0, 256, (h, w, 4), dtype=np.uint8)
        img[: h // 2] //= 8  # a flat part beside the noise
        data = jpeg.encode(img, quality)
        assert data == t_jpeg.encode(img, quality)
        assert data[:2] == b"\xff\xd8"
        assert np.array_equal(jpeg.decode(data), t_jpeg.decode(data))
    with pytest.raises(jpeg.JpegError, match="not a JPEG"):
        jpeg.decode(b"\x89PNG....")
    with pytest.raises(jpeg.JpegError, match="RGBA"):
        jpeg.encode(img[..., :3])


def test_jpegenc_bytes_match_tpuvf(tmp_path, monkeypatch):
    monkeypatch.setenv("TPUVF_NO_SPLIT_LINKS", "1")
    tmpl = ("videotestsrc num-buffers=2 pattern=ball ! "
            "video/x-raw,format=BGRA,width=40,height=24 ! jpegenc quality=70 "
            "! queue ! multifilesink location={out}/f%05d.jpg")
    tp, pp, td, pd = _both(tmp_path, tmpl)
    assert _files(pd) == _files(td)
    assert sorted(_files(pd)) == ["f00000.jpg", "f00001.jpg"]


def test_jpegenc_refusal_keeps_the_build_error(monkeypatch):
    """Without the library jpegenc refuses to negotiate, and the compiler's
    error survives as the cause."""
    from tpuvf_torch import native

    def failed_build():
        raise RuntimeError("g++ failed (1) building libtpuvf_jpeg.so:\nboom")

    monkeypatch.setattr(native, "load", failed_build)
    pipe = port_parse("videotestsrc ! video/x-raw,format=BGRA,width=40,"
                      "height=24 ! jpegenc ! fakesink", device="cpu")
    with pytest.raises(ValueError, match="boom") as err:
        pipe.negotiate()
    assert isinstance(err.value.__cause__, RuntimeError)


def test_jpeg_overlay_matches_tpuvf(tmp_path):
    rng = np.random.default_rng(11)
    img = rng.integers(0, 256, (12, 20, 4), dtype=np.uint8)
    path = tmp_path / "logo.jpg"
    path.write_bytes(t_jpeg.encode(img, 90))
    props = dict(location=str(path), x=5, y=3, width=16, height=9, alpha=0.6)
    for fmt in ("NV12", "BGRA"):
        tspec, pspec = TSpec(TFormat(fmt), 40, 24), PSpec(PFormat(fmt), 40, 24)
        from tests.util import random_host_frame

        host = random_host_frame(rng, tspec)
        tel, pel = TOverlay(**props), POverlay(**props)
        assert not pel.is_passthrough(pspec, pspec)
        tproc = tel.make_process(tspec, tspec, tel.static_config(tspec, tspec))
        with jax.disable_jit():
            tout, _ = tproc({k: jnp.asarray(v) for k, v in
                             t_host_to_planes(host, tspec).items()},
                            (), tel.traced_params())
        pproc = pel.make_process(pspec, pspec, pel.static_config(pspec, pspec),
                                 "cpu")
        pout, _ = pproc(to_device(host_to_planes(host, pspec), "cpu"), (),
                        pel.traced_params("cpu"))
        got = to_host(pout)
        for k, v in tout.items():
            assert np.array_equal(got[k], np.asarray(v)), (fmt, k)
