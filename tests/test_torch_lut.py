"""vfvideofilter's LUT and sharpness stages in the PyTorch port against tpuvf
on the same numpy inputs (port on the CPU, where the emit (K2) and LUT (K3)
wrappers run their plain versions).

Tolerances, per case:
- `load_cube`, `load_png_lut`, `pack_lut_corners`: equal arrays (the same
  parser; the same float32 arithmetic).
- `apply_lut_t_plain` against tpuvf's `apply_lut_t` on a float32 table: max
  abs 0 (the same trilinear arithmetic in the same order).
- vfvideofilter with a LUT and/or sharpness against tpuvf's `make_process`:
  <= 1 LSB when tpuvf keeps the table in float32 (TPUVF_LUT_F32=1), as
  the port always does (the b/c/s fold and blur sums meet knife edges);
  <= 2 LSB against tpuvf's default uint8 table (its corners carry up to
  0.5/255 of rounding) and against the numpy oracle of the Metal semantics.
- the whole chain through `parse_pipeline` against tpuvf under
  TPUVF_NO_SPLIT_LINKS=1 and TPUVF_LUT_F32=1: <= 1 LSB.
"""

import logging
import struct
import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.oracle import filter_ref, metal_ref
from tests.test_torch_elements import diff_stats, random_host, run_both
from tpuvf.cli.launch import parse_pipeline as tpuvf_parse
from tpuvf.core import frame as tframe, spec as tspec
from tpuvf.core.formats import VideoFormat as TFormat
from tpuvf.elements.videofilter import VideoFilter as TVideoFilter
from tpuvf.io import lut as tlut, png as tpng
from tpuvf.kernels import filter as tfilter
from tpuvf_torch.cli.launch import parse_pipeline as port_parse
from tpuvf_torch.core.formats import VideoFormat as PFormat
from tpuvf_torch.core.spec import FrameSpec as PSpec
from tpuvf_torch.elements.videofilter import VideoFilter as PVideoFilter
from tpuvf_torch.io import lut as plut
from tpuvf_torch.kernels import filter as pfilter, lut as plutk

torch.set_num_threads(1)


def grade(size: int, seed: int) -> np.ndarray:
    """A seeded non-identity (S, S, S, 3) [b][g][r] grade: a channel mix
    plus noise, so swapped axes or corners show."""
    rng = np.random.default_rng(seed)
    t = np.linspace(0.0, 1.0, size)
    b, g, r = np.meshgrid(t, t, t, indexing="ij")
    mix = np.stack([0.7 * r + 0.2 * g + 0.1 * b, 0.1 * r + 0.6 * g + 0.3 * b,
                    0.3 * r * g + 0.7 * b], -1)
    return np.clip(mix + rng.normal(0, 0.05, mix.shape), 0, 1).astype(np.float32)


def write_cube(path, table: np.ndarray, header: str = "") -> str:
    size = table.shape[0]
    with open(path, "w") as fh:
        fh.write(header + f"LUT_3D_SIZE {size}\n")
        for rgb in table.reshape(-1, 3):
            fh.write(" ".join(f"{c:.6f}" for c in rgb) + "\n")
    return str(path)


# -- loaders ------------------------------------------------------------------

CUBE_TEXTS = {
    # comments, TITLE/DOMAIN lines, a short line and a bad float (skipped)
    "quirks": ("# a comment\nTITLE \"grade\"\nDOMAIN_MIN 0 0 0\n"
               "DOMAIN_MAX 1 1 1\nLUT_3D_SIZE 2\n0.1 0.2\n0 0 0\nx 1 1\n"
               "1 0 0 # trailing\n0 1 0\n1 1 0\n0 0 1\n1 0 1\n0 1 1\n"
               "1 1 1\n0.5 0.5 0.5\n"),
    "short": "LUT_3D_SIZE 2\n0 0 0\n1 0 0\n",
    "size_1": "LUT_3D_SIZE 1\n0 0 0\n",
    "size_65": "LUT_3D_SIZE 65\n0 0 0\n",
    "bad_size_line": "LUT_3D_SIZE x\n",
    "no_size": "0 0 0\n1 1 1\n",
}


@pytest.mark.parametrize("case", sorted(CUBE_TEXTS))
def test_load_cube_matches_tpuvf(case, tmp_path):
    path = tmp_path / f"{case}.cube"
    path.write_text(CUBE_TEXTS[case])
    try:
        want = tlut.load_cube(str(path))
    except tlut.LutError as exc:
        with pytest.raises(plut.LutError):
            plut.load_cube(str(path))
        assert case != "quirks", exc
        return
    got = plut.load_cube(str(path))
    assert got.dtype == want.dtype == np.float32
    assert np.array_equal(got, want)


def test_load_cube_grade_round_trip(tmp_path):
    table = grade(17, seed=1)
    path = write_cube(tmp_path / "g.cube", table, header="TITLE \"g\"\n")
    got = plut.load(path)
    assert np.array_equal(got, tlut.load(path))
    # the file's 6 decimals (5e-7) plus float32 rounding of both sides
    assert np.abs(got - table).max() <= 5e-7 + 2 ** -23


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    return a if pa <= pb and pa <= pc else (b if pb <= pc else c)


def png_by_hand(rgba: np.ndarray, filters) -> bytes:
    """An 8-bit RGBA PNG whose row y uses filter type filters[y % len]."""
    h, w, _ = rgba.shape
    raw = rgba.reshape(h, w * 4).astype(np.int32)
    rows = []
    for y in range(h):
        ft = filters[y % len(filters)]
        up = raw[y - 1] if y else np.zeros(w * 4, np.int32)
        line = []
        for x in range(w * 4):
            left = raw[y, x - 4] if x >= 4 else 0
            ul = up[x - 4] if x >= 4 else 0
            pred = [0, left, up[x], (left + up[x]) // 2,
                    _paeth(left, up[x], ul)][ft]
            line.append((raw[y, x] - pred) & 0xFF)
        rows.append(bytes([ft]) + bytes(line))

    def chunk(ctype, payload):
        body = ctype + payload
        return (struct.pack(">I", len(payload)) + body
                + struct.pack(">I", zlib.crc32(body) & 0xFFFFFFFF))

    ihdr = struct.pack(">IIBBBBB", w, h, 8, 6, 0, 0, 0)
    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", ihdr)
            + chunk(b"IDAT", zlib.compress(b"".join(rows)))
            + chunk(b"IEND", b""))


def png_grid(table: np.ndarray, per_row: int, alpha) -> np.ndarray:
    """(S,S,S,3) table -> the reference's slice-grid RGBA image."""
    s = table.shape[0]
    img = np.zeros((s * ((s + per_row - 1) // per_row), s * per_row, 4),
                   np.uint8)
    for b in range(s):
        sy, sx = (b // per_row) * s, (b % per_row) * s
        img[sy:sy + s, sx:sx + s, :3] = np.round(table[b] * 255)
        img[sy:sy + s, sx:sx + s, 3] = alpha
    return img


PNG_CASES = {
    # (image maker, bytes maker)
    "rgba_row": (lambda t: png_grid(t, 4, 255), tpng.encode),
    "rgb": (lambda t: png_grid(t, 4, 255)[..., :3], tpng.encode),
    "premultiplied": (lambda t: png_grid(t, 4, 200), tpng.encode),
    "adam7": (lambda t: png_grid(t, 4, 255),
              lambda img: tpng.encode(img, interlace=True)),
    "filters_1_to_4": (lambda t: png_grid(t, 4, 255),
                       lambda img: png_by_hand(img, [1, 2, 3, 4, 0])),
    "bad_size": (lambda t: np.zeros((10, 10, 4), np.uint8), tpng.encode),
}


@pytest.mark.parametrize("case", sorted(PNG_CASES))
def test_load_png_lut_matches_tpuvf(case, tmp_path):
    make_img, encode = PNG_CASES[case]
    path = tmp_path / f"{case}.png"
    path.write_bytes(encode(make_img(grade(4, seed=2))))
    try:
        want = tlut.load(str(path))
    except tlut.LutError:
        with pytest.raises(plut.LutError):
            plut.load(str(path))
        assert case == "bad_size"
        return
    got = plut.load(str(path))
    assert got.shape == (4, 4, 4, 3) and got.dtype == np.float32
    assert np.array_equal(got, want)


def test_load_rejects_unknown_extension(tmp_path):
    path = str(tmp_path / "grade.3dl")
    for mod in (tlut, plut):
        with pytest.raises(mod.LutError):
            mod.load(path)


# -- table and lookup ---------------------------------------------------------


@pytest.mark.parametrize("size", [2, 5, 17])
def test_pack_lut_corners_matches_tpuvf(size):
    table = grade(size, seed=size)
    got = pfilter.pack_lut_corners(table)
    want = tfilter.pack_lut_corners(table, dtype=np.float32)
    assert got.dtype == np.float32 and got.shape == (size ** 3, 24)
    assert np.array_equal(got, want)


def lut_inputs(h, w, size, seed):
    """Random planes plus exact grid points, 0 and 1 on every axis."""
    rng = np.random.default_rng(seed)
    x = rng.random((4, h, w), dtype=np.float32)
    grid = (np.arange(size, dtype=np.float32) / np.float32(size - 1))
    x[:3, 0, :size] = grid
    x[:3, 1, :3] = [[0, 1, 0], [1, 0, 0], [0, 0, 1]]
    x[:3, 2, 0], x[:3, 2, 1] = 0.0, 1.0
    return x


@pytest.mark.parametrize("size,h,w", [(2, 8, 24), (17, 12, 40), (33, 6, 128)])
def test_apply_lut_plain_matches_tpuvf_exactly(size, h, w):
    """max abs 0 on a float32 table; (6, 128) takes tpuvf's flat gather."""
    packed = pfilter.pack_lut_corners(grade(size, seed=7))
    x = lut_inputs(h, w, size, seed=size)
    want = tfilter.apply_lut_t(tuple(jnp.asarray(c) for c in x),
                               jnp.asarray(packed), size)
    got = pfilter.apply_lut_t_plain(tuple(torch.from_numpy(x).unbind(0)),
                                    torch.from_numpy(packed), size)
    for c in range(4):
        d = np.abs(got[c].numpy() - np.asarray(want[c]))
        assert d.max() == 0.0, (c, d.max())


def test_lut3d_wrapper_on_cpu_is_the_plain_version():
    size = 9
    table = torch.from_numpy(pfilter.pack_lut_corners(grade(size, seed=3)))
    x = torch.from_numpy(lut_inputs(10, 20, size, seed=3))
    before = plutk.lut3d.launches
    for quantize in (False, True):
        got = plutk.lut3d(x, table, size, quantize=quantize)
        want = plutk.lut3d_plain(x, table, size, quantize=quantize)
        assert got.dtype == (torch.uint8 if quantize else torch.float32)
        assert torch.equal(got, want)
    assert plutk.lut3d.launches == before  # the CPU path launches nothing
    with pytest.raises(ValueError):
        plutk.lut3d(x, table, size + 1)
    with pytest.raises(TypeError):
        plutk.lut3d(x.double(), table, size)
    with pytest.raises(ValueError):
        plutk.lut3d(x[:3], table, size)


def test_blur_and_unsharp_match_tpuvf():
    """The sharpness stage's float math: within float32 rounding of tpuvf
    (XLA may contract its tap sums), so equal after the RGBA8 store."""
    x = np.random.default_rng(9).random((4, 12, 20), dtype=np.float32)
    xt = torch.from_numpy(x)
    for axis in (-1, -2):
        got = pfilter.blur9(xt, axis).numpy()
        want = np.asarray(tfilter.blur9(jnp.asarray(x), axis))
        assert np.abs(got - want).max() <= 1e-6
    blurred = np.array(tfilter.blur9(jnp.asarray(x), -1))
    for amount in (0.8, -0.6):
        got = pfilter.unsharp_mask(xt, torch.from_numpy(blurred),
                                   torch.tensor(amount)).numpy()
        want = np.asarray(tfilter.unsharp_mask(
            jnp.asarray(x), jnp.asarray(blurred), jnp.float32(amount)))
        assert np.abs(got - want).max() <= 1e-6


# -- the element --------------------------------------------------------------

BCS_CK = {"brightness": 0.1, "contrast": 1.2, "saturation": 1.3,
          "chroma-key-enabled": True}
ELEMENT_CASES = [
    # (name, props without the LUT, format, with LUT)
    ("lut_rgba", {}, "RGBA", True),
    ("lut_nv12", {}, "NV12", True),
    ("lut_bcs_ck_rgba", BCS_CK, "RGBA", True),
    ("lut_bcs_ck_nv12", BCS_CK, "NV12", True),
    ("sharp_0.8", {"sharpness": 0.8}, "RGBA", False),
    ("sharp_-0.6", {"sharpness": -0.6}, "RGBA", False),
    ("lut_sharp", {"contrast": 1.1, "sharpness": 0.5}, "RGBA", True),
]
ELEMENT_IDS = [c[0] for c in ELEMENT_CASES]


def _props(tmp_path, props, with_lut):
    props = dict(props)
    if with_lut:
        props["lut-file"] = write_cube(tmp_path / "grade.cube", grade(9, 11))
    return props


@pytest.mark.parametrize("name,props,fmt,with_lut", ELEMENT_CASES,
                         ids=ELEMENT_IDS)
def test_videofilter_lut_sharpness_matches_tpuvf_f32(name, props, fmt,
                                                     with_lut, tmp_path,
                                                     monkeypatch):
    monkeypatch.setenv("TPUVF_LUT_F32", "1")
    t, p = run_both(TVideoFilter, PVideoFilter,
                    _props(tmp_path, props, with_lut), fmt, 48, 32,
                    f"video/x-raw,format={fmt}")
    worst, share = diff_stats(t[0], p[0])
    print(f"{name} vs tpuvf f32 table: max {worst} LSB, {share:.4%} differ")
    assert worst <= 1  # knife edges of float association (module doc)


@pytest.mark.parametrize("name,props,fmt,with_lut",
                         [c for c in ELEMENT_CASES if c[3]],
                         ids=[c[0] for c in ELEMENT_CASES if c[3]])
def test_videofilter_lut_matches_tpuvf_u8_table(name, props, fmt, with_lut,
                                                tmp_path, monkeypatch):
    monkeypatch.delenv("TPUVF_LUT_F32", raising=False)
    t, p = run_both(TVideoFilter, PVideoFilter,
                    _props(tmp_path, props, with_lut), fmt, 48, 32,
                    f"video/x-raw,format={fmt}")
    worst, share = diff_stats(t[0], p[0])
    print(f"{name} vs tpuvf u8 table: max {worst} LSB, {share:.4%} differ")
    assert worst <= 2  # tpuvf's uint8 corners (module doc)


def _oracle(planes, fmt, w, h, props, table):
    """tests/oracle's Metal semantics of the element (as
    tests/test_videofilter.py builds it)."""
    spec = tspec.FrameSpec(TFormat(fmt), w, h)
    rgba = metal_ref.sample_rgba(planes, fmt, spec.matrix_index, w, h)
    tx = (np.arange(w, dtype=np.float32) + 0.5) / w
    ty = (np.arange(h, dtype=np.float32) + 0.5) / h
    tc = np.stack(np.broadcast_arrays(tx[None, :], ty[:, None]), -1)
    ck = props.get("chroma-key-enabled", False)
    u = dict(brightness=props.get("brightness", 0.0),
             contrast=props.get("contrast", 1.0),
             saturation=props.get("saturation", 1.0), hue=0.0, gamma=1.0,
             sepia=0.0, invert=False, chroma_key_enabled=ck, key_r=0.0,
             key_g=1.0, key_b=0.0, key_tolerance=0.2, key_smoothness=0.1,
             vignette=0.0, noise=0.0)
    rgba = filter_ref.apply_color_adjustments(rgba, u, tc, 0)
    if table is not None:
        rgba = filter_ref.apply_lut(rgba, table, table.shape[0])
    q = metal_ref.quant(rgba)
    sharp = props.get("sharpness", 0.0)
    if abs(sharp) > 0.001:
        bh = metal_ref.quant(filter_ref.blur_axis(metal_ref.dequant(q), 1))
        bv = metal_ref.quant(filter_ref.blur_axis(metal_ref.dequant(bh), 0))
        q = metal_ref.quant(filter_ref.unsharp(
            metal_ref.dequant(q), metal_ref.dequant(bv), sharp))
    return metal_ref.pack_rgba(q.transpose(2, 0, 1), fmt, spec.matrix_index)


@pytest.mark.parametrize("name,props,fmt,with_lut", ELEMENT_CASES,
                         ids=ELEMENT_IDS)
def test_videofilter_lut_sharpness_matches_oracle(name, props, fmt, with_lut,
                                                  tmp_path):
    w, h = 48, 32
    props = _props(tmp_path, props, with_lut)
    host = random_host(np.random.default_rng(0), fmt, w, h)  # run_both's
    _, p = run_both(TVideoFilter, PVideoFilter, props, fmt, w, h,
                    f"video/x-raw,format={fmt}")
    table = plut.load(props["lut-file"]) if with_lut else None
    want = _oracle(tframe.host_to_planes(host, tspec.FrameSpec(TFormat(fmt),
                                                                w, h)),
                   fmt, w, h, props, table)
    worst, share = diff_stats(want, p[0])
    print(f"{name} vs oracle: max {worst} LSB, {share:.4%} differ")
    assert worst <= 2  # the oracle's tolerance (module doc)


@pytest.mark.parametrize("case", ["missing", "bad_cube"])
def test_lut_soft_failure_matches_tpuvf(case, tmp_path, caplog):
    """An unreadable LUT logs a warning and leaves no LUT: the element is
    not elided (lut-file is not at its default) and emits the input."""
    path = tmp_path / "grade.cube"
    if case == "bad_cube":
        path.write_text("LUT_3D_SIZE 900\n")
    props = {"lut-file": str(path)}
    spec_t = tspec.FrameSpec(TFormat.RGBA, 32, 24)
    spec_p = PSpec(PFormat.RGBA, 32, 24)
    with caplog.at_level(logging.WARNING, logger="tpuvf_torch.videofilter"):
        pel = PVideoFilter(**props)
        assert pel.static_config(spec_p, spec_p)[1] == ("lut_size", 0)
    assert any("failed to load LUT" in r.getMessage() for r in caplog.records
               if r.name == "tpuvf_torch.videofilter")
    tel = TVideoFilter(**props)
    assert (pel.is_passthrough(spec_p, spec_p)
            == tel.is_passthrough(spec_t, spec_t) is False)
    assert "lut" not in pel.traced_params("cpu")
    t, p = run_both(TVideoFilter, PVideoFilter, props, "RGBA", 32, 24,
                    "video/x-raw,format=RGBA")
    assert np.array_equal(t[0]["rgba"], p[0]["rgba"])


def test_lut_table_uploaded_once_per_load_and_device(tmp_path):
    p1 = write_cube(tmp_path / "a.cube", grade(5, 1))
    p2 = write_cube(tmp_path / "b.cube", grade(5, 2))
    el = PVideoFilter(**{"lut-file": p1})
    first = el.traced_params("cpu")["lut"]
    assert el.traced_params("cpu")["lut"] is first
    el.set_property("lut-file", p2)
    second = el.traced_params("cpu")["lut"]
    assert second is not first and not torch.equal(second, first)
    assert torch.equal(second, torch.from_numpy(
        pfilter.pack_lut_corners(plut.load(p2))))


# -- the whole chain ----------------------------------------------------------

CHAINS = {
    # BASELINE config 3 cut to 64x48: NV12 -> NV12
    "config3_nv12": ("appsrc format=NV12 width=64 height=48 ! "
                     "vfmetalvideofilter brightness=0.1 contrast=1.2 "
                     "saturation=1.3 chroma-key-enabled=true lut-file={lut} "
                     "! appsink", "NV12"),
    # the same to BGRA
    "config3_bgra": ("appsrc format=NV12 width=64 height=48 ! "
                     "vfmetalvideofilter brightness=0.1 contrast=1.2 "
                     "saturation=1.3 chroma-key-enabled=true lut-file={lut} "
                     "! vfmetalconvertscale ! video/x-raw,format=BGRA ! "
                     "appsink", "NV12"),
    # RGBA LUT + sharpness -> BGRA
    "lut_sharp_bgra": ("appsrc format=RGBA width=64 height=48 ! "
                       "vfmetalvideofilter lut-file={lut} contrast=1.1 "
                       "sharpness=0.5 ! vfmetalconvertscale ! "
                       "video/x-raw,format=BGRA ! appsink", "RGBA"),
}


def _run(parse, desc, frames, **kw):
    pipe = parse(desc, **kw)
    src = pipe["appsrc0"]
    for f in frames:
        src.push(f)
    src.end_of_stream()
    pipe.negotiate()
    pipe.build()
    assert pipe.run() == len(frames)
    return pipe["appsink0"].frames


@pytest.mark.parametrize("chain", sorted(CHAINS))
def test_lut_chain_matches_tpuvf_pipeline(chain, tmp_path, monkeypatch):
    monkeypatch.setenv("TPUVF_NO_SPLIT_LINKS", "1")
    monkeypatch.setenv("TPUVF_LUT_F32", "1")
    desc, fmt = CHAINS[chain]
    desc = desc.format(lut=write_cube(tmp_path / "g.cube", grade(17, 5)))
    rng = np.random.default_rng(13)
    frames = [random_host(rng, fmt, 64, 48) for _ in range(2)]
    want = _run(tpuvf_parse, desc, frames)
    got = _run(port_parse, desc, frames, device="cpu")
    for i, (g, w) in enumerate(zip(got, want)):
        gd = g if isinstance(g, dict) else {"frame": g}
        wd = w if isinstance(w, dict) else {"frame": w}
        worst, share = diff_stats(wd, gd)
        print(f"{chain} frame {i}: max {worst} LSB, {share:.4%} differ")
        assert worst <= 1  # <= 1 LSB (module doc)
