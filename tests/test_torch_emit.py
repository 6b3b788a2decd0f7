"""K2, the fused emit, on the CPU: `emit_plain` against the path it replaced
and against tpuvf, the wrapper's checks, the CUDA source's constants and
slot orders, and the kernel build's bookkeeping.

Tolerances, per case:
- `emit_plain` against the first slice's composed path (dequant ->
  yuv_to_rgb -> border `where` over the full mask -> adjustments -> quant):
  torch.equal (the same ops in the same order).
- `emit_plain` against tpuvf's `yuv_to_rgb` + `apply_color_adjustments_t` +
  `quant` on the same planes: <= 1 LSB with under 1% of values differing
  (pow/HSV rounding and float association); with film grain, an outlier
  share of under 1% beyond 2 LSB (the hash is chaotic under the FMA
  contraction XLA may apply), as in tests/test_torch_elements.py.
"""

import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpuvf.kernels import color as tcolor, filter as tfilter
from tpuvf_torch.kernels import _build, color, emit as kemit, filter as kfilter
from tpuvf_torch.kernels.emit import Adjust, Border, emit, emit_plain

torch.set_num_threads(1)

H, W = 18, 40
PARAMS = {
    "bcs": {"brightness": 0.1, "contrast": 1.2, "saturation": 1.3},
    "bcs_ck": {"brightness": 0.1, "contrast": 1.2, "saturation": 1.3,
               "chroma_key_enabled": 1.0, "key_r": 0.4, "key_g": 0.6,
               "key_b": 0.2, "key_tolerance": 0.3},
    "all": {"brightness": -0.05, "contrast": 1.1, "saturation": 0.9,
            "hue": 0.4 * np.pi, "gamma": 1.8, "sepia": 0.3, "invert": 1.0,
            "chroma_key_enabled": 1.0, "key_r": 0.4, "key_g": 0.6,
            "key_b": 0.2, "key_tolerance": 0.3, "vignette": 0.5,
            "noise": 0.3},
}
DEFAULTS = {"brightness": 0.0, "contrast": 1.0, "saturation": 1.0, "hue": 0.0,
            "gamma": 1.0, "sharpness": 0.0, "sepia": 0.0, "invert": 0.0,
            "noise": 0.0, "vignette": 0.0, "chroma_key_enabled": 0.0,
            "key_r": 0.0, "key_g": 1.0, "key_b": 0.0, "key_tolerance": 0.2,
            "key_smoothness": 0.1}


def gates_of(values):
    return {"hue": abs(values["hue"]) > 0.001, "gamma": values["gamma"] != 1.0,
            "sepia": values["sepia"] > 0.001, "invert": values["invert"] > 0.5,
            "chroma_key": values["chroma_key_enabled"] > 0.5,
            "vignette": values["vignette"] > 0.001,
            "noise": values["noise"] > 0.001}


def adjust_of(name, frame=0):
    values = dict(DEFAULTS, **PARAMS[name])
    params = {k: torch.tensor(np.float32(v)) for k, v in values.items()}
    return Adjust(params, torch.tensor(frame, dtype=torch.int64),
                  kfilter.plan_coords(W, H, "cpu"), gates_of(values)), values


def sources(seed):
    """{name: emit source} at the output grid, made with numpy."""
    rng = np.random.default_rng(seed)

    def u8(*shape):
        return torch.from_numpy(rng.integers(0, 256, shape, dtype=np.uint8))

    def f32(*shape):
        return torch.from_numpy(rng.random(shape, dtype=np.float32))

    return {
        "yuv_u8": {"y": u8(H, W), "u": f32(H, W), "v": f32(H, W)},
        "yuv_f32": {"y": f32(H, W), "u": f32(H, W), "v": f32(H, W)},
        "rgba_u8": {"rgba": u8(4, H, W)},
        "rgba_f32": {"rgba": f32(4, H, W)},
    }


def border_of():
    rows = np.zeros(H, bool)
    rows[3:-3] = True
    cols = np.ones(W, bool)
    cols[:5] = False
    return Border(torch.from_numpy(rows), torch.from_numpy(cols),
                  tuple(np.float32([0.25, 0.5, 0.75, 1.0]).tolist()))


def first_slice_path(src, matrix, border, adjust, out_float):
    """The emit as the first slice composed it: the sampler's tail
    (plan_rgba_sampler), the element's adjustments, pack_rgba_t's quant."""
    if "rgba" in src:
        x = src["rgba"]
        x = color.dequant(x) if x.dtype == torch.uint8 else x
        chans = tuple(x.unbind(-3))
    else:
        y = src["y"]
        y = color.dequant(y) if y.dtype == torch.uint8 else y
        r, g, b = color.yuv_to_rgb(y, src["u"], src["v"], matrix)
        chans = (r, g, b, torch.ones_like(r))
    if border is not None:
        mask = torch.from_numpy(np.logical_and.outer(border.rows.numpy(),
                                                     border.cols.numpy()))
        chans = tuple(torch.where(mask, c, border.color[i])
                      for i, c in enumerate(chans))
    if adjust is not None:
        chans = kfilter.apply_color_adjustments_t(
            chans, adjust.params, adjust.frame_index, adjust.coords,
            gates=adjust.gates)
    if out_float:
        return torch.stack(chans, dim=-3)
    return torch.stack(tuple(color.quant(c) for c in chans), dim=-3)


CASES = [
    # (source, matrix, border, adjustments, frame, out_float)
    ("yuv_u8", 0, False, None, 0, False),
    ("yuv_f32", 1, False, None, 0, False),
    ("rgba_u8", 0, False, None, 0, False),
    ("rgba_f32", 0, False, None, 0, False),
    ("yuv_f32", 0, True, None, 0, False),
    ("rgba_f32", 0, True, None, 0, False),
    ("rgba_u8", 0, False, "bcs", 0, False),
    ("yuv_u8", 1, False, "bcs_ck", 0, False),
    ("yuv_u8", 0, False, "bcs_ck", 0, True),
    ("rgba_u8", 0, False, "all", 7, False),
    ("yuv_f32", 0, False, "all", 7, True),
]
IDS = [f"{s}-m{m}{'-border' if b else ''}-{a or 'none'}-f{f}"
       f"{'-float' if o else ''}" for s, m, b, a, f, o in CASES]


@pytest.mark.parametrize("src,matrix,border,adj,frame,out_float", CASES,
                         ids=IDS)
def test_emit_plain_equals_first_slice_path(src, matrix, border, adj, frame,
                                            out_float):
    source = sources(seed=len(src) + frame)[src]
    b = border_of() if border else None
    a = adjust_of(adj, frame)[0] if adj else None
    want = first_slice_path(source, matrix, b, a, out_float)
    got = emit_plain(source, matrix, b, a, out_float)
    assert got.dtype == (torch.float32 if out_float else torch.uint8)
    assert got.shape == (4, H, W)
    assert torch.equal(got, want)
    before = emit.launches
    assert torch.equal(emit(source, matrix, b, a, out_float), want)
    assert emit.launches == before  # the CPU path launches nothing


@pytest.mark.parametrize("adj", ["bcs", "bcs_ck", "all"])
@pytest.mark.parametrize("src", ["yuv_u8", "rgba_u8"])
def test_emit_matches_tpuvf(src, adj):
    source = sources(seed=5)[src]
    a, values = adjust_of(adj, frame=7)
    got = emit(source, 0, adjust=a).numpy()
    if "rgba" in source:
        chans = tuple(jnp.asarray(c.numpy())
                      for c in color.dequant(source["rgba"]).unbind(0))
    else:
        r, g, b = tcolor.yuv_to_rgb(
            jnp.asarray(color.dequant(source["y"]).numpy()),
            jnp.asarray(source["u"].numpy()), jnp.asarray(source["v"].numpy()),
            0)
        chans = (r, g, b, jnp.ones_like(r))
    tparams = {k: jnp.float32(v) for k, v in values.items()}
    out = tfilter.apply_color_adjustments_t(
        chans, tparams, jnp.uint32(7), W, H, gates=gates_of(values))
    want = np.stack([np.asarray(tcolor.quant(c)) for c in out])
    d = np.abs(got.astype(np.int32) - want.astype(np.int32))
    print(f"{src} {adj}: max {int(d.max())} LSB, {(d > 0).mean():.4%} differ")
    if values["noise"] > 0.001:
        assert (d > 2).mean() < 0.01  # chaotic grain hash (module doc)
    else:
        assert d.max() <= 1 and (d > 0).mean() < 0.01  # (module doc)


def test_emit_rejects_what_the_kernel_does_not_take():
    s = sources(seed=1)
    with pytest.raises(TypeError):  # chroma must be float32
        emit({"y": s["yuv_u8"]["y"], "u": s["rgba_u8"]["rgba"][0],
              "v": s["rgba_u8"]["rgba"][1]}, 0)
    with pytest.raises(ValueError):  # planes of different shapes
        emit({"y": s["yuv_f32"]["y"][:, :8], "u": s["yuv_f32"]["u"],
              "v": s["yuv_f32"]["v"]}, 0)
    with pytest.raises(ValueError):  # not (4, H, W)
        emit({"rgba": s["rgba_u8"]["rgba"][:3]}, 0)
    with pytest.raises(TypeError):
        emit({"rgba": s["rgba_f32"]["rgba"].double()}, 0)
    with pytest.raises(ValueError):
        emit(s["rgba_u8"], 2)


# -- the CUDA sources ---------------------------------------------------------

# emit.cu with the shared device header it includes, where the colour
# constants live
EMIT_CU = "\n".join((_build.SOURCE_DIR / name).read_text()
                    for name in ("yuv420.cuh", "emit.cu"))


def _constant(name):
    """The double literals of `__constant__ float name[...] = {...};`."""
    m = re.search(r"__constant__ float " + name + r"(?:\[\d+\])+ = (\{.*?\});",
                  EMIT_CU, re.S)
    nums = re.findall(r"-?\d+\.\d*(?:e-?\d+)?(?: / \d+\.\d*)?", m.group(1))
    return np.array([eval(n) for n in nums], np.float64).astype(np.float32)


@pytest.mark.parametrize("name,table", [
    ("kYuvOffset", color.YUV_OFFSET), ("kYuvToRgb", color.YUV_TO_RGB),
    ("kLuma", kfilter.REC709_LUMA), ("kSepiaM", kfilter.SEPIA)])
def test_emit_source_constants_are_the_ports_float32_tables(name, table):
    """The kernel's coefficients round from the same doubles to the same
    float32 values as the tables of the plain version."""
    assert np.array_equal(_constant(name), table.reshape(-1))


def _enum(name):
    body = re.search(r"enum " + name + r" : int \{(.*?)\};", EMIT_CU, re.S)
    return [re.sub(r"\s*=.*", "", n).strip()
            for n in body.group(1).split(",") if n.strip()]


def test_emit_source_slot_and_gate_orders_match_the_wrapper():
    def camel(key, prefix):
        return prefix + "".join(p.capitalize() for p in key.split("_"))

    assert _enum("Param") == [camel(k, "k")
                              for k in kemit.PARAM_KEYS + ("two_pi",)]
    assert _enum("Gate") == [camel(g, "kGate") for g in kfilter.GATES]


def test_build_lists_every_source_and_exported_function():
    names = {p.name for p in _build.sources()}
    assert {"resample.cu", "emit.cu", "lut.cu"} <= names
    exported = set()
    for src in _build.sources():
        text = src.read_text()
        exported |= set(re.findall(r'^extern "C" int (\w+)\(', text, re.M))
        exported |= set(re.findall(r"^TPUVF_EMIT_ENTRY\((\w+),", text, re.M))
    assert exported == set(_build.SIGNATURES)


def test_signatures_match_the_c_parameter_counts():
    """ctypes passes exactly the arguments SIGNATURES lists: a count that
    differs from the C declaration shifts every later argument."""
    counted = 0
    for src in _build.sources():
        for name, params in re.findall(r'^extern "C" int (\w+)\(([^)]*)\)',
                                       src.read_text(), re.M):
            assert len(params.split(",")) == len(_build.SIGNATURES[name]), name
            counted += 1
    assert counted >= 5  # the macro-declared emit entries are counted apart


def test_build_is_stale_when_any_source_is_newer(tmp_path, monkeypatch):
    src_dir = tmp_path / "csrc"
    src_dir.mkdir()
    for name in ("a.cu", "b.cu"):
        (src_dir / name).write_text("// source\n")
    lib = tmp_path / "lib.so"
    monkeypatch.setattr(_build, "SOURCE_DIR", src_dir)
    monkeypatch.setattr(_build, "LIBRARY", lib)
    assert _build._stale()  # no library yet
    lib.write_bytes(b"")
    os.utime(src_dir / "a.cu", (1000, 1000))
    os.utime(src_dir / "b.cu", (1000, 1000))
    os.utime(lib, (2000, 2000))
    assert not _build._stale()
    os.utime(src_dir / "b.cu", (3000, 3000))
    assert _build._stale()
