"""`runtime.params.from_tpuvf`: a tpuvf element's traced params and state
carried into the port agree with the port element's own, bitwise; tpuvf's
fixed-point LUT tables arrive as float32 corners scaled by f32(1/255) or
f32(1/65535)."""

import numpy as np
import pytest
import torch

from tpuvf.core.formats import VideoFormat as TFormat
from tpuvf.core.spec import FrameSpec as TSpec
from tpuvf.core.registry import make as t_make
from tpuvf.elements.convertscale import ConvertScale as TConvertScale
from tpuvf.elements.videofilter import VideoFilter as TVideoFilter
from tpuvf_torch.core.formats import VideoFormat as PFormat
from tpuvf_torch.core.spec import FrameSpec as PSpec
from tpuvf_torch.elements.compositor import Compositor as PCompositor
from tpuvf_torch.elements.convertscale import ConvertScale as PConvertScale
from tpuvf_torch.elements.videofilter import VideoFilter as PVideoFilter
from tpuvf_torch.runtime.params import from_tpuvf

torch.set_num_threads(1)

PROPS = {"brightness": 0.05, "contrast": 1.1, "saturation": 1.2, "hue": -0.3,
         "gamma": 2.2, "vignette": 0.4, "noise": 0.25, "invert": True,
         "chroma-key-color": 0xFF1080F0, "chroma-key-tolerance": 0.35}


def test_videofilter_params_and_state_round_trip():
    tel, pel = TVideoFilter(**PROPS), PVideoFilter(**PROPS)
    spec_t, spec_p = TSpec(TFormat.BGRA, 32, 24), PSpec(PFormat.BGRA, 32, 24)
    state = {"frame_index": np.uint32(2**32 - 1)}
    params, pstate = from_tpuvf(tel.traced_params(), state, "cpu")
    own = pel.traced_params("cpu")
    assert set(params) == set(own)
    for k in own:
        assert params[k].dtype == torch.float32 and params[k].dim() == 0
        assert torch.equal(params[k], own[k]), k  # the same float32 bits
        assert params[k].item() == float(tel.traced_params()[k])
    assert pstate["frame_index"].dtype == torch.int64
    assert int(pstate["frame_index"]) == 2**32 - 1
    assert int((pstate["frame_index"] + 1) & 0xFFFFFFFF) == 0  # uint32 wrap
    _, fresh = from_tpuvf({}, tel.init_state(spec_t, spec_t), "cpu")
    assert torch.equal(fresh["frame_index"],
                       pel.init_state(spec_p, spec_p, "cpu")["frame_index"])


def test_convertscale_weight_buffers_are_dropped():
    tel = TConvertScale(**{"add-borders": True})
    in_t, out_t = TSpec(TFormat.NV12, 64, 48), TSpec(TFormat.BGRA, 48, 48)
    tel.make_process(in_t, out_t, tel.static_config(in_t, out_t))
    tparams = tel.traced_params()
    assert any(k.startswith("__buf/") for k in tparams)
    params, state = from_tpuvf(tparams, tel.init_state(in_t, out_t), "cpu")
    assert params == {} and state == ()
    assert PConvertScale(**{"add-borders": True}).traced_params("cpu") == {}


PAD_PROPS = {"sink_0": {"xpos": -17, "ypos": 40, "alpha": 0.7,
                        "operator": 2, "zorder": 3},
             "sink_1": {"xpos": 1920, "alpha": 1.0 / 3.0, "operator": 0}}


def test_compositor_pad_params_carry_as_host_numbers():
    """tpuvf's int32/float32 pad params arrive as the Python ints and
    float32-valued floats the port's compositor gives itself; the planned
    background buffer (``__buf/bg``) is dropped."""
    tcomp, pcomp = t_make("vfcompositor"), PCompositor(name="c")
    specs = {}
    for name, props in PAD_PROPS.items():
        for k, v in props.items():
            tcomp.get_pad(name).set(k, v)
            pcomp.get_pad(name).set(k, v)
        specs[name] = TSpec(TFormat.BGRA, 64, 32)
    tcomp.make_aggregate(specs, tcomp.aggregate_spec(specs, None))
    tparams = tcomp.traced_params()
    assert any(k.startswith("__buf/") for k in tparams)
    params, state = from_tpuvf(tparams, tcomp.init_state(None, None), "cpu")
    own = pcomp.traced_params("cpu")
    assert params == own and state == ()
    for key, value in own.items():
        assert type(value) is type(params[key]), key
        assert type(value) is (float if key.endswith(".alpha") else int)
    assert params["pad.sink_1.alpha"] == float(np.float32(1.0 / 3.0))
    assert params["pad.sink_0.xpos"] == -17


@pytest.mark.parametrize("method", [1, 3])
def test_deinterlace_state_carries_as_one_stack(method):
    """tpuvf's prev tuple of four (H, W) uint8 planes becomes one (4, H, W)
    uint8 tensor and has_prev a Python bool; the motion threshold is a
    0-dim float32 tensor like the port element's own."""
    from tpuvf.elements.deinterlace import Deinterlace as TDeinterlace
    from tpuvf_torch.elements.deinterlace import Deinterlace as PDeinterlace

    spec_t = TSpec(TFormat.NV12, 32, 24, interlaced=True)
    spec_p = PSpec(PFormat.NV12, 32, 24, interlaced=True)
    tel = TDeinterlace(method=method, motion_threshold=0.3)
    pel = PDeinterlace(method=method, motion_threshold=0.3)
    out_t = tel.transform_spec(spec_t)
    tel.make_process(spec_t, out_t, tel.static_config(spec_t, out_t))
    rng = np.random.default_rng(1)
    prev = tuple(rng.integers(0, 256, (24, 32), dtype=np.uint8)
                 for _ in range(4))
    state = {"prev": prev, "has_prev": np.bool_(True)}
    params, pstate = from_tpuvf(tel.traced_params(), state, "cpu")
    own = pel.traced_params("cpu")
    assert set(params) == set(own) == {"motion-threshold"}
    assert torch.equal(params["motion-threshold"], own["motion-threshold"])
    assert pstate["has_prev"] is True
    assert pstate["prev"].dtype == torch.uint8
    assert np.array_equal(pstate["prev"].numpy(), np.stack(prev))
    _, fresh = from_tpuvf({}, tel.init_state(spec_t, out_t), "cpu")
    own_state = pel.init_state(spec_p, spec_p, "cpu")
    assert fresh["has_prev"] is own_state["has_prev"] is False
    assert torch.equal(fresh["prev"], own_state["prev"])


def test_overlay_alpha_carries_and_buffers_drop(tmp_path):
    from tpuvf.elements.overlay import Overlay as TOverlay
    from tpuvf.io import png
    from tpuvf_torch.elements.overlay import Overlay as POverlay

    path = str(tmp_path / "ov.png")
    png.write(path, np.full((6, 8, 4), 90, np.uint8))
    tel = TOverlay(x=3, alpha=0.35)
    tel.set_property("location", path)
    spec = TSpec(TFormat.BGRA, 32, 24)
    tel.make_process(spec, spec, tel.static_config(spec, spec))
    tparams = tel.traced_params()
    assert any(k.startswith("__buf/") for k in tparams)
    params, state = from_tpuvf(tparams, (), "cpu")
    own = POverlay(x=3, alpha=0.35).traced_params("cpu")
    assert set(params) == set(own) == {"alpha"} and state == ()
    assert params["alpha"].dtype == torch.float32 and params["alpha"].dim() == 0
    assert torch.equal(params["alpha"], own["alpha"])


def test_folded_compositor_params_carry(tmp_path, monkeypatch):
    """A tpuvf compositor that folded a vfoverlay carries over: its
    ``fold.<name>.alpha`` arrives as the float32-valued Python float the
    port's folded compositor gives itself, beside the pad params."""
    from tests.test_torch_fold import COMP, PADS, _feeds, _png, _run
    from tpuvf.cli.launch import parse_pipeline as tpuvf_parse
    from tpuvf_torch.cli.launch import parse_pipeline as port_parse

    monkeypatch.setenv("TPUVF_NO_SPLIT_LINKS", "1")
    image = _png(tmp_path, "a.png", 8, 6, seed=1, alpha=150)
    desc = (COMP.format(fmt="BGRA") + f"! vfmetaloverlay name=o1 "
            f"location={image} x=3 y=2 alpha=0.35 ! appsink " + PADS)
    tparams = _run(tpuvf_parse, desc, _feeds(3))["c"].traced_params()
    assert "fold.o1.alpha" in tparams
    params, state = from_tpuvf(tparams, (), "cpu")
    own = _run(port_parse, desc, _feeds(3), device="cpu").params()["c"]
    assert params == own and state == ()
    assert type(params["fold.o1.alpha"]) is float
    assert params["fold.o1.alpha"] == float(np.float32(0.35))


def test_unported_params_raise():
    with pytest.raises(NotImplementedError):
        from_tpuvf({"weights": np.zeros((8, 24), np.float32)}, (), "cpu")
    with pytest.raises(NotImplementedError):
        from_tpuvf({"lut": np.zeros((8, 24), np.int32)}, (), "cpu")


def _write_cube(path, size, seed):
    rng = np.random.default_rng(seed)
    vals = rng.random((size ** 3, 3), dtype=np.float32)
    with open(path, "w") as fh:
        fh.write(f"LUT_3D_SIZE {size}\n")
        fh.writelines(f"{r:.6f} {g:.6f} {b:.6f}\n" for r, g, b in vals)


def test_videofilter_f32_lut_table_carries_unchanged(tmp_path, monkeypatch):
    """Under TPUVF_LUT_F32=1 tpuvf keeps the float32 corner table; carried
    over it is the port element's own table, bitwise."""
    path = str(tmp_path / "grade.cube")
    _write_cube(path, 5, seed=4)
    monkeypatch.setenv("TPUVF_LUT_F32", "1")
    tparams = TVideoFilter(**{"lut-file": path}).traced_params()
    assert tparams["lut"].dtype == np.float32
    params, _ = from_tpuvf(tparams, (), "cpu")
    own = PVideoFilter(**{"lut-file": path}).traced_params("cpu")["lut"]
    assert params["lut"].dtype == torch.float32
    assert torch.equal(params["lut"], own)
    assert np.array_equal(params["lut"].numpy(), tparams["lut"])


@pytest.mark.parametrize("dtype,scale", [(np.uint8, 255.0),
                                         (np.uint16, 65535.0)])
def test_fixed_point_lut_table_becomes_float32(dtype, scale):
    """tpuvf's default fixed-point tables: corners * f32(1/scale), each
    within half a fixed-point step of the float32 table it was made from
    (<= 1 LSB after the RGBA8 store)."""
    rng = np.random.default_rng(5)
    exact = rng.random((27, 24), dtype=np.float32)
    fixed = np.round(exact * np.float32(scale)).astype(dtype)
    params, _ = from_tpuvf({"lut": fixed}, (), "cpu")
    got = params["lut"]
    assert got.dtype == torch.float32 and tuple(got.shape) == (27, 24)
    want = fixed.astype(np.float32) * np.float32(1.0 / scale)
    assert np.array_equal(got.numpy(), want)
    assert np.abs(got.numpy() - exact).max() <= 0.5 / scale + 1e-7
