"""vfconvertscale and vfvideofilter of the PyTorch port against tpuvf's
`make_process` on the same numpy frames (port on the CPU, where the resample
wrappers run their plain versions).

Tolerances, per case:
- NV12 -> BGRA at identity geometry: bitwise.  Both sides compute the 2x
  chroma taps as w0*a + w1*b with the same float32 weights and the same
  color-matrix expression.
- scaled / odd / letterbox / nearest / format changes: <= 1 LSB.  tpuvf
  samples those axes with closed forms or HIGHEST-precision matmuls, each
  within 1 ulp of the 2-tap sum; after quantization a knife-edge pixel may
  flip by one.
- videofilter b/c/s, hue, gamma, vignette: <= 1 LSB, with under 1% of the
  values differing at all (pow/HSV rounding and float association).
- film grain: <= 2 LSB on all but an outlier share of under 1%: the hash is
  chaotic under FMA contraction, so a contracted multiply-add in the
  reference moves a few pixels' grain arbitrarily.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tpuvf.core import frame as tframe, spec as tspec
from tpuvf.core.formats import VideoFormat as TFormat
from tpuvf.kernels import convert as tconvert
from tpuvf.elements.convertscale import ConvertScale as TConvertScale
from tpuvf.elements.videofilter import VideoFilter as TVideoFilter
from tpuvf_torch.core import frame as pframe, spec as pspec
from tpuvf_torch.core.formats import VideoFormat as PFormat
from tpuvf_torch.elements.convertscale import ConvertScale as PConvertScale
from tpuvf_torch.elements.videofilter import VideoFilter as PVideoFilter
from tpuvf_torch.kernels import convert as pconvert

torch.set_num_threads(1)


def random_host(rng, fmt, w, h):
    cw, ch = (w + 1) // 2, (h + 1) // 2
    if fmt in ("BGRA", "RGBA"):
        return rng.integers(0, 256, (h, w, 4), dtype=np.uint8)
    y = rng.integers(0, 256, (h, w), dtype=np.uint8)
    if fmt == "NV12":
        return {"y": y, "uv": rng.integers(0, 256, (ch, 2 * cw), dtype=np.uint8)}
    return {"y": y, "u": rng.integers(0, 256, (ch, cw), dtype=np.uint8),
            "v": rng.integers(0, 256, (ch, cw), dtype=np.uint8)}


def run_both(tcls, pcls, props, fmt, w, h, caps, frames=1, seed=0):
    """Run one element of each package on the same frames.
    -> (tpuvf outputs, port outputs), lists of canonical numpy planes."""
    rng = np.random.default_rng(seed)
    hosts = [random_host(rng, fmt, w, h) for _ in range(frames)]
    t_in = tspec.FrameSpec(TFormat(fmt), w, h)
    p_in = pspec.FrameSpec(PFormat(fmt), w, h)
    tel, pel = tcls(**props), pcls(**props)
    t_out = tel.transform_spec(t_in, tspec.CapsFilter.parse(caps))
    p_out = pel.transform_spec(p_in, pspec.CapsFilter.parse(caps))
    assert str(t_out) == str(p_out)

    tproc = jax.jit(tel.make_process(t_in, t_out,
                                     tel.static_config(t_in, t_out)))
    tparams, tstate = tel.traced_params(), tel.init_state(t_in, t_out)
    pproc = pel.make_process(p_in, p_out, pel.static_config(p_in, p_out),
                             "cpu")
    pparams, pstate = pel.traced_params("cpu"), pel.init_state(p_in, p_out, "cpu")
    touts, pouts = [], []
    for host in hosts:
        planes = tframe.host_to_planes(host, t_in)
        out, tstate = tproc({k: jnp.asarray(v) for k, v in planes.items()},
                            tstate, tparams)
        touts.append({k: np.asarray(v) for k, v in out.items()})
        out, pstate = pproc(pframe.to_device(pframe.host_to_planes(host, p_in),
                                             "cpu"), pstate, pparams)
        pouts.append(pframe.to_host(out))
    return touts, pouts


def diff_stats(want, got):
    """(max |diff| in LSB, share of differing values) over all planes."""
    assert set(want) == set(got)
    worst, bad, total = 0, 0, 0
    for k in want:
        assert want[k].shape == got[k].shape and got[k].dtype == np.uint8, k
        d = np.abs(want[k].astype(np.int32) - got[k].astype(np.int32))
        worst = max(worst, int(d.max()))
        bad += int((d > 0).sum())
        total += d.size
    return worst, bad / total


def test_convertscale_nv12_to_bgra_identity_bitwise():
    t, p = run_both(TConvertScale, PConvertScale, {}, "NV12", 96, 64,
                    "video/x-raw,format=BGRA,width=96,height=64")
    for k in t[0]:
        assert np.array_equal(t[0][k], p[0][k]), k  # bitwise (see module doc)


CONVERT_CASES = [
    # (name, props, in format, w, h, caps)
    ("scaled", {}, "NV12", 64, 48, "video/x-raw,format=BGRA,width=40,height=30"),
    ("odd_size", {}, "NV12", 37, 23, "video/x-raw,format=BGRA,width=37,height=23"),
    ("letterbox", {"add-borders": True, "border-color": 0xFF2040C0}, "NV12",
     64, 48, "video/x-raw,format=BGRA,width=48,height=48"),
    ("nearest", {"method": 1}, "NV12", 64, 48,
     "video/x-raw,format=BGRA,width=40,height=30"),
    ("i420_to_nv12", {}, "I420", 64, 48, "video/x-raw,format=NV12,width=64,height=48"),
    ("i420_to_nv12_scaled", {}, "I420", 64, 48,
     "video/x-raw,format=NV12,width=32,height=24"),
    ("bgra_to_rgba_scaled", {}, "BGRA", 64, 48,
     "video/x-raw,format=RGBA,width=40,height=30"),
    ("upscale_odd", {}, "NV12", 30, 18, "video/x-raw,format=BGRA,width=77,height=41"),
]


@pytest.mark.parametrize("name,props,fmt,w,h,caps", CONVERT_CASES,
                         ids=[c[0] for c in CONVERT_CASES])
def test_convertscale_matches_tpuvf(name, props, fmt, w, h, caps):
    t, p = run_both(TConvertScale, PConvertScale, props, fmt, w, h, caps)
    worst, share = diff_stats(t[0], p[0])
    print(f"{name}: max {worst} LSB, {share:.4%} values differ")
    assert worst <= 1  # <= 1 LSB: resampling re-expressions (module doc)


FILTER_PROPS = {
    "bcs": {"brightness": 0.05, "contrast": 1.1, "saturation": 1.2},
    "hue": {"hue": 0.3, "saturation": 0.8},
    "gamma": {"gamma": 1.7, "brightness": -0.1},
    "vignette": {"vignette": 0.6, "contrast": 0.9},
    "sepia_invert": {"sepia": 0.5, "invert": True},
    "chroma_key": {"chroma-key-enabled": True, "chroma-key-color": 0xFF808080,
                   "chroma-key-tolerance": 0.3},
}


@pytest.mark.parametrize("name", sorted(FILTER_PROPS))
def test_videofilter_bgra_matches_tpuvf(name):
    t, p = run_both(TVideoFilter, PVideoFilter, FILTER_PROPS[name], "BGRA",
                    64, 48, "video/x-raw,format=BGRA")
    worst, share = diff_stats(t[0], p[0])
    print(f"{name}: max {worst} LSB, {share:.4%} values differ")
    assert worst <= 1 and share < 0.01  # pow/HSV rounding (module doc)


def test_videofilter_nv12_bcs_matches_tpuvf():
    t, p = run_both(TVideoFilter, PVideoFilter, FILTER_PROPS["bcs"], "NV12",
                    64, 48, "video/x-raw,format=NV12")
    worst, share = diff_stats(t[0], p[0])
    print(f"nv12 bcs: max {worst} LSB, {share:.4%} values differ")
    assert worst <= 1 and share < 0.01


def test_videofilter_grain_matches_tpuvf():
    """Two frames, so the carried frame counter changes the grain."""
    t, p = run_both(TVideoFilter, PVideoFilter, {"noise": 0.3}, "BGRA",
                    64, 48, "video/x-raw,format=BGRA", frames=2)
    assert not np.array_equal(p[0]["rgba"], p[1]["rgba"])
    for i in range(2):
        d = np.abs(t[i]["rgba"].astype(np.int32) - p[i]["rgba"].astype(np.int32))
        outliers = float((d > 2).mean())
        print(f"grain frame {i}: max {int(d.max())} LSB, {outliers:.4%} over 2")
        assert outliers < 0.01  # chaotic hash under FMA (module doc)


@pytest.mark.parametrize("fmt", ["BGRA", "NV12", "I420", "UYVY", "YUY2"])
@pytest.mark.parametrize("matrix", [0, 1])
def test_pack_rgba_matches_tpuvf(fmt, matrix):
    """The output pack from quantized RGBA, odd height for the 4:2:0 edge
    clamp (even width: 4:2:2 pairs columns)."""
    rgba_q = np.random.default_rng(3).integers(0, 256, (4, 23, 36),
                                                 dtype=np.uint8)
    want = tconvert.pack_rgba(jnp.asarray(rgba_q), TFormat(fmt), matrix)
    got = pconvert.pack_rgba(torch.from_numpy(rgba_q), PFormat(fmt), matrix)
    worst, _ = diff_stats({k: np.asarray(v) for k, v in want.items()},
                          {k: v.numpy() for k, v in got.items()})
    assert worst <= 1  # <= 1 LSB: float association of the chroma averages
