"""vfcompositor: the port's `make_aggregate` on the CPU against tpuvf's, on
the same numpy pad frames.  tpuvf's aggregate runs as
``tests/test_compositor.py`` runs it (the process called outside jit, its
render bodies compiled by ``lax.cond``); the port's on device "cpu", where
K4 and the sampler/emit kernels take their plain versions.

tpuvf's aggregate runs twice: op by op (``jax.disable_jit``), where every
float32 op rounds once as in the port, and as it runs in tpuvf, where XLA's
CPU backend may contract OVER's ``s + dv * (1 - a)`` (and the yuv<->rgb
sums) into FMAs.  Tolerances, per case:
- against the op-by-op run: bitwise for RGB pads at identity; <= 1 LSB with
  NV12/I420 pads, scaled pads or a YUV output (the chroma and scale taps);
- against the compiled run: <= 1 LSB everywhere (the FMA class of ROADMAP's
  parity contract, which OVER at alpha < 1 meets in a few cases here).
The op-by-op run also came out bitwise for the YUV and scaled cases.
Negotiation (the output spec) must agree exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.util import random_host_frame
from tpuvf.core.formats import VideoFormat as TFormat
from tpuvf.core.frame import host_to_planes as t_host_to_planes
from tpuvf.core.registry import make as t_make
from tpuvf.core.spec import CapsFilter as TCaps, FrameSpec as TSpec
from tpuvf_torch.core.formats import VideoFormat as PFormat
from tpuvf_torch.core.frame import host_to_planes, to_device
from tpuvf_torch.core.spec import CapsFilter as PCaps, FrameSpec as PSpec
from tpuvf_torch.elements.compositor import Compositor

torch.set_num_threads(1)


def run_both(pad_defs, out_caps=None, comp_props=None, seed=0):
    """pad_defs: [(format, w, h, pad props)] as sink_0, sink_1, ...
    -> (port planes, tpuvf planes, port out spec, tpuvf out spec)."""
    rng = np.random.default_rng(seed)
    tcomp, pcomp = t_make("vfcompositor"), Compositor(name="c")
    for k, v in (comp_props or {}).items():
        tcomp.set_property(k, v)
        pcomp.set_property(k, v)
    tspecs, pspecs, tin, pin = {}, {}, {}, {}
    for i, (fmt, w, h, props) in enumerate(pad_defs):
        name = f"sink_{i}"
        for k, v in props.items():
            tcomp.get_pad(name).set(k, v)
            pcomp.get_pad(name).set(k, v)
        tspecs[name] = TSpec(TFormat(fmt), w, h)
        pspecs[name] = PSpec(PFormat(fmt), w, h)
        host = random_host_frame(rng, tspecs[name])
        tin[name] = {k: jnp.asarray(v) for k, v in
                     t_host_to_planes(host, tspecs[name]).items()}
        pin[name] = to_device(host_to_planes(host, pspecs[name]), "cpu")
    tout_spec = tcomp.aggregate_spec(
        tspecs, TCaps.parse(out_caps) if out_caps else None)
    pout_spec = pcomp.aggregate_spec(
        pspecs, PCaps.parse(out_caps) if out_caps else None)
    tproc = tcomp.make_aggregate(tspecs, tout_spec)
    tout, _ = tproc(tin, (), tcomp.traced_params())
    with jax.disable_jit():
        teager, _ = tproc(tin, (), tcomp.traced_params())
    pproc = pcomp.make_aggregate(pspecs, pout_spec, "cpu")
    pout, _ = pproc(pin, (), pcomp.traced_params("cpu"))
    return ({k: v.numpy() for k, v in pout.items()},
            {k: np.asarray(v) for k, v in tout.items()},
            {k: np.asarray(v) for k, v in teager.items()}, pout_spec, tout_spec)


# (label, pad defs, output caps, compositor props, max LSB)
CASES = [
    *[(f"operator-{name}",
       [("RGBA", 32, 24, {}),
        ("RGBA", 32, 24, {"xpos": 8, "ypos": 4, "alpha": 0.5,
                          "operator": op})],
       None, {"background": 1}, 0)
      for op, name in ((0, "source"), (1, "over"), (2, "add"))],
    *[(f"background-{name}", [("RGBA", 16, 16, {"xpos": 32, "alpha": 0.8})],
       None, {"background": bg}, 0)
      for bg, name in ((0, "checker"), (1, "black"), (2, "white"),
                       (3, "transparent"))],
    *[(f"zorder-{z0}{z1}",
       [("BGRA", 24, 16, {"zorder": z0, "alpha": 0.8}),
        ("RGBA", 24, 16, {"xpos": 9, "ypos": 5, "zorder": z1,
                          "alpha": 0.75})],
       None, {"background": 0}, 0)
      for z0, z1 in ((1, 2), (2, 1))],
    ("alpha-zero",
     [("RGBA", 24, 16, {}), ("BGRA", 16, 16, {"xpos": 4, "alpha": 0.0})],
     None, {"background": 0}, 0),
    ("obscured-background-full-cover-nv12", [("NV12", 32, 24, {})], None,
     {"background": 0}, 1),
    ("obscured-pad-under-nv12",
     [("RGBA", 16, 12, {"xpos": 4, "ypos": 4}), ("NV12", 32, 24, {})],
     None, {"background": 0}, 1),
    ("add-over-full-cover",
     [("NV12", 32, 24, {}),
      ("RGBA", 20, 14, {"xpos": 6, "ypos": 5, "operator": 2})],
     None, {"background": 0}, 1),
    ("negative-position-crop",
     [("BGRA", 32, 24, {"alpha": 0.9}),
      ("RGBA", 24, 18, {"xpos": -7, "ypos": -5, "alpha": 0.6}),
      ("RGBA", 20, 12, {"xpos": 20, "ypos": -3, "operator": 0})],
     None, {"background": 0}, 0),
    ("keep-aspect-ratio",
     [("RGBA", 32, 24, {"width": 96, "height": 36, "sizing-policy": 1})],
     None, {"background": 1}, 1),
    ("zero-size-is-unscaled-false",
     [("RGBA", 32, 24, {"alpha": 0.7}), ("RGBA", 16, 12, {"width": 0})],
     None, {"background": 1, "zero-size-is-unscaled": False}, 0),
    ("zero-size-is-unscaled-true",
     [("RGBA", 32, 24, {"alpha": 0.7}),
      ("RGBA", 16, 12, {"width": 0, "xpos": 3})],
     None, {"background": 1}, 0),
    ("odd-pad-37x23-at-x5",
     [("BGRA", 48, 32, {}), ("RGBA", 37, 23, {"xpos": 5, "ypos": 3,
                                              "alpha": 0.65})],
     None, {"background": 0}, 0),
    ("odd-nv12-37x23-at-x5",
     [("BGRA", 48, 32, {}), ("NV12", 37, 23, {"xpos": 5, "ypos": 3,
                                              "alpha": 0.65})],
     None, {"background": 0}, 1),
    ("scaled-nv12-negative",
     [("RGBA", 48, 30, {}),
      ("NV12", 32, 18, {"width": 40, "height": 26, "xpos": -6,
                        "alpha": 0.8})],
     None, {"background": 0}, 1),
    *[(f"yuv-output-{fmt.lower()}",
       [("BGRA", 32, 24, {}), ("NV12", 16, 12, {"xpos": 9, "ypos": 5,
                                                "alpha": 0.6})],
       f"video/x-raw,format={fmt}", {"background": 0}, 1)
      for fmt in ("NV12", "I420")],
    ("config5-shape-64x36",
     [("BGRA", 64, 36, {}),
      ("NV12", 32, 18, {"xpos": 32}),
      ("BGRA", 22, 12, {"ypos": 18, "alpha": 0.7}),
      ("NV12", 22, 12, {"xpos": 32, "ypos": 18, "operator": 2})],
     "video/x-raw,format=BGRA", {"background": 1}, 1),
]


@pytest.mark.parametrize("label,pads,caps,props,tol", CASES,
                         ids=[c[0] for c in CASES])
def test_aggregate_matches_tpuvf(label, pads, caps, props, tol):
    got, want, want_eager, pspec, tspec = run_both(pads, caps, props,
                                                   seed=len(label))
    assert (pspec.format.value, pspec.width, pspec.height, str(pspec.fps),
            str(pspec.par)) == (tspec.format.value, tspec.width,
                                tspec.height, str(tspec.fps), str(tspec.par))
    assert set(got) == set(want) == set(want_eager)
    worst = worst_eager = 0
    for k in want:
        assert got[k].shape == want[k].shape and got[k].dtype == np.uint8
        g = got[k].astype(np.int32)
        worst = max(worst, int(np.abs(g - want[k]).max()))
        worst_eager = max(worst_eager, int(np.abs(g - want_eager[k]).max()))
    print(f"{label}: max {worst_eager} LSB op by op, {worst} LSB compiled")
    assert worst_eager <= tol and worst <= 1  # (module doc)


def test_zorder_swap_changes_the_top_pad():
    """Lower zorder draws first; swapping zorder swaps the layering."""
    def top(z_red, z_blue):
        comp = Compositor(background=1)
        red = torch.zeros((4, 16, 16), dtype=torch.uint8)
        red[0] = red[3] = 255
        blue = torch.zeros((4, 16, 16), dtype=torch.uint8)
        blue[2] = blue[3] = 255
        comp.get_pad("sink_0").set("zorder", z_red)
        comp.get_pad("sink_1").set("zorder", z_blue)
        specs = {n: PSpec(PFormat.RGBA, 16, 16) for n in ("sink_0", "sink_1")}
        out_spec = comp.aggregate_spec(specs, None)
        proc = comp.make_aggregate(specs, out_spec, "cpu")
        out, _ = proc({"sink_0": {"rgba": red}, "sink_1": {"rgba": blue}},
                      (), comp.traced_params())
        return out["rgba"][:, 8, 8].tolist()

    assert top(1, 2) == [0, 0, 255, 255]  # blue on top
    assert top(2, 1) == [255, 0, 0, 255]  # red on top


def test_pad_meta_gates_drawing():
    """'active' 0 (not started) skips a pad; 'eos' 1 keeps the frozen frame
    unless ignore-inactive-pads."""
    def draw_value(meta, ignore):
        comp = Compositor(background=1, **{"ignore-inactive-pads": ignore})
        comp.get_pad("sink_0")
        specs = {"sink_0": PSpec(PFormat.RGBA, 8, 8)}
        proc = comp.make_aggregate(specs, comp.aggregate_spec(specs, None),
                                   "cpu")
        params = dict(comp.traced_params(), __pad_meta__={"sink_0": meta})
        white = torch.full((4, 8, 8), 255, dtype=torch.uint8)
        out, _ = proc({"sink_0": {"rgba": white}}, (), params)
        return int(out["rgba"][0, 4, 4])

    assert draw_value(None, False) == 255
    assert draw_value({"active": 0.0, "eos": 0.0}, False) == 0
    assert draw_value({"active": 1.0, "eos": 1.0}, False) == 255
    assert draw_value({"active": 1.0, "eos": 1.0}, True) == 0
