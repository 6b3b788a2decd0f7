"""vftransform: the port's `make_process` on the CPU (the K1/K1b sampler and
the emit K2 take their plain versions) against tpuvf's, on the same numpy
frames, run as tpuvf's own tests run it (``make_process`` called outside
jit).

Tolerances, per case:
- <= 1 LSB against tpuvf: tpuvf contracts the same 2-tap sampling matrices
  through blockband or dense matmuls at HIGHEST precision, each within 1 ulp
  of the port's w0*a + w1*b, so a knife-edge pixel may flip by one after
  quantization (as for vfconvertscale);
- bitwise on the fast path (flips, 180°, square 90°/diagonals): both sides
  sample at identity and move whole pixels;
- <= 2 LSB against the numpy oracle of the Metal shaders (tests/oracle).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.oracle import element_ref, metal_ref
from tests.util import random_host_frame
from tpuvf.core.formats import VideoFormat as TFormat
from tpuvf.core.frame import host_to_planes as t_host_to_planes
from tpuvf.core.spec import FrameSpec as TSpec
from tpuvf.elements.transform import Transform as TTransform
from tpuvf_torch.core.formats import VideoFormat as PFormat
from tpuvf_torch.core.frame import host_to_planes, to_device, to_host
from tpuvf_torch.core.spec import FrameSpec as PSpec
from tpuvf_torch.elements.transform import Transform as PTransform
from tpuvf_torch.elements.transform import _fast_layout_op

torch.set_num_threads(1)


def run_both(props, fmt, w, h, seed=0):
    """-> (tpuvf planes, port planes, the input's canonical planes)."""
    rng = np.random.default_rng(seed)
    tspec, pspec = TSpec(TFormat(fmt), w, h), PSpec(PFormat(fmt), w, h)
    host = random_host_frame(rng, tspec)
    tel, pel = TTransform(**props), PTransform(**props)
    assert not pel.is_passthrough(pspec, pspec)
    tproc = tel.make_process(tspec, tspec, tel.static_config(tspec, tspec))
    tout, _ = tproc({k: jnp.asarray(v) for k, v in
                     t_host_to_planes(host, tspec).items()},
                    tel.init_state(tspec, tspec), tel.traced_params())
    pproc = pel.make_process(pspec, pspec, pel.static_config(pspec, pspec),
                             "cpu")
    planes = host_to_planes(host, pspec)
    pout, _ = pproc(to_device(planes, "cpu"), (), pel.traced_params("cpu"))
    return ({k: np.asarray(v) for k, v in tout.items()}, to_host(pout),
            planes)


def max_lsb(want, got):
    assert set(want) == set(got)
    worst = 0
    for k in want:
        assert want[k].shape == got[k].shape and got[k].dtype == np.uint8, k
        worst = max(worst, int(np.abs(want[k].astype(np.int32)
                                      - got[k].astype(np.int32)).max()))
    return worst


CASES = [(m, fmt, size) for m in range(1, 8) for fmt in ("RGBA", "NV12", "I420")
         for size in ((16, 16), (24, 14))]


@pytest.mark.parametrize("method,fmt,size", CASES,
                         ids=[f"m{m}-{f}-{s[0]}x{s[1]}" for m, f, s in CASES])
def test_methods_match_tpuvf(method, fmt, size):
    w, h = size
    want, got, _ = run_both({"method": method}, fmt, w, h, seed=method)
    fast = _fast_layout_op(method, w, h) is not None
    # bitwise on the fast path; <= 1 LSB on the sampled one (module doc)
    assert max_lsb(want, got) <= (0 if fast else 1)


CROP_CASES = [
    # tpuvf's golden crops (tests/test_transform_overlay.py) on methods 0-2
    *[(m, crops, "RGBA", 24, 16) for m in (0, 1, 2)
      for crops in ((4, 0, 0, 0), (4, 6, 2, 8))],
    # config 2's crop and its anti-diagonal cousins on YUV
    (1, (6, 0, 3, 0), "NV12", 24, 16),
    (3, (0, 5, 0, 0), "NV12", 24, 16),
    (7, (2, 3, 1, 4), "I420", 24, 16),
    # I420 with odd sizes: the chroma is (w + 1) // 2
    (1, (3, 0, 2, 0), "I420", 23, 17),
    (5, (0, 0, 0, 3), "I420", 23, 17),
    # crops larger than the frame: every texcoord leaves [0, 1]
    (0, (30, 0, 0, 0), "RGBA", 24, 16),
    (1, (10, 20, 0, 0), "NV12", 24, 16),
]


@pytest.mark.parametrize("method,crops,fmt,w,h", CROP_CASES)
def test_crops_match_tpuvf(method, crops, fmt, w, h):
    cl, cr, ct, cb = crops
    props = {"method": method, "crop-left": cl, "crop-right": cr,
             "crop-top": ct, "crop-bottom": cb}
    want, got, _ = run_both(props, fmt, w, h, seed=sum(crops))
    assert max_lsb(want, got) <= 1  # sampling re-expressions (module doc)


@pytest.mark.parametrize("method,crops,fmt", [
    (1, (4, 0, 2, 0), "NV12"), (3, (0, 6, 0, 0), "RGBA"),
    (2, (4, 6, 2, 8), "I420"), (6, (0, 0, 0, 0), "NV12")])
def test_matches_oracle(method, crops, fmt):
    w, h = 24, 16
    cl, cr, ct, cb = crops
    props = {"method": method, "crop-left": cl, "crop-right": cr,
             "crop-top": ct, "crop-bottom": cb}
    _, got, planes = run_both(props, fmt, w, h, seed=3)
    spec = PSpec(PFormat(fmt), w, h)
    rgba_q = element_ref.transform(planes, fmt, spec.matrix_index, w, h,
                                   method, cl, cr, ct, cb)
    want = metal_ref.pack_rgba(rgba_q, fmt, spec.matrix_index)
    assert max_lsb(want, got) <= 2  # oracle tolerance


def test_passthrough():
    spec = PSpec(PFormat.NV12, 24, 16)
    assert PTransform().is_passthrough(spec, spec)
    assert not PTransform(method=0, crop_top=1).is_passthrough(spec, spec)
    assert not PTransform(method=2).is_passthrough(spec, spec)


def test_square_clockwise_moves_pixels():
    """The fast path's 90° clockwise: out(r, c) = in(N-1-c, r)."""
    host = np.random.default_rng(1).integers(0, 256, (8, 8, 4), np.uint8)
    spec = PSpec(PFormat.RGBA, 8, 8)
    el = PTransform(method=1)
    out, _ = el.make_process(spec, spec, el.static_config(spec, spec), "cpu")(
        to_device(host_to_planes(host, spec), "cpu"), (), {})
    got = out["rgba"].numpy()
    want = np.moveaxis(host, -1, 0)
    for r in range(8):
        for c in range(8):
            assert np.array_equal(got[:, r, c], want[:, 7 - c, r])
