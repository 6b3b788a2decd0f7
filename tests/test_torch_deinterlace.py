"""vfdeinterlace: the port's `make_process` on the CPU (K5 and the sampler
and emit kernels take their plain versions) against tpuvf's on the same
numpy frames, three frames each so the state carries and frame 0 takes the
first-frame bob fallback.

Tolerances, per case:
- bitwise against tpuvf run op by op (``jax.disable_jit``), where every
  float32 op rounds once as in the port: greedy-H's ``motion < threshold``
  is a knife edge that one ulp moves;
- <= 1 LSB against tpuvf compiled, whose CPU backend may contract
  ``d*d + ...`` into FMAs;
- <= 2 LSB against the numpy oracle of the Metal shaders (tests/oracle).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.oracle import element_ref, metal_ref
from tests.util import random_host_frame
from tpuvf.core.formats import VideoFormat as TFormat
from tpuvf.core.frame import host_to_planes as t_host_to_planes
from tpuvf.core.spec import FrameSpec as TSpec
from tpuvf.elements.deinterlace import Deinterlace as TDeinterlace
from tpuvf_torch.core.formats import VideoFormat as PFormat
from tpuvf_torch.core.frame import host_to_planes, to_device, to_host
from tpuvf_torch.core.spec import FrameSpec as PSpec
from tpuvf_torch.elements.deinterlace import Deinterlace as PDeinterlace
from tpuvf_torch.kernels import deinterlace as kdeint

torch.set_num_threads(1)

METHODS = {"bob": 0, "weave": 1, "linear": 2, "greedyh": 3}


def run_tpuvf(props, fmt, w, h, tff, hosts, eager):
    spec = TSpec(TFormat(fmt), w, h, interlaced=True, tff=tff)
    el = TDeinterlace(**props)
    out_spec = el.transform_spec(spec)
    proc = el.make_process(spec, out_spec, el.static_config(spec, out_spec))
    state, params = el.init_state(spec, out_spec), el.traced_params()
    outs = []
    for host in hosts:
        planes = {k: jnp.asarray(v)
                  for k, v in t_host_to_planes(host, spec).items()}
        if eager:
            with jax.disable_jit():
                out, state = proc(planes, state, params)
        else:
            out, state = proc(planes, state, params)
        outs.append({k: np.asarray(v) for k, v in out.items()})
    return outs


def run_port(props, fmt, w, h, tff, hosts):
    spec = PSpec(PFormat(fmt), w, h, interlaced=True, tff=tff)
    el = PDeinterlace(**props)
    out_spec = el.transform_spec(spec)
    assert not out_spec.interlaced
    proc = el.make_process(spec, out_spec, el.static_config(spec, out_spec),
                           "cpu")
    state, params = el.init_state(spec, out_spec, "cpu"), el.traced_params("cpu")
    outs = []
    for host in hosts:
        out, state = proc(to_device(host_to_planes(host, spec), "cpu"), state,
                          params)
        outs.append(to_host(out))
    return outs


def max_lsb(want, got):
    assert set(want) == set(got)
    worst = 0
    for k in want:
        assert want[k].shape == got[k].shape and got[k].dtype == np.uint8, k
        worst = max(worst, int(np.abs(want[k].astype(np.int32)
                                      - got[k].astype(np.int32)).max()))
    return worst


def hosts_for(fmt, w, h, n=3, seed=0):
    rng = np.random.default_rng(seed)
    spec = TSpec(TFormat(fmt), w, h)
    return [random_host_frame(rng, spec) for _ in range(n)]


CASES = [(m, fmt, tff) for m in METHODS for fmt in ("RGBA", "NV12", "I420")
         for tff in (True, False)]


@pytest.mark.parametrize("method,fmt,tff", CASES,
                         ids=[f"{m}-{f}-{'tff' if t else 'bff'}"
                              for m, f, t in CASES])
def test_matches_tpuvf_op_by_op_bitwise(method, fmt, tff):
    w, h = 16, 12
    props = {"method": METHODS[method], "motion-threshold": 0.3}
    hosts = hosts_for(fmt, w, h, seed=len(method) + (7 if tff else 0))
    want = run_tpuvf(props, fmt, w, h, tff, hosts, eager=True)
    got = run_port(props, fmt, w, h, tff, hosts)
    for i, (wt, g) in enumerate(zip(want, got)):
        assert max_lsb(wt, g) == 0, f"frame {i}"  # bitwise (module doc)


@pytest.mark.parametrize("fmt", ["RGBA", "I420"])
def test_greedyh_odd_height_matches_tpuvf(fmt):
    """An odd height: the last row's row + 1 clamps to itself."""
    w, h = 14, 11
    props = {"method": 3, "motion-threshold": 0.2}
    hosts = hosts_for(fmt, w, h, seed=5)
    want = run_tpuvf(props, fmt, w, h, False, hosts, eager=True)
    got = run_port(props, fmt, w, h, False, hosts)
    for wt, g in zip(want, got):
        assert max_lsb(wt, g) == 0  # bitwise, op by op


@pytest.mark.parametrize("fmt", ["RGBA", "NV12"])
def test_greedyh_matches_tpuvf_compiled(fmt):
    w, h = 16, 12
    props = {"method": 3, "motion-threshold": 0.25}
    hosts = hosts_for(fmt, w, h, seed=9)
    want = run_tpuvf(props, fmt, w, h, True, hosts, eager=False)
    got = run_port(props, fmt, w, h, True, hosts)
    for wt, g in zip(want, got):
        assert max_lsb(wt, g) <= 1  # FMA contraction in XLA (module doc)


def test_greedyh_threshold_tie():
    """Pixels placed so that the motion equals the threshold exactly take
    bob (`motion < threshold` is False); one step less takes prev."""
    w, h = 8, 6
    prev = np.full((h, w, 4), 100, np.uint8)
    cur = prev.copy()
    cur[..., 0] = 200  # motion = |dq(200) - dq(100)| = the threshold
    cur[1::2, : w // 2, 0] = 199  # motion just below it: prev
    cur[0, :, :3] = 30  # the even rows feed a bob value unlike prev
    thr = float(np.float32(np.float32(200) * np.float32(1 / 255))
                - np.float32(np.float32(100) * np.float32(1 / 255)))
    props = {"method": 3, "motion-threshold": thr}
    want = run_tpuvf(props, "RGBA", w, h, True, [prev, cur], eager=True)
    got = run_port(props, "RGBA", w, h, True, [prev, cur])
    assert max_lsb(want[1], got[1]) == 0  # bitwise, op by op
    out = got[1]["rgba"]
    assert (out[:, 1::2, : w // 2] == np.moveaxis(prev, -1, 0)[:, 1::2, : w // 2]
            ).all()  # below the threshold: prev
    assert (out[:, 1::2, w // 2:]
            != np.moveaxis(prev, -1, 0)[:, 1::2, w // 2:]).any()  # tie: bob


@pytest.mark.parametrize("fmt", ["RGBA", "NV12", "I420"])
@pytest.mark.parametrize("method", [1, 3])
def test_matches_oracle(fmt, method):
    """Within 2 LSB of the numpy oracle (tests/test_deinterlace.py's)."""
    w, h = 16, 12
    spec = PSpec(PFormat(fmt), w, h, interlaced=True)
    hosts = hosts_for(fmt, w, h, seed=method)
    got = run_port({"method": method, "motion-threshold": 0.25}, fmt, w, h,
                   True, hosts)
    prev_q = None
    for i, host in enumerate(hosts):
        planes = host_to_planes(host, spec)
        cur_q = metal_ref.quant(metal_ref.sample_rgba(
            planes, fmt, spec.matrix_index, w, h, filt="nearest"))
        cur = metal_ref.dequant(cur_q)
        prev = (metal_ref.dequant(prev_q) if prev_q is not None
                else np.zeros_like(cur))
        out = element_ref.deinterlace(cur, prev, method, True, 0.25,
                                      has_prev=prev_q is not None)
        want = metal_ref.pack_rgba(metal_ref.quant(out).transpose(2, 0, 1),
                                   fmt, spec.matrix_index)
        assert max_lsb(want, got[i]) <= 2, f"frame {i}"  # oracle tolerance
        prev_q = cur_q


def test_bob_linear_carry_no_state():
    spec = PSpec(PFormat.I420, 16, 12, interlaced=True)
    for method, want_state in ((0, False), (2, False), (1, True), (3, True)):
        state = PDeinterlace(method=method).init_state(spec, spec, "cpu")
        assert bool(state) == want_state, method
        if want_state:
            assert state["has_prev"] is False
            assert tuple(state["prev"].shape) == (4, 12, 16)


def test_field_layout_overrides_the_stream_order():
    hosts = hosts_for("RGBA", 16, 12, n=1, seed=3)
    auto = run_port({"method": 0}, "RGBA", 16, 12, True, hosts)[0]["rgba"]
    bff = run_port({"method": 0, "field-layout": 2}, "RGBA", 16, 12, True,
                   hosts)[0]["rgba"]
    inp = np.moveaxis(hosts[0], -1, 0)
    assert np.array_equal(auto[:, 0::2], inp[:, 0::2])
    assert np.array_equal(bff[:, 1::2], inp[:, 1::2])
    assert not np.array_equal(auto, bff)


def test_plain_version_rejects_bad_inputs():
    cur = torch.zeros((4, 6, 8), dtype=torch.uint8)
    thr = torch.tensor(0.1)
    with pytest.raises(ValueError, match="prev"):
        kdeint.deinterlace(cur, None, kdeint.METHOD_WEAVE, True, True, thr)
    with pytest.raises(ValueError, match="method"):
        kdeint.deinterlace(cur, None, 7, True, False, thr)
    with pytest.raises(ValueError, match="threshold"):
        kdeint.deinterlace(cur, None, kdeint.METHOD_BOB, True, False,
                           torch.tensor([0.1]))
    # bob ignores prev; weave without a previous frame is bob
    bob = kdeint.deinterlace(cur + 3, None, kdeint.METHOD_BOB, False, False,
                             thr)
    weave = kdeint.deinterlace(cur + 3, cur, kdeint.METHOD_WEAVE, False,
                               False, thr)
    assert torch.equal(bob, weave)
