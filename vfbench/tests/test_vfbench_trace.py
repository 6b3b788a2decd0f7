"""The trace reduction on synthetic events: device busy as the union of
device intervals inside the window, kernel busy as the union of the
kernels' alone, device time by name, and the idle gaps attributed to the
innermost open host span (frame index stripped); and the reading of a
profiler's raw results."""

from __future__ import annotations

import torch

from vfbench import trace


def ev(name, a, b, kind=trace.HOST):
    return (name, kind, a, b)


def test_busy_ops_and_gaps():
    events = [
        ev("kernel_a", 100, 300, trace.KERNEL),
        ev("kernel_a", 250, 400, trace.KERNEL),  # overlaps: union 100..400
        ev("Memset (Device)", 120, 180, trace.COPY),  # inside kernel_a
        ev("Memcpy HtoD", 600, 700, trace.COPY),
        ev("Memcpy DtoH", 1900, 2100, trace.COPY),  # cut at the window end
        ev("tpuvf_torch.step[17]", 0, 500),
        ev("vfbench.sleep", 400, 600),
        ev("vfbench.sink", 700, 800),
        ev("vfbench.window.open", 0, 5),
    ]
    r = trace.reduce(events, (0, 2000))
    assert r["window_s"] == 2000e-6
    assert abs(r["busy_s"] - (300 + 100 + 100) * 1e-6) < 1e-12
    assert abs(r["kernel_busy_s"] - 300e-6) < 1e-12
    ops = dict(r["device_ops"])
    assert abs(ops["kernel_a"] - 350e-6) < 1e-12
    assert abs(ops["Memcpy DtoH"] - 100e-6) < 1e-12
    gaps = dict(r["idle_gaps"])
    assert abs(gaps["tpuvf_torch.step"] - 100e-6) < 1e-12  # 0..100
    assert abs(gaps["vfbench.sleep"] - 200e-6) < 1e-12  # 400..600
    assert abs(gaps["vfbench.sink"] - 100e-6) < 1e-12  # 700..800
    assert abs(gaps["no_span"] - 1100e-6) < 1e-12  # 800..1900
    assert "vfbench.window.open" not in gaps


class _Raw:
    """A raw profiler event as ``kineto_results.events()`` yields it."""

    def __init__(self, name, device, annotation, start_ns, duration_ns):
        self._v = (name, device, annotation, start_ns, duration_ns)

    def name(self):
        return self._v[0]

    def device_type(self):
        return getattr(torch.autograd.DeviceType, self._v[1])

    def is_user_annotation(self):
        return self._v[2]

    def start_ns(self):
        return self._v[3]

    def duration_ns(self):
        return self._v[4]


def test_raw_events_kinds():
    raw = [_Raw("vfbench.window.open", "CPU", True, 1000, 10),
           _Raw("emit_u8", "CUDA", False, 2000, 500),
           _Raw("Memcpy DtoH (Device -> Pinned)", "CUDA", False, 3000, 700),
           _Raw("Memset (Device)", "CUDA", False, 4000, 50),
           _Raw("vfbench.sink", "CUDA", True, 1500, 4000),
           _Raw("tpuvf_torch.batch[8]", "CUDA", False, 1500, 4000),
           _Raw("vfbench.window.close", "CPU", True, 9000, 10)]
    evs = trace.events(type("R", (), {"events": lambda self: raw})())
    kinds = {name: kind for name, kind, _, _ in evs}
    assert kinds == {"vfbench.window.open": trace.HOST,
                     "emit_u8": trace.KERNEL,
                     "Memcpy DtoH (Device -> Pinned)": trace.COPY,
                     "Memset (Device)": trace.COPY,
                     "vfbench.window.close": trace.HOST}
    assert trace.window_of(evs) == (1.0, 9.0)
    r = trace.reduce(evs, trace.window_of(evs))
    assert abs(r["busy_s"] - 1.25e-6) < 1e-15
    assert abs(r["kernel_busy_s"] - 0.5e-6) < 1e-15


def test_events_of_a_profiled_window():
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with torch.profiler.record_function("vfbench.window.open"):
            pass
        with torch.profiler.record_function("tpuvf_torch.step[3]"):
            torch.ones(8).add_(1)
        with torch.profiler.record_function("vfbench.window.close"):
            pass
    evs = trace.events(prof.profiler.kineto_results)
    assert {k for _, k, _, _ in evs} == {trace.HOST}
    w0, w1 = trace.window_of(evs)
    step = next(e for e in evs if e[0] == "tpuvf_torch.step[3]")
    assert w0 <= step[2] <= step[3] <= w1
    r = trace.reduce(evs, (w0, w1))
    assert r["busy_s"] == r["kernel_busy_s"] == 0
    assert dict(r["idle_gaps"])["tpuvf_torch.step"] > 0
