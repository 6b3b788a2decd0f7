"""The reduction of a torch.profiler trace of the measured window.

- ``busy_s``: the union of the intervals in which a kernel, a copy or a
  memset ran on the device;
- ``kernel_busy_s``: the union of the intervals in which a kernel ran on
  the device (copies and memsets left out);
- ``device_ops``: device time by operation name, the ten largest;
- ``idle_gaps``: the device's idle time inside the window, attributed to
  the innermost host span open at each instant (the harness's ``vfbench.*``
  spans and the program's ``tpuvf_torch.*`` spans, a ``[i]`` frame index
  stripped), or ``no_span``; the ten largest.

Events are ``(name, kind, start_us, end_us)``, ``kind`` one of ``KERNEL``,
``COPY`` or ``HOST``; ``events`` reads them from the profiler's raw results,
which spares the minutes that building its ``events()`` tree takes over a
window of some ten thousand frames.
"""

from __future__ import annotations

import re

_INDEX = re.compile(r"\[\d+\]$")
NAME_CHARS = 96  # a device operation's name as kept in the breakdown
SPAN_PREFIXES = ("vfbench.", "tpuvf_torch.")
WINDOW_MARK = "vfbench.window."  # the window's open and close marks
KERNEL, COPY, HOST = "kernel", "copy", "host"


def _kind(e):
    """KERNEL, COPY or HOST, or None for a device event that is neither a
    kernel nor a copy (a host span's shadow on the device)."""
    if getattr(e.device_type(), "name", "") != "CUDA":
        return HOST
    name = e.name()
    if e.is_user_annotation() or name.startswith(SPAN_PREFIXES):
        return None
    return COPY if name.startswith(("Memcpy", "Memset")) else KERNEL


def events(results):
    """(name, kind, start_us, end_us) of each event of a profiler's raw
    results (``profile().profiler.kineto_results``)."""
    out = []
    for e in results.events():
        kind = _kind(e)
        if kind is not None:
            a = e.start_ns() * 1e-3
            out.append((e.name(), kind, a, a + e.duration_ns() * 1e-3))
    return out


def _union(intervals):
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def _length_s(intervals) -> float:
    return sum(b - a for a, b in intervals) * 1e-6


def span_name(name: str) -> str:
    return _INDEX.sub("", name)


def window_of(evs) -> tuple:
    """(start, end) of the window: the starts of its two marks."""
    marks = {n: a for n, k, a, _ in evs if n.startswith(WINDOW_MARK)}
    return marks[WINDOW_MARK + "open"], marks[WINDOW_MARK + "close"]


def reduce(evs, window: tuple) -> dict:
    """`evs`: (name, kind, start_us, end_us); `window`: (start, end) of
    the measured window in the same microseconds.  Times in seconds."""
    w0, w1 = window
    device, kernels, spans, by_name = [], [], [], {}
    for name, kind, a, b in evs:
        if kind != HOST:
            a, b = max(a, w0), min(b, w1)
            if b > a:
                device.append((a, b))
                if kind == KERNEL:
                    kernels.append((a, b))
                key = name[:NAME_CHARS]
                by_name[key] = by_name.get(key, 0.0) + (b - a) * 1e-6
        elif (name.startswith(SPAN_PREFIXES)
              and not name.startswith(WINDOW_MARK)):
            spans.append((a, b, span_name(name)))
    busy = _union(device)
    gaps, t = [], w0
    for a, b in busy:
        if a > t:
            gaps.append((t, a))
        t = max(t, b)
    if t < w1:
        gaps.append((t, w1))
    return {
        "busy_s": _length_s(busy),
        "kernel_busy_s": _length_s(_union(kernels)),
        "window_s": (w1 - w0) * 1e-6,
        "device_ops": top(by_name),
        "idle_gaps": top(attribute(gaps, spans)),
    }


def attribute(gaps, spans) -> dict:
    """Seconds of each gap under the innermost (latest begun) open span."""
    marks = []
    for i, (a, b, _) in enumerate(spans):
        marks.append((a, 1, i))
        marks.append((b, 0, i))
    for a, b in gaps:
        marks.append((a, 2, -1))
        marks.append((b, -1, -1))
    marks.sort()
    open_spans, out, in_gap, last = {}, {}, False, None
    for t, kind, i in marks:
        if in_gap and last is not None and t > last:
            name = (spans[max(open_spans, key=open_spans.get)][2]
                    if open_spans else "no_span")
            out[name] = out.get(name, 0.0) + (t - last) * 1e-6
        last = t
        if kind == 1:
            open_spans[i] = spans[i][0]
        elif kind == 0:
            open_spans.pop(i, None)
        elif kind == 2:
            in_gap = True
        else:
            in_gap = False
    return out


def top(d: dict, n: int = 10) -> list:
    return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:n]]
