"""The frame edge's spans (`runtime/observability.py` `trace`) on the CPU.

Each part of the run loops' host edge is one span, ``tpuvf_torch.<part>``,
with no index in its name: its host-clock seconds add to
`PipelineStats.edge_seconds[<part>]`, and only while a torch profiler is
active is it also a ``record_function`` range, the frame or batch index in
its ``args``.  Here `run`, `run_batched` and a dp=2 `run_batched` on a CPU
mesh run under torch.profiler (CPU activity): every span of the table
appears but ``params.tables`` (the chain has no compositor, so its
`edge_seconds` stay 0; ``tests/test_torch_comp4k.py`` drives a compositor),
the ``upload.*`` parts inside ``tpuvf_torch.upload`` and ``params.select``
inside ``tpuvf_torch.params``, each name's profiler time beside its
`edge_seconds` delta; with no profiler no ``record_function`` is entered.
The four benchmark readers that read the spans (``vfbench/metrics``) run on
a made-up context.
"""

import logging
import re
from pathlib import Path
from types import SimpleNamespace

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from tpuvf_torch.cli.launch import parse_pipeline
from tpuvf_torch.parallel.mesh import make_mesh
from tpuvf_torch.runtime import observability
from tpuvf_torch.runtime.observability import EDGE_PARTS, trace
from vfbench import spec

torch.set_num_threads(1)

DESC = ("videotestsrc num-buffers=8 pattern=ball ! "
        "video/x-raw,format=NV12,width=40,height=24 ! vfmetalconvertscale ! "
        "video/x-raw,format=BGRA,width=40,height=24 ! "
        "vfmetalvideofilter brightness=0.1 contrast=1.1 ! fakesink")
PREFIX = "tpuvf_torch."
TABLES = PREFIX + "params.tables"  # a compositor's: none in DESC
SPANS = tuple(PREFIX + k for k in EDGE_PARTS
              if k != "step" and PREFIX + k != TABLES)
UPLOAD_PARTS = tuple(s for s in SPANS if s.startswith(PREFIX + "upload."))
PARAMS_PARTS = (PREFIX + "params.select",)
LOOPS = ("run", "run_batched", "mesh")


def _drive(loop: str):
    """-> (a fresh pipeline, its call of `loop` over 8 frames)."""
    pipe = parse_pipeline(DESC, device="cpu")
    if loop == "run":
        return pipe, lambda: pipe.run(8)
    if loop == "run_batched":
        return pipe, lambda: pipe.run_batched(8, batch_size=4)
    mesh = make_mesh({"dp": 2}, devices=["cpu"] * 2)
    return pipe, lambda: pipe.run_batched(8, batch_size=4, mesh=mesh)


class _Recorder:
    """Stands in for ``torch.profiler.record_function``: notes each
    range's (name, args) and opens the real one."""

    def __init__(self, real):
        self.real, self.calls = real, []

    def __call__(self, name, args=None):
        self.calls.append((name, args))
        return self.real(name, args)


def _traced(loop: str, monkeypatch):
    """Run `loop` once to warm up, then again under torch.profiler ->
    (spans [(name, start_s, end_s)], record_function calls, the second
    run's edge_seconds deltas)."""
    pipe, go = _drive(loop)
    go()
    rec = _Recorder(torch.profiler.record_function)
    monkeypatch.setattr(torch.profiler, "record_function", rec)
    before = dict(pipe.stats.edge_seconds)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        assert go() == 8
    edge = {k: v - before[k] for k, v in pipe.stats.edge_seconds.items()}
    spans = []
    for e in prof.profiler.kineto_results.events():
        if e.name().startswith(PREFIX):
            a = e.start_ns() * 1e-9
            spans.append((e.name(), a, a + e.duration_ns() * 1e-9))
    return spans, rec.calls, edge


@pytest.mark.parametrize("loop", LOOPS)
def test_every_span_appears_unindexed_and_nested(loop, monkeypatch):
    spans, calls, _ = _traced(loop, monkeypatch)
    assert {name for name, _, _ in spans} == set(SPANS)
    assert {name for name, _ in calls} == set(SPANS)
    for parts, outer in ((UPLOAD_PARTS, "upload"), (PARAMS_PARTS, "params")):
        outers = [(a, b) for name, a, b in spans if name == PREFIX + outer]
        for name, a, b in spans:
            if name in parts:
                assert any(oa <= a and b <= ob for oa, ob in outers), name


@pytest.mark.parametrize("loop", LOOPS)
def test_the_index_rides_in_args(loop, monkeypatch):
    _, calls, _ = _traced(loop, monkeypatch)
    args = {}
    for name, arg in calls:
        assert arg is not None, name
        args.setdefault(name[len(PREFIX):], set()).add(arg)
    frames = {str(i) for i in range(8)}
    for part in ("wait", "consume", "params.select"):
        assert args[part] == frames
    if loop == "run":
        assert args["enqueue"] == args["params"] == args["readback"] == frames
        return
    assert args["params"] == args["upload"] == args["upload.fill"] == {
        "0", "4"}
    want = {"0", "4"} if loop == "run_batched" else {
        "(0, 0)", "(0, 1)", "(4, 0)", "(4, 1)"}  # (batch, shard)
    assert args["enqueue"] == args["readback"] == want


@pytest.mark.parametrize("loop", LOOPS)
def test_edge_seconds_are_the_spans_durations(loop, monkeypatch):
    spans, _, edge = _traced(loop, monkeypatch)
    assert set(edge) == set(EDGE_PARTS)
    for name in SPANS:
        prof_s = sum(b - a for n, a, b in spans if n == name)
        got = edge[name[len(PREFIX):]]
        assert got > 0, name
        # the clock is read inside the profiler's range, so the range is
        # the longer; loosely, as the two clocks are different ones
        assert got == pytest.approx(prof_s, rel=0.5, abs=5e-3), name
    assert edge["step"] == pytest.approx(edge["params"] + edge["enqueue"],
                                         rel=1e-9)
    assert edge["upload"] >= sum(edge[p[len(PREFIX):]] for p in UPLOAD_PARTS)
    assert edge["params"] >= edge["params.select"]
    assert edge["params.tables"] == 0


@pytest.mark.parametrize("loop", LOOPS)
def test_no_record_function_without_a_profiler(loop, monkeypatch):
    pipe, go = _drive(loop)
    calls = []

    def counting(name, args=None):
        calls.append(name)
        return torch.autograd.profiler.record_function(name, args)

    monkeypatch.setattr(torch.profiler, "record_function", counting)
    assert go() == 8
    assert calls == []
    edge = pipe.stats.edge_seconds
    assert set(edge) == set(EDGE_PARTS)
    assert all(edge[k] > 0 for k in EDGE_PARTS if k != "params.tables")
    assert edge["params.tables"] == 0
    assert edge["step"] == pytest.approx(edge["params"] + edge["enqueue"],
                                         rel=1e-9)


def test_no_span_name_in_the_port_carries_an_index():
    root = Path(observability.__file__).resolve().parents[1]
    formatted = re.compile(r"""trace\(\s*f["']""")
    for path in root.rglob("*.py"):
        assert not formatted.search(path.read_text()), path


def test_span_without_edge_logs_at_debug(caplog):
    edge = dict.fromkeys(EDGE_PARTS, 0.0)
    with caplog.at_level(logging.DEBUG, logger="tpuvf_torch.perf"):
        with trace("tpuvf_torch.enqueue", edge, 3):
            pass
        with trace("tpuvf_torch.other"):
            pass
    assert [r.getMessage().split(":")[0] for r in caplog.records] == [
        "tpuvf_torch.enqueue", "tpuvf_torch.other"]
    assert edge["enqueue"] > 0 and edge["step"] == edge["enqueue"]
    assert sum(v > 0 for v in edge.values()) == 2


def test_profiler_trace_writes_the_spans(tmp_path):
    pipe, go = _drive("run_batched")
    path = tmp_path / "trace.json"
    with observability.profiler_trace(str(path)):
        go()
    text = path.read_text()
    assert '"tpuvf_torch.upload"' in text
    assert '"tpuvf_torch.enqueue"' in text
    with pytest.raises(FileNotFoundError, match="no directory"):
        with observability.profiler_trace(str(tmp_path / "no" / "t.json")):
            pass


def _ctx(frames=8, edge=None, gaps=None, window_s=2.0):
    edge = dict.fromkeys(EDGE_PARTS, 0.0) if edge is None else edge
    trace_ = None if gaps is None else {
        "window_s": window_s, "busy_s": window_s / 2, "idle_gaps": gaps}
    return SimpleNamespace(frames=frames, edge=edge, trace=trace_)


GAPS = [["no_span", 0.02], ["tpuvf_torch.upload.fill", 0.5],
        ["tpuvf_torch.upload", 0.1], ["tpuvf_torch.upload.alloc", 0.2],
        ["tpuvf_torch.wait", 0.04], ["vfbench.sink", 0.06],
        ["tpuvf_torch.consume", 0.08], ["tpuvf_torch.readback", 0.02],
        ["tpuvf_torch.enqueue", 0.3]]


@pytest.mark.parametrize("metric,part", [("upload_fill_ms.batch", "upload.fill"),
                                         ("upload_alloc_ms.batch",
                                          "upload.alloc")])
def test_span_readers(metric, part):
    read = spec.load_reader(metric).read
    edge = dict.fromkeys(EDGE_PARTS, 0.0)
    edge[part] = 0.004
    assert read(_ctx(edge=edge)) == pytest.approx(0.5)  # ms a frame
    assert read(_ctx(frames=0, edge=edge)) is None
    # a program without the span (the parent of the spans) reads nothing
    assert read(_ctx(edge={"upload": 0.1, "step": 0.1})) is None


@pytest.mark.parametrize("metric,want", [("idle_upload_pct.batch", 40.0),
                                         ("idle_deliver_pct.batch", 10.0)])
def test_idle_readers(metric, want):
    read = spec.load_reader(metric).read
    assert read(_ctx(gaps=GAPS)) == pytest.approx(want)
    assert read(_ctx(gaps=[])) == 0.0
    assert read(_ctx()) is None  # no trace
    assert read(_ctx(frames=0, gaps=GAPS)) is None
    assert read(_ctx(gaps=GAPS, window_s=0.0)) is None
    old = {k: 0.0 for k in ("upload", "step", "readback", "wait", "consume")}
    assert read(_ctx(edge=old, gaps=GAPS)) is None
