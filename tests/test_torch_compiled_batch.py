"""One graph a batch (`CompiledStep.step_batch`) on the CPU: `run_batched`
runs a batch's n steps as one body over n sets of fixed buffers, the state
threaded through the frames and written back once.  The card captures that
body as one CUDA graph and replays it (chip_smoke.py phase (o)); here the
body runs eagerly, and `replay_on_cpu` stands in for the graph so that the
key logic (which batch captures, one capture a batch key, a short tail's
own key) and the replay over the fixed buffers run too: its capture runs
the body once and records what it returned, its first replay does nothing
(the capture's run was that frame's), and every later replay runs the body
again over the same fixed buffers and copies the outputs into the recorded
ones, as a graph writes its own buffers.

- The batch path is byte-equal to `run` frame by frame and to the eager
  per-frame loop: a brightness ramp inside one batch (one batch key), a
  ``sink_0::xpos`` ramp (the draw table a row), greedy-H over two calls
  (the state across batches and calls; batch 1 captures), alternating TFF,
  a short tail (its own key), `reset()`.
- The card's two output sets and readback stream, the streams and events
  faked (`streams_on_cpu`) and a capture that runs nothing
  (`two_sets_on_cpu`): a batch key counted once, its two output sets
  taken in turns over odd and even batch counts, a short tail and two
  calls, each set captured at its first use, byte-equal to `run`, each stream handed its waits, records and
  copies in order; `run` and `run_live`, batches of one frame, in the same
  order frame by frame; the mesh path hands the readback stream nothing.
- A fault at a replay raises PipelineError at the batch's first frame, the
  element named by the eager re-run; a capture broken by a stage names it
  at the batch's first frame.
- Against tpuvf's `run_batched` (one ``lax.scan`` a batch) on the same
  seeded frames under TPUVF_NO_SPLIT_LINKS=1: within ROADMAP's contract,
  at most 1 LSB (the b/c/s fold's and greedy-H's knife edges under XLA's
  compile).
"""

import ctypes
from contextlib import contextmanager

import numpy as np
import pytest
import torch

from tests.test_torch_compiled_step import (
    BCS,
    CHAINS,
    _brightness_ramp,
    _xpos_ramp,
    assets,  # noqa: F401 - the fixture
    eager_frames,
    fed,
    i420,
    nv12,
    payload_bytes,
    rgba,
    run_frames,
)
from tests.test_torch_elements import diff_stats
from tpuvf.cli.launch import parse_pipeline as tpuvf_parse
from tpuvf_torch.core.formats import VideoFormat
from tpuvf_torch.core.frame import HostLayout
from tpuvf_torch.core.spec import FrameSpec
from tpuvf_torch.parallel.mesh import make_mesh
from tpuvf_torch.runtime import pipeline as pipeline_module
from tpuvf_torch.runtime.observability import PipelineError

torch.set_num_threads(1)


class CpuGraph:
    """A CUDA graph's contract on the CPU (module doc)."""

    def __init__(self, body, result):
        self.body = body
        self.result = result
        self.first = True

    def replay(self):
        if self.first:
            self.first = False
            return
        new = _tensors(self.body()[0])
        old = _tensors(self.result[0])
        assert len(new) == len(old)
        for mine, theirs in zip(old, new):
            mine.copy_(theirs)


def _tensors(tree) -> list:
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return _tensors(list(tree.values()))
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in _tensors(v)]
    return []


def replay_on_cpu(pipe):
    """`pipe`'s compiled step captures and replays with `CpuGraph`; -> the
    first frame index of each of its captures."""
    cs = pipe.compiled
    cs.graphs = True
    captured = []

    def capture(body, device, index, entry):
        captured.append(index)
        result = body()
        return CpuGraph(body, result), result

    cs._capture = capture
    return captured


def batched(pipe, counts, batch_size, sink="appsink0") -> list:
    """`run_batched` of each count in `counts` -> the sink's frames."""
    for n in counts:
        assert pipe.run_batched(n, batch_size=batch_size) == n
    return [payload_bytes(f) for f in pipe[sink].frames]


# -- the batch path against run() and the eager loop --------------------------

SOME = [c for c in CHAINS if c[0] in ("a", "c-nv12", "e-nv12", "f", "g",
                                      "g-weave", "h-ccw")]


@pytest.mark.parametrize("label,desc,feeds,tffs", SOME,
                         ids=[c[0] for c in SOME])
def test_batches_equal_run_and_the_eager_loop(label, desc, feeds, tffs,
                                              assets):
    """Two calls of 4 frames in batches of 2: batch 0 eager, batch 1
    captured, the second call replayed (the clock restarts, the carried
    state goes on)."""
    desc = desc.format(**assets)
    pipe = fed(desc, feeds, tffs, device="cpu")
    captured = replay_on_cpu(pipe)
    got = batched(pipe, (4, 4), 2)
    ref = fed(desc, feeds, tffs, device="cpu")
    assert got == run_frames(ref, 4) + run_frames(ref, 4)[4:]
    loop = fed(desc, feeds, tffs, device="cpu")
    assert got == eager_frames(loop, 4) + eager_frames(loop, 4)
    cs = pipe.compiled
    assert cs.batch_replays == 4 - cs.eager // 2
    assert cs.batch_captures == len(captured) >= 1
    assert cs.captures == cs.replays == 0  # no frame graph


def test_brightness_ramp_is_one_batch_key():
    pipe, _ = _brightness_ramp()
    captured = replay_on_cpu(pipe)
    got = batched(pipe, (16,), 8)
    ref, _ = _brightness_ramp()
    assert got == run_frames(ref, 16)
    cs = pipe.compiled
    assert captured == [8] and cs.batch_replays == 1 and cs.eager == 8
    assert cs.keys == 1 and len(cs._batches) == 1
    means = [np.frombuffer(f, np.uint8).reshape(24, 32, 4)[..., :3].mean()
             for f in got]
    assert all(b > a for a, b in zip(means, means[1:]))
    # the ramp goes on through the replays: a second call equals run()'s
    assert batched(pipe, (16,), 8)[16:] == run_frames(ref, 16)[16:]
    assert cs.batch_captures == 1 and cs.batch_replays == 3


def test_xpos_ramp_reads_its_table_row():
    pipe = _xpos_ramp()
    replay_on_cpu(pipe)
    got = batched(pipe, (16,), 8)
    assert got == run_frames(_xpos_ramp(), 16)
    assert got == eager_frames(_xpos_ramp(), 16)
    assert pipe.compiled.batch_captures == 1
    assert len(set(got)) > 8


GREEDY = ("appsrc format=I420 width=64 height=36 ! video/x-raw,"
          "interlace-mode=interleaved ! vfmetaldeinterlace method=greedyh "
          "motion-threshold=0.3 ! appsink")


def test_greedyh_two_calls_which_batch_captures():
    """16 frames in batches of 8: batch 0 carries has_prev False on frame
    0, so its key is not batch 1's; batch 0 runs eagerly, batch 1 (every
    frame key known by then) captures.  The second call replays both."""
    feeds = {"appsrc0": i420(16, 64, 36, 30)}
    pipe = fed(GREEDY, feeds, device="cpu")
    captured = replay_on_cpu(pipe)
    got = batched(pipe, (16, 16), 8)
    ref = fed(GREEDY, feeds, device="cpu")
    assert got == run_frames(ref, 16) + run_frames(ref, 16)[16:]
    cs = pipe.compiled
    assert captured == [8]  # batch 1 of the first call
    assert (cs.batch_captures, cs.batch_replays, cs.eager) == (1, 3, 8)
    assert cs.keys == 2  # has_prev False, then True
    prev = pipe.state["vfmetaldeinterlace0"]["prev"]
    assert torch.equal(prev, ref.state["vfmetaldeinterlace0"]["prev"])


def test_alternating_tff_replays_one_batch_key():
    """Weave with the TFF flag alternating, three calls of 4 in batches of
    2: the first call's two batches run eagerly (weave's first frame, then
    the first TFF=1 frame with a previous frame are new keys); from the
    second call every batch is (TFF 1, TFF 0) with a previous frame, one
    key, captured at its first batch."""
    _, desc, feeds, tffs = next(c for c in CHAINS if c[0] == "g-weave")
    pipe = fed(desc, feeds, tffs, device="cpu")
    captured = replay_on_cpu(pipe)
    got = batched(pipe, (4, 4, 4), 2)
    ref = fed(desc, feeds, tffs, device="cpu")
    for _ in range(3):
        want = run_frames(ref, 4)
    assert got == want
    cs = pipe.compiled
    assert captured == [0] and cs.batch_captures == 1
    assert (cs.eager, cs.batch_replays) == (4, 4)


def test_short_tail_takes_its_own_key():
    """6 frames in batches of 4: the tail of 2 is a batch key of its own,
    captured once its frame keys are known (tpuvf re-traces a shorter
    tail)."""
    _, desc, feeds, _ = next(c for c in CHAINS if c[0] == "a")
    feeds = {"appsrc0": nv12(6, 64, 48, 31)}
    pipe = fed(desc, feeds, device="cpu")
    captured = replay_on_cpu(pipe)
    got = batched(pipe, (6, 6), 4)
    ref = fed(desc, feeds, device="cpu")
    assert got == run_frames(ref, 6) + run_frames(ref, 6)[6:]
    cs = pipe.compiled
    assert captured == [4, 0]  # the tail in call 1, batch 0 in call 2
    assert sorted(k[1] for k in cs._batches) == [2, 4]
    assert cs.batch_replays == 3 and cs.eager == 4


def test_reset_starts_fresh():
    feeds = {"appsrc0": i420(8, 64, 36, 32)}
    pipe = fed(GREEDY, feeds, device="cpu")
    replay_on_cpu(pipe)
    batched(pipe, (8,), 4)
    old = pipe.compiled
    pipe.reset()
    pipe["appsink0"].frames.clear()
    assert pipe.compiled is not old
    replay_on_cpu(pipe)
    got = batched(pipe, (8,), 4)
    assert got == run_frames(fed(GREEDY, feeds, device="cpu"), 8)


def test_the_state_is_not_an_input_row():
    """vfdeinterlace holds an RGB input's planes as its texture: inside a
    batch frame j+1 reads frame j's; after the batch the fixed state holds
    a copy, not a view of an input row."""
    _, desc, feeds, tffs = next(c for c in CHAINS if c[0] == "g-weave")
    pipe = fed(desc, feeds, tffs, device="cpu")
    batched(pipe, (4,), 4)
    prev = pipe.state["vfmetaldeinterlace0"]["prev"]
    rows = pipe.compiled.batch_inputs(4)["appsrc0"]
    lo, hi = rows.data_ptr(), rows.data_ptr() + rows.numel()
    assert not lo <= prev.data_ptr() < hi
    want = torch.from_numpy(feeds["appsrc0"][3][..., [2, 1, 0, 3]])
    assert torch.equal(prev, want.permute(2, 0, 1))


def test_a_row_that_holds_its_buffer_is_not_uploaded_again():
    """`run_batched(batch_size=1)` over a compositor whose second source
    runs at half the output rate: each source's one row holds its buffer
    from batch to batch, so every buffer is generated and uploaded once (8
    of the 60 fps source, 4 of the 30 fps one, which two frames each
    pick), and the frames equal the eager loop's, which uploads every
    frame anew, and `run`'s."""
    desc = ("vfmetalcompositor name=c sink_1::xpos=8 ! video/x-raw,"
            "format=BGRA,width=32,height=24 ! appsink "
            "appsrc name=s0 format=NV12 width=32 height=24 ! "
            "video/x-raw,framerate=60/1 ! c.sink_0 "
            "appsrc name=s1 format=BGRA width=16 height=12 ! "
            "video/x-raw,framerate=30/1 ! c.sink_1")
    feeds = {"s0": nv12(8, 32, 24, 70), "s1": rgba(4, 16, 12, 71)}
    pipe = fed(desc, feeds, device="cpu")
    generated = []
    for name in feeds:
        src = pipe[name]

        def generate(j, spec, name=name, real=src.generate):
            generated.append((name, j))
            return real(j, spec)

        src.generate = generate
    got = batched(pipe, (8,), 1)
    assert sorted(generated) == ([("s0", j) for j in range(8)]
                                 + [("s1", j) for j in range(4)])
    assert (pipe.stats.upload_direct, pipe.stats.upload_filled) == (0, 12)
    assert len(set(got)) == 8
    assert got == eager_frames(fed(desc, feeds, device="cpu"), 8)
    assert got == run_frames(fed(desc, feeds, device="cpu"), 8)


# -- two output sets, read back on a stream of their own -----------------------


class FakeStream:
    """A stream or an event of the card, each call logged in order; an
    event's host waits counted (`synced`)."""

    def __init__(self, name, log):
        self.name, self.log = name, log
        self.synced = 0

    def wait_event(self, event):
        self.log.append((self.name, "wait", event.name))

    def record(self, stream):
        self.log.append((stream.name, "record", self.name))

    def synchronize(self):
        self.synced += 1


class StreamLog(list):
    """What `streams_on_cpu` logs, with the delivery events made
    (`events`, ``torch.cuda.Event``'s, named done0, done1, ...)."""

    def __init__(self):
        super().__init__()
        self.events = []


def streams_on_cpu(monkeypatch, pipe) -> StreamLog:
    """`pipe`'s compiled step with the readback stream and its events of
    the card (module doc of ``runtime/compiled.py``) faked on the CPU,
    ``torch.cuda``'s current stream and new events with them, and the raw
    copies of a batch's readback (``core/frame.py`` `copy_d2h`) done by
    torch on the CPU; -> the log of what each stream is handed, the
    per-frame readback's copies (``HostLayout.readback``), a raw call's
    count of pieces and ``record_stream`` included."""
    log = StreamLog()
    cs = pipe.compiled
    current = [FakeStream("compute", log)]
    cs._readback = FakeStream("readback", log)
    cs._step_done = FakeStream("step_done", log)
    cs._outputs_free = (FakeStream("free0", log), FakeStream("free1", log))

    @contextmanager
    def stream(s):
        current.append(s)
        try:
            yield
        finally:
            current.pop()

    real = HostLayout.readback

    def readback(self, pieces, flat):
        log.append((current[-1].name, "copy"))
        return real(self, pieces, flat)

    def event():
        log.events.append(FakeStream(f"done{len(log.events)}", log))
        return log.events[-1]

    def copy_d2h(copies, s):
        log.append((s.name, "raw", len(copies)))
        for view, piece in copies:
            assert piece.is_contiguous() and view.is_contiguous()
            view.copy_(piece)

    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: current[-1])
    monkeypatch.setattr(torch.cuda, "stream", stream)
    monkeypatch.setattr(torch.cuda, "Event", event)
    monkeypatch.setattr(torch.Tensor, "record_stream",
                        lambda t, s: log.append((s.name, "record_stream")))
    monkeypatch.setattr(HostLayout, "readback", readback)
    monkeypatch.setattr(pipeline_module, "copy_d2h", copy_d2h)
    return log


def two_sets_on_cpu(pipe) -> list:
    """`pipe`'s compiled step captures as a CUDA graph does, running
    nothing (the body runs, then the state is put back); each replay runs
    the body and writes the graph's own outputs.  -> the first frame index
    of each capture."""
    cs = pipe.compiled
    cs.graphs = True
    captured = []

    def capture(body, device, index, entry):
        captured.append(index)
        fixed = _tensors(cs._state.fixed)
        held = [t.clone() for t in fixed]
        result = body()
        for t, h in zip(fixed, held):
            t.copy_(h)
        graph = CpuGraph(body, result)
        graph.first = False
        return graph, result

    cs._capture = capture
    return captured


def batches_of(log) -> list:
    """The log cut at each batch's first entry, the compute stream's wait
    on the output set it is to write."""
    cuts = [k for k, e in enumerate(log) if e[:2] == ("compute", "wait")]
    return [log[a:b] for a, b in zip(cuts, cuts[1:] + [len(log)])]


@pytest.mark.parametrize("frames", [6, 8, 7, 11])  # odd, even, a short tail
def test_two_output_sets_in_turns(frames, monkeypatch):
    """Greedy-H (state through the frames) in batches of 2 over two calls,
    with the card's readback stream and events faked: each batch key's two
    output sets taken in turns from batch to batch and across the calls,
    each captured at its first use (a tail's only set, its one turn in
    each call), byte-equal to `run`; per batch the compute
    stream waits on the set's `_outputs_free`, records `_step_done` after
    the step, and the readback stream waits on it (the eager batch's
    pieces marked as used there), takes the batch's copies by one raw call
    and one delivery event (its frames are far below a chunk), which the
    host waits on once, and records the set's `_outputs_free`."""
    feeds = {"appsrc0": i420(frames, 64, 36, 37)}
    ref = fed(GREEDY, feeds, device="cpu")
    want = run_frames(ref, frames) + run_frames(ref, frames)[frames:]
    pipe = fed(GREEDY, feeds, device="cpu")
    captured = two_sets_on_cpu(pipe)
    log = streams_on_cpu(monkeypatch, pipe)
    assert batched(pipe, (frames, frames), 2) == want
    cs = pipe.compiled
    keys = 1 + frames % 2  # a tail takes a key of its own
    assert cs.batch_captures == keys
    assert captured == [2, 4] + [frames - 1] * (frames % 2)
    assert sorted(len(e.sets) for e in cs._batches.values()) == (
        [1] * (frames % 2) + [2])
    assert cs.eager == 2  # batch 0: has_prev False on its first frame
    assert pipe.stats.readback_async == 2 * frames
    sizes = ([2] * (frames // 2) + [1] * (frames % 2)) * 2
    assert pipe.stats.readback_events == len(sizes)
    assert [e.synced for e in log.events] == [1] * len(sizes)
    assert sum(e.synced for e in cs._outputs_free) == 0
    batches = batches_of(log)
    assert len(batches) == len(sizes)
    for b, (n, got_log) in enumerate(zip(sizes, batches)):
        free = f"free{(b + 1) % 2}"
        # an I420 frame is three pieces
        marks = [("readback", "record_stream")] * 3 * n if b == 0 else []
        assert got_log == ([("compute", "wait", free),
                            ("compute", "record", "step_done"),
                            ("readback", "wait", "step_done")] + marks
                           + [("readback", "raw", 3 * n),
                              ("readback", "record", f"done{b}"),
                              ("readback", "record", free)]), b


@pytest.mark.parametrize("loop", ["run", "run_live"])
def test_the_frame_loops_read_back_on_the_readback_stream(loop, monkeypatch):
    """`run` and `run_live` step batches of one frame through the same
    loop: greedy-H over 8 frames with the readback stream and events faked
    as above, frames 0 and 1 eager (has_prev False, then True), frame 2's
    key's two output sets taken in turns frame by frame, captured at
    frames 2 and 3,
    byte-equal to the eager `run`; each frame hands the streams the order
    of `test_two_output_sets_in_turns` (a raw call of its three pieces and
    an event), and `readback_async` counts every frame."""
    feeds = {"appsrc0": i420(8, 64, 36, 38)}
    want = run_frames(fed(GREEDY, feeds, device="cpu"), 8)
    pipe = fed(GREEDY, feeds, device="cpu")
    captured = two_sets_on_cpu(pipe)
    log = streams_on_cpu(monkeypatch, pipe)
    if loop == "run":
        got = run_frames(pipe, 8)
    else:
        assert pipe.run_live(8, time_fn=lambda: 0.0,
                             sleep_fn=lambda s: None) == 8
        got = [payload_bytes(f) for f in pipe["appsink0"].frames]
    assert got == want
    cs = pipe.compiled
    assert captured == [2, 3] and cs.batch_captures == 1
    assert (cs.eager, cs.batch_replays) == (2, 6)
    assert pipe.stats.readback_async == pipe.stats.readback_events == 8
    assert [e.synced for e in log.events] == [1] * 8
    frames = batches_of(log)
    assert len(frames) == 8
    for b, got_log in enumerate(frames):
        free = f"free{(b + 1) % 2}"
        marks = [("readback", "record_stream")] * 3 if b < 2 else []
        assert got_log == ([("compute", "wait", free),
                            ("compute", "record", "step_done"),
                            ("readback", "wait", "step_done")] + marks
                           + [("readback", "raw", 3),
                              ("readback", "record", f"done{b}"),
                              ("readback", "record", free)]), b


@pytest.mark.parametrize("loop", ["mesh"])
def test_other_loops_read_back_on_the_compute_stream(loop, monkeypatch):
    """With the readback stream faked as above, the mesh path hands it
    nothing: its readbacks stay on the current stream, frame by frame, and
    `readback_async` and `readback_events` stay 0."""
    feeds = {"appsrc0": i420(8, 64, 36, 38)}
    want = run_frames(fed(GREEDY, feeds, device="cpu"), 8)
    pipe = fed(GREEDY, feeds, device="cpu")
    log = streams_on_cpu(monkeypatch, pipe)
    pipe.run_batched(8, batch_size=4,
                     mesh=make_mesh({"dp": 1}, devices=["cpu"]))
    got = [payload_bytes(f) for f in pipe["appsink0"].frames]
    assert got == want
    assert log == [("compute", "copy")] * 8
    assert pipe.stats.readback_async == pipe.stats.readback_events == 0


# greedy-H's I420 64x36 frame: the bytes of its three pieces
FRAME_BYTES = 64 * 36 * 3 // 2


@pytest.mark.parametrize("chunk,groups", [
    (1, [1, 1, 1, 1]),                      # a frame a chunk, as a 4K frame
    (2 * FRAME_BYTES, [2, 2]),
    (2 * FRAME_BYTES + 1, [3, 1]),          # the batch's last frame closes
    (1 << 20, [4]),                         # the whole batch, one event
])
def test_a_batch_shares_an_event_a_chunk(chunk, groups, monkeypatch):
    """Greedy-H over 12 frames in batches of 4 with the streams faked as
    above and `Pipeline.READBACK_CHUNK` at `chunk` bytes: each batch's
    copies go by one raw call and one event a chunk, `groups` its frames a
    chunk, after the marks of the eager batch; the host waits once an
    event, on the chunk's first frame, and the frames equal `run`'s."""
    feeds = {"appsrc0": i420(12, 64, 36, 43)}
    want = run_frames(fed(GREEDY, feeds, device="cpu"), 12)
    pipe = fed(GREEDY, feeds, device="cpu")
    pipe.READBACK_CHUNK = chunk
    two_sets_on_cpu(pipe)
    log = streams_on_cpu(monkeypatch, pipe)
    waited = []
    real = pipeline_module.Pipeline._deliver

    def deliver(self, index, copies, event, retry=None):
        synced = sum(e.synced for e in log.events)
        real(self, index, copies, event, retry)
        waited.append(sum(e.synced for e in log.events) - synced)

    monkeypatch.setattr(pipeline_module.Pipeline, "_deliver", deliver)
    assert batched(pipe, (12,), 4) == want
    assert pipe.stats.readback_events == 3 * len(groups)
    assert [e.synced for e in log.events] == [1] * (3 * len(groups))
    starts = [sum(groups[:k]) for k in range(len(groups))]
    assert waited == [int(j in starts) for j in range(4)] * 3
    for b, got_log in enumerate(batches_of(log)):
        copies = [e for e in got_log if e[1] in ("raw", "record")
                  and not str(e[-1]).startswith("free")
                  and e[0] == "readback"]
        want_log = []
        for k, n in enumerate(groups):
            want_log += [("readback", "raw", 3 * n),
                         ("readback", "record", f"done{b * len(groups) + k}")]
        assert copies == want_log, b


@pytest.mark.parametrize("width,height", [(32, 18), (128, 72)])
def test_a_ring_rebuilt_at_a_new_size_makes_its_slots_anew(
        width, height, monkeypatch):
    """With the streams faked as above: a sink's ring made anew for a
    layout of another size drops the old slots, whose views and payloads
    go with them, and makes the new ones with theirs; the next call makes
    the ring at the sink's own size again and reads back what `run`
    does."""
    feeds = {"appsrc0": i420(8, 64, 36, 39)}
    ref = fed(GREEDY, feeds, device="cpu")
    want = run_frames(ref, 8) + run_frames(ref, 8)[8:]
    pipe = fed(GREEDY, feeds, device="cpu")
    two_sets_on_cpu(pipe)
    streams_on_cpu(monkeypatch, pipe)
    batched(pipe, (8,), 2)
    sink = pipe["appsink0"]
    old = [flat for flat, _, _ in pipe._rings[sink.name][1]]
    assert len(old) == 4 and len(pipe._slots) == 4
    other = HostLayout(FrameSpec(VideoFormat.I420, width, height))
    flat = pipe._ring_buffer(sink, other, 0)
    assert flat.numel() == other.nbytes and all(flat is not f for f in old)
    _, views, payload = pipe._slots[flat.data_ptr()]
    assert payload["y"].shape == (height, width)
    assert [tuple(v.shape) for v in views] == [tuple(s) for s in
                                               other.shapes]
    assert not any(f.data_ptr() in pipe._slots for f in old)
    assert batched(pipe, (8,), 2) == want
    assert len(pipe._slots) == 4
    assert pipe.stats.readback_events == 8


@pytest.mark.parametrize("pieces", ["contiguous", "strided"])
def test_a_strided_piece_is_copied_by_torch(pieces, monkeypatch):
    """With the streams faked as above, a sink whose payload pieces are
    not contiguous (the same bytes, planes stored column by column) is
    read back by torch's copies, no piece handed to the raw call, under
    the same one event a batch, and reads back what `run` does;
    contiguous pieces all go by the raw call."""
    feeds = {"appsrc0": i420(8, 64, 36, 41)}
    want = run_frames(fed(GREEDY, feeds, device="cpu"), 8)
    pipe = fed(GREEDY, feeds, device="cpu")
    two_sets_on_cpu(pipe)
    log = streams_on_cpu(monkeypatch, pipe)
    sink = pipe["appsink0"]
    real = sink.device_payload

    def device_payload(planes, spec):
        layout, got = real(planes, spec)
        return layout, [p.t().contiguous().t() for p in got]

    if pieces == "strided":
        sink.device_payload = device_payload
    assert batched(pipe, (8,), 2) == want
    raw = [e[2] for e in log if e[1] == "raw"]
    assert raw == [0 if pieces == "strided" else 6] * 4
    assert pipe.stats.readback_events == 4


@pytest.mark.parametrize("sink", ["appsink", "fakesink"])
def test_each_ring_slot_keeps_its_payload(sink, monkeypatch):
    """Greedy-H in batches of 2 with the streams faked as above: each of a
    sink's 4 ring slots keeps torch and numpy views of its host buffer,
    made with the slot, the numpy ones equal to a fresh
    ``HostLayout.payload`` of it; a sink that keeps its frames (appsink,
    ``KEEPS_PAYLOAD``) is handed arrays of its own a frame, equal to
    `run`'s, any other (fakesink) the slot's payload itself."""
    feeds = {"appsrc0": i420(8, 64, 36, 40)}
    want = run_frames(fed(GREEDY, feeds, device="cpu"), 8)
    pipe = fed(GREEDY.replace("appsink", sink), feeds, device="cpu")
    two_sets_on_cpu(pipe)
    streams_on_cpu(monkeypatch, pipe)
    el = pipe.sinks[0]
    handed = []
    real = el.deliver

    def deliver(payload, spec, k):
        handed.append((payload, payload_bytes(payload)))
        real(payload, spec, k)

    el.deliver = deliver
    assert pipe.run_batched(8, batch_size=2) == 8
    layout, ring = pipe._rings[el.name]
    assert len(ring) == 4
    assert len(pipe._slots) == 4
    for flat, views, payload in ring:
        assert pipe._slots[flat.data_ptr()][2] is payload
        fresh = layout.payload(flat)
        assert payload.keys() == fresh.keys() == {"y", "u", "v"}
        for k, view in payload.items():
            assert np.shares_memory(view, flat.numpy())
            assert np.array_equal(view, fresh[k])
        for view, (k, arr) in zip(views, payload.items()):
            assert np.shares_memory(view.numpy(), arr)
    assert [b for _, b in handed] == want
    for payload, _ in handed:
        own = [any(np.shares_memory(v, flat.numpy()) for flat, _, _ in ring)
               for v in payload.values()]
        if el.KEEPS_PAYLOAD:
            assert not any(own)
        else:
            assert all(own) and any(payload is p for _, _, p in ring)


class _Library:
    """The kernel library's `copy_d2h` on the CPU: reads back the arrays
    of pointers and sizes it is handed, and returns `err`."""

    def __init__(self, err):
        self.err, self.calls = err, []

    def copy_d2h(self, dst, src, nbytes, count, stream):
        read = [np.ctypeslib.as_array(
            ctypes.cast(p, ctypes.POINTER(ctypes.c_int64)), (count,)).copy()
            for p in (dst, src, nbytes)]
        self.calls.append((*[r.tolist() for r in read], count, stream))
        return self.err


@pytest.mark.parametrize("err", [0, 700])
def test_copy_d2h_hands_the_library_every_piece(err, monkeypatch):
    """``core/frame.py`` `copy_d2h`: one call into the library for all the
    copies it is given, each view's and piece's address and the piece's
    bytes in order, on the stream's handle; a CUDA error code raises."""
    from tpuvf_torch.core import frame
    from tpuvf_torch.kernels import _build

    lib = _Library(err)
    monkeypatch.setattr(_build, "load", lambda: lib)
    pieces = [torch.zeros(4, 6, dtype=torch.uint8),
              torch.zeros(2, 3, 4, dtype=torch.uint8),
              torch.zeros(5, dtype=torch.float32)]
    views = [torch.empty_like(p) for p in pieces]

    class Stream:
        cuda_stream = 1234

    copies = list(zip(views, pieces))
    if err:
        with pytest.raises(RuntimeError, match="CUDA error 700"):
            frame.copy_d2h(copies, Stream())
    else:
        frame.copy_d2h(copies, Stream())
    assert lib.calls == [([v.data_ptr() for v in views],
                          [p.data_ptr() for p in pieces],
                          [24, 24, 20], 3, 1234)]
    frame.copy_d2h([], Stream())
    assert len(lib.calls) == 1


# -- failures ------------------------------------------------------------------


@pytest.mark.parametrize("stage_fails", [True, False])
def test_replay_fault_names_the_batch_and_the_rerun_names_the_stage(
        stage_fails, monkeypatch):
    desc = f"appsrc format=NV12 width=32 height=24 ! {BCS} ! appsink"
    pipe = fed(desc, {"appsrc0": nv12(8, 32, 24, 33)}, device="cpu")
    st = next(st for st in pipe.stages if not st.passthrough)
    real_process = st.process
    real_step = pipe.compiled.step_batch

    def process(*a):
        raise ValueError("the stage's own fault")

    def step_batch(rows, metas, state, index):
        if index == 4:  # the second batch's replay faults
            if stage_fails:
                st.process = process  # the re-run meets the failing stage
            raise RuntimeError("a device fault at the replay")
        return real_step(rows, metas, state, index)

    monkeypatch.setattr(pipe.compiled, "step_batch", step_batch)
    with pytest.raises(PipelineError) as info:
        pipe.run_batched(8, batch_size=4)
    assert info.value.frame_index == 4
    assert info.value.element == (st.element.name if stage_fails
                                  else "<pipeline>")
    assert "device fault" in str(info.value.cause)
    assert len(pipe["appsink0"].frames) == 4  # batch 0 delivered
    st.process = real_process


def test_capture_broken_by_a_stage_names_it_at_the_batch():
    """A stage whose op fails only while it is captured: PipelineError
    names it at the capturing batch's first frame, after the eager batch
    before it was delivered; nothing runs it eagerly instead."""
    desc = f"appsrc format=NV12 width=32 height=24 ! {BCS} ! appsink"
    pipe = fed(desc, {"appsrc0": nv12(8, 32, 24, 34)}, device="cpu")
    captured = replay_on_cpu(pipe)
    capture = pipe.compiled._capture
    st = next(st for st in pipe.stages if not st.passthrough)
    real = st.process
    capturing = []

    def process(*a):
        if capturing:
            raise RuntimeError("operation not permitted when stream is "
                               "capturing")
        return real(*a)

    def in_capture(body, device, index, entry):
        capturing.append(True)
        try:
            return capture(body, device, index, entry)
        finally:
            capturing.clear()

    st.process = process
    pipe.compiled._capture = in_capture
    with pytest.raises(PipelineError) as info:
        pipe.run_batched(8, batch_size=4)
    assert (info.value.element, info.value.frame_index) == (st.element.name,
                                                            4)
    assert captured == [4] and pipe.compiled.eager == 4
    assert len(pipe["appsink0"].frames) == 4


# -- against tpuvf's one program a batch ----------------------------------------


@pytest.mark.parametrize("label", ["a", "g"])
def test_batches_match_tpuvf_scan(label, monkeypatch):
    """tpuvf's run_batched (``jax.jit`` of a ``lax.scan`` over the batch)
    against the port's batch graphs on the same seeded frames, two batches
    of 4: within 1 LSB (the b/c/s fold's and greedy-H's knife edges under
    XLA's compile; ROADMAP's contract)."""
    monkeypatch.setenv("TPUVF_NO_SPLIT_LINKS", "1")
    if label == "a":
        desc = (f"appsrc format=NV12 width=64 height=48 ! "
                f"vfmetalconvertscale ! video/x-raw,format=BGRA,width=32,"
                f"height=24 ! {BCS} ! appsink")
        feeds = {"appsrc0": nv12(8, 64, 48, 35)}
    else:
        desc = GREEDY
        feeds = {"appsrc0": i420(8, 64, 36, 36)}
    want = fed(desc, feeds, parse=tpuvf_parse)
    want.run_batched(8, batch_size=4)
    got = fed(desc, feeds, device="cpu")
    replay_on_cpu(got)
    got.run_batched(8, batch_size=4)
    assert got.compiled.batch_captures == 1
    assert len(got["appsink0"].frames) == len(want["appsink0"].frames) == 8
    for g, w in zip(got["appsink0"].frames, want["appsink0"].frames):
        g = g if isinstance(g, dict) else {"frame": g}
        w = w if isinstance(w, dict) else {"frame": w}
        worst, share = diff_stats(w, g)
        print(f"({label}) batched vs tpuvf's scan: max {worst} LSB, "
              f"{share:.4%} differ")
        assert worst <= 1
