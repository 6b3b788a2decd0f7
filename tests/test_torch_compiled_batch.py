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
- A fault at a replay raises PipelineError at the batch's first frame, the
  element named by the eager re-run; a capture broken by a stage names it
  at the batch's first frame.
- Against tpuvf's `run_batched` (one ``lax.scan`` a batch) on the same
  seeded frames under TPUVF_NO_SPLIT_LINKS=1: within ROADMAP's contract,
  at most 1 LSB (the b/c/s fold's and greedy-H's knife edges under XLA's
  compile).
"""

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
    run_frames,
)
from tests.test_torch_elements import diff_stats
from tpuvf.cli.launch import parse_pipeline as tpuvf_parse
from tpuvf_torch.runtime.compiled import _Entry
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
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in _tensors(v)]
    return []


def replay_on_cpu(pipe):
    """`pipe`'s compiled step captures and replays with `CpuGraph`; -> the
    first frame index of each of its captures."""
    cs = pipe.compiled
    cs.graphs = True
    captured = []

    def capture(body, device, index):
        captured.append(index)
        result = body()
        return _Entry(CpuGraph(body, result), result, {})

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

    def in_capture(body, device, index):
        capturing.append(True)
        try:
            return capture(body, device, index)
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
