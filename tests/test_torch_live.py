"""Live runs and resets in the port (ports of tests/test_live_mode.py with
the same FakeClock, and of tpuvf's ``Pipeline.reset``).

`Pipeline.run_live` paces `run` on the output clock and drops the ticks
whose deadline has passed (`stats.frames_dropped`); under one fake clock
the port and tpuvf deliver the same frames and drop the same ticks.
`Pipeline.reset` drops the carried state, so the next run starts like a
fresh pipeline.  Tolerance against tpuvf: <= 1 LSB (the b/c/s fold and
greedy-H's knife edge under tpuvf's FMA contraction, ROADMAP); grain: <= 2
LSB on all but an outlier share under 1% (tests/test_torch_elements.py).
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from tpuvf.cli.launch import parse_pipeline as tpuvf_parse
from tpuvf_torch.cli.launch import parse_pipeline as port_parse_on

torch.set_num_threads(1)

DESC = ("videotestsrc num-buffers=8 "
        "! video/x-raw,format=NV12,width=64,height=48,framerate=25/1 "
        "! vfmetalvideofilter contrast=1.2 ! appsink")
# a moving pattern, so which frames were delivered shows in their pixels
BALL = DESC.replace("videotestsrc", "videotestsrc pattern=ball")


@pytest.fixture(autouse=True)
def _canonical(monkeypatch):
    monkeypatch.setenv("TPUVF_NO_SPLIT_LINKS", "1")


def port_parse(desc):
    return port_parse_on(desc, device="cpu")


def _build(parse=port_parse, desc=DESC):
    p = parse(desc)
    p.negotiate()
    p.build()
    return p


def _flat(frame) -> np.ndarray:
    """One frame's bytes: an NV12 frame is a dict of planes."""
    if isinstance(frame, dict):
        return np.concatenate([np.ravel(frame[k]) for k in sorted(frame)])
    return np.asarray(frame)


def _frames(p):
    return [_flat(f) for f in p.sinks[0].frames]


def _max_lsb(a, b):
    assert a.shape == b.shape and a.dtype == b.dtype == np.uint8
    return int(np.abs(a.astype(np.int32) - b.astype(np.int32)).max())


class FakeClock:
    """Time advances only via sleep (on-time runs) plus an optional cost
    added per time() poll (simulated slow processing)."""

    def __init__(self, cost_per_poll=0.0):
        self.t = 0.0
        self.cost = cost_per_poll
        self.sleeps = []

    def time(self):
        self.t += self.cost
        return self.t

    def sleep(self, dt):
        assert dt >= 0.0
        self.sleeps.append(dt)
        self.t += dt


def test_run_live_on_time_renders_everything():
    p = _build()
    clk = FakeClock()
    n = p.run_live(8, time_fn=clk.time, sleep_fn=clk.sleep)
    assert n == 8
    assert p.stats.frames_dropped == 0
    assert len(p.sinks[0].frames) == 8
    assert len(clk.sleeps) >= 7  # paced: it slept up to each 40 ms deadline
    q = _build()
    q.run(8)
    for a, b in zip(_frames(p), _frames(q)):  # the offline run, bitwise
        np.testing.assert_array_equal(a, b)


def test_run_live_slow_processing_drops():
    p = _build()
    # every time() poll costs 60 ms, past the 40 ms period: the pacer
    # drops ticks instead of falling behind
    clk = FakeClock(cost_per_poll=0.06)
    n = p.run_live(8, time_fn=clk.time, sleep_fn=clk.sleep)
    assert n + p.stats.frames_dropped == 8
    assert p.stats.frames_dropped > 0
    assert len(p.sinks[0].frames) == n
    assert "dropped" in p.stats.summary()


@pytest.mark.parametrize("cost", [0.0, 0.03, 0.06, 0.11])
def test_run_live_drops_the_ticks_tpuvf_drops(cost):
    """Under the same fake clock both deliver the same frames (the moving
    pattern shows which) and count the same drops."""
    got = []
    for parse in (port_parse, tpuvf_parse):
        p = _build(parse, BALL)
        clk = FakeClock(cost_per_poll=cost)
        n = p.run_live(8, time_fn=clk.time, sleep_fn=clk.sleep)
        got.append((n, p.stats.frames_dropped, _frames(p), clk.sleeps))
    (pn, pd, pf, ps), (tn, td, tf, ts) = got
    assert (pn, pd) == (tn, td)
    assert ps == ts
    for i, (a, b) in enumerate(zip(pf, tf)):
        assert _max_lsb(a, b) <= 1, f"frame {i}"  # module doc
    q = _build(port_parse, BALL)
    q.run(8)
    offline = _frames(q)
    # each delivered frame is one of the offline run's, in order
    picks = [next(k for k, o in enumerate(offline) if np.array_equal(f, o))
             for f in pf]
    assert picks == sorted(picks) and picks[0] == 0


def test_latency_query():
    p = _build()
    lo, hi = p.latency()
    assert lo == 0.0
    assert abs(hi - 1.0 / 25.0) < 1e-9
    t = _build(tpuvf_parse)
    assert t.latency() == (lo, hi)


def test_launcher_live_reports_drops(capsys):
    """--live prints tpuvf's "(N dropped, live QoS)" tail when ticks were
    dropped, and no tail when none was."""
    from tpuvf_torch.cli import launch

    n = launch.launch(DESC, device="cpu", live=True)
    out = capsys.readouterr().out
    assert n == 8 and "dropped" not in out
    assert "processed 8 frames on cpu, reached end of stream" in out


# -- reset ------------------------------------------------------------------


GREEDY = ("appsrc format=RGBA width=16 height=12 ! vfmetaldeinterlace "
          "method=greedyh motion-threshold=0.3 ! appsink")
GRAIN = ("videotestsrc num-buffers=3 pattern=smpte ! video/x-raw,format=RGBA,"
         "width=32,height=24 ! vfmetalvideofilter noise=0.5 ! appsink")


def _fed(parse, desc, frames):
    p = parse(desc)
    for f in frames:
        p["appsrc0"].push(f)
    p["appsrc0"].end_of_stream()
    p.negotiate()
    p.build()
    return p


def test_reset_restarts_greedy_h():
    """After reset() greedy-H has no previous frame: a second pass over the
    same frames equals a fresh pipeline's first pass (without the reset it
    weaves against the last frame of the first pass), as in tpuvf."""
    rng = np.random.default_rng(5)
    frames = [rng.integers(0, 256, (12, 16, 4), dtype=np.uint8)
              for _ in range(3)]
    got = {}
    for name, parse in (("port", port_parse), ("tpuvf", tpuvf_parse)):
        p = _fed(parse, GREEDY, frames)
        p.run()
        p.reset()
        assert p.run() == 3
        got[name] = _frames(p)
    port = got["port"]
    for i in range(3):
        np.testing.assert_array_equal(port[3 + i], port[i], err_msg=f"{i}")
        assert _max_lsb(port[3 + i], got["tpuvf"][3 + i]) <= 1
    kept = _fed(port_parse, GREEDY, frames)
    kept.run()
    kept.run()
    assert not np.array_equal(_frames(kept)[3], port[0])


def test_reset_restarts_the_grain_counter():
    """After reset() the grain counter is 0 again: the next run's frames
    equal a fresh pipeline's, and tpuvf's (grain tolerance, module doc)."""
    got = {}
    for name, parse in (("port", port_parse), ("tpuvf", tpuvf_parse)):
        p = _build(parse, GRAIN)
        p.run(2)
        p.reset()
        p.run(2)
        got[name] = _frames(p)
    port = got["port"]
    fresh = _build(port_parse, GRAIN)
    fresh.run(2)
    for i in range(2):
        np.testing.assert_array_equal(port[2 + i], _frames(fresh)[i])
        d = np.abs(port[2 + i].astype(np.int32)
                   - got["tpuvf"][2 + i].astype(np.int32))
        assert (d > 2).mean() < 0.01
    p = _build(port_parse, GRAIN)
    p.run(2)
    p.reset()
    assert p.state is None and p.stages == [] and not p._negotiated
