"""One graph a dp shard (`CompiledStep.shard`, `ShardStep`) on the CPU:
`run_batched(mesh=...)` runs each shard's sub-batch through `_step_bands`,
its bands included, as one body over the shard's fixed input rows, each
card's param rows and its band state tiles.  On a mesh of
``["cpu"] * n`` every shard lies on one device, so with the CPU stand-in
for a CUDA graph (`replay_on_cpu`, tests/test_torch_compiled_batch.py) the
shards capture and replay as they do on one card (chip_smoke.py phase (m)).

- 0 LSB against the frame-by-frame eager `_step_bands` loop the mesh ran
  before (`eager_mesh_frames`, below) and against the unsharded run: rows
  over sp 2, dp 2 with sp 2 (two shards on one card), greedy-H's banded
  previous frame resumed across calls, a compositor's banded canvas with a
  moving pad; after the warm-up no frame runs eagerly.
- A dp=1 run publishes its state, and `run()` goes on from it.
- `load_mesh_state` from tpuvf's tiled state (``from_tpuvf``), then the
  next call against tpuvf's ``parallel_batch_fn`` (tests/
  test_torch_sp_tpuvf.py's rule: within 1 LSB).
- A shard whose bands lie on several cards runs eagerly, and counts.
"""

import numpy as np
import pytest
import torch

import jax

from tests.test_torch_compiled_batch import replay_on_cpu
from tests.test_torch_compiled_step import i420, nv12, payload_bytes, rgba
from tpuvf.cli.launch import parse_pipeline as tpuvf_parse
from tpuvf.parallel import mesh as tpuvf_mesh
from tpuvf_torch.cli.launch import parse_pipeline as port_parse
from tpuvf_torch.elements.compositor import DRAW_TABLE
from tpuvf_torch.parallel import mesh as pmesh
from tpuvf_torch.parallel.mesh import make_mesh
from tpuvf_torch.runtime.params import from_tpuvf
from tpuvf_torch.runtime.staging import ParamStager, read_params

torch.set_num_threads(1)

CPU8 = ["cpu"] * 8
CONVERT = ("appsrc format=NV12 width=64 height=48 ! vfmetalconvertscale ! "
           "video/x-raw,format=BGRA ! vfmetalvideofilter contrast=1.1 "
           "sharpness=0.4 ! appsink")
GREEDY = ("appsrc format=I420 width=64 height=48 ! video/x-raw,"
          "interlace-mode=interleaved ! vfmetaldeinterlace method=greedyh "
          "motion-threshold=0.3 ! appsink")
COMPOSITE = ("vfmetalcompositor name=c background=checker sink_1::xpos=20 "
             "sink_1::ypos=10 sink_1::alpha=0.8 ! video/x-raw,format=NV12,"
             "width=64,height=48 ! appsink "
             "appsrc name=s0 format=NV12 width=64 height=48 ! c.sink_0 "
             "appsrc name=s1 format=BGRA width=24 height=16 ! c.sink_1")


def _fed(desc, feeds, device="cpu", parse=port_parse):
    pipe = parse(desc, device=device) if parse is port_parse else parse(desc)
    for name, frames in feeds.items():
        for f in frames:
            pipe[name].push(f)
        pipe[name].end_of_stream()
    pipe.negotiate()
    pipe.build()
    return pipe


def _feeds(desc):
    if desc is GREEDY:
        return {"appsrc0": i420(8, 64, 48, 40)}
    if desc is COMPOSITE:
        return {"s0": nv12(8, 64, 48, 41), "s1": rgba(8, 24, 16, 42)}
    return {"appsrc0": nv12(8, 64, 48, 43)}


def _make(desc):
    pipe = _fed(desc, _feeds(desc))
    if desc is COMPOSITE:  # a moving pad: a draw table a frame
        pipe["c"].control("sink_1::xpos", [20 - 6 * k for k in range(8)])
    return pipe


def eager_mesh_frames(pipe, mesh, sp_axis, counts, batch_size) -> list:
    """The mesh loop frame by frame on freshly uploaded planes, each frame
    through the eager `_step_bands` with its own staged params: -> every
    frame's sink bytes, in order (the reference of the shard bodies)."""
    lay = pmesh.layout(mesh, sp_axis)
    replicated = pipe._sp_replicated if lay.sp > 1 else frozenset()
    plans = [pipe._shard_plan(devs) for devs in lay.devices]
    states = pmesh.tile_state(pipe.state, lay, replicated)
    out_fps, infos = pipe._clock()
    got = []
    for count in counts:
        done = 0
        while done < count:
            n = min(batch_size, count - done)
            for d, frames in pmesh.shard_frames(lay, batch_size, n):
                devs = lay.devices[d]
                for j in frames:
                    i = done + j
                    for el in pipe._controlled():
                        el.sync_frame(i)
                    sel = pipe._select_buffers(i, out_fps, infos)
                    metas = {name: meta for name, (_, meta) in sel.items()}
                    inputs = {}
                    for name, (k, meta) in sel.items():
                        src = pipe[name]
                        host = src.generate(k, pipe._source_spec(src))
                        inputs[name] = pipe._source_bands(
                            name, pipe.upload_sources({name: host})[name],
                            meta, devs)
                    params = []
                    for dev in devs:
                        reads = read_params(pipe._active(), dev)
                        prm = ParamStager(dev).frame(reads)
                        table = pipe._frame_tables(reads, metas)
                        for st, off, size in pipe._table_layout():
                            name = st.element.name
                            prm[name] = dict(prm[name], **{
                                DRAW_TABLE: torch.from_numpy(
                                    table[off:off + size].copy())})
                        params.append(prm)
                    out, states[d] = pipe._step_bands(
                        plans[d], inputs, states[d], params, done)
                    got.append(b"".join(
                        p.numpy().tobytes()
                        for _, _, pieces in pipe._payloads(out, i)
                        for p in pieces))
            done += n
    return got


def _sink_bytes(pipe):
    return [payload_bytes(f) for f in pipe["appsink0"].frames]


CASES = [
    ("convert-sp2", CONVERT, {"dp": 1, "sp": 2}),
    ("convert-dp2-sp2", CONVERT, {"dp": 2, "sp": 2}),
    ("greedyh-sp2", GREEDY, {"dp": 1, "sp": 2}),
    ("composite-sp2", COMPOSITE, {"dp": 1, "sp": 2}),
]


@pytest.mark.parametrize("label,desc,axes", CASES, ids=[c[0] for c in CASES])
def test_shard_graphs_equal_eager_bands_and_unsharded(label, desc, axes):
    """Two calls of 8 frames in batches of 4: the first call's first batch
    runs eagerly (its frame keys learnt), then every shard's sub-batch is
    one graph; 0 LSB against the eager loop and the unsharded run."""
    mesh = make_mesh(axes, devices=CPU8)
    pipe = _make(desc)
    captured = replay_on_cpu(pipe)
    pipe.run_batched(8, batch_size=4, mesh=mesh, sp_axis="sp")
    cs = pipe.compiled
    first = (cs.eager, cs.batch_captures, cs.batch_replays)
    cs.eager = cs.batch_replays = 0
    pipe.run_batched(8, batch_size=4, mesh=mesh, sp_axis="sp")
    got = _sink_bytes(pipe)
    assert got == eager_mesh_frames(_make(desc), mesh, "sp", (8, 8), 4)
    plain = _make(desc)
    plain.run_batched(8, batch_size=4)
    plain.run_batched(8, batch_size=4)
    assert got == _sink_bytes(plain)
    dp = axes["dp"]
    # batch 0's frame keys are new: its first shard runs eagerly (a second
    # shard on the same cards finds them learnt)
    assert first[0] == 4 // dp and first[1] == len(captured) >= 1
    assert first[2] == 2 * dp - 1
    assert cs.eager == 0 and cs.batch_replays == 2 * dp


def test_a_shard_graph_reads_its_own_rows():
    """dp 2: a tail of 6 in a batch of 8 puts shard 1 on the batch's rows
    4 and 5; a later call in batches of 4 puts it, with as many frames, on
    rows 2 and 3 of another batch size.  Each is its own graph, so a
    contrast ramp reads each frame's own row."""
    mesh = make_mesh({"dp": 2}, devices=CPU8)

    def make():
        pipe = _make(CONVERT)
        pipe["vfmetalvideofilter0"].control(
            "contrast", [1.0 + 0.05 * k for k in range(8)])
        return pipe

    pipe = make()
    replay_on_cpu(pipe)
    plain = make()
    for n, batch in ((6, 8), (4, 4), (6, 8), (4, 4)):
        pipe.run_batched(n, batch_size=batch, mesh=mesh)
        plain.run_batched(n, batch_size=batch)
    assert _sink_bytes(pipe) == _sink_bytes(plain)
    assert pipe.compiled.batch_captures == 4


def test_dp1_publishes_its_state_and_run_goes_on():
    mesh = make_mesh({"dp": 1, "sp": 2}, devices=CPU8)
    pipe = _make(GREEDY)
    replay_on_cpu(pipe)
    pipe.run_batched(8, batch_size=4, mesh=mesh, sp_axis="sp")
    plain = _make(GREEDY)
    plain.run_batched(8, batch_size=4)
    key = "vfmetaldeinterlace0"
    assert torch.equal(pipe.state[key]["prev"], plain.state[key]["prev"])
    assert pipe.state[key]["has_prev"] is True
    pipe.run(4)
    plain.run(4)
    assert _sink_bytes(pipe) == _sink_bytes(plain)


def test_a_shard_across_cards_runs_eagerly():
    """A shard whose bands lie on several cards cannot be one card's
    capture: it runs its body eagerly every batch, each frame counted in
    `eager` (forced here: the CPU mesh's bands share one device)."""
    mesh = make_mesh({"dp": 1, "sp": 2}, devices=CPU8)
    pipe = _make(CONVERT)
    captured = replay_on_cpu(pipe)
    lay = pmesh.layout(mesh, "sp")
    shard = pipe.compiled.shard(lay, 0, pipe._shard_plan(lay.devices[0]))
    shard.one_card = False
    pipe.run_batched(8, batch_size=4, mesh=mesh, sp_axis="sp")
    cs = pipe.compiled
    assert (cs.eager, cs.batch_captures, cs.batch_replays) == (8, 0, 0)
    assert not captured
    plain = _make(CONVERT)
    plain.run_batched(8, batch_size=4)
    assert _sink_bytes(pipe) == _sink_bytes(plain)


def test_tpuvf_tiled_state_then_the_next_call_matches_tpuvf(monkeypatch):
    """tpuvf's mesh run (``parallel_batch_fn``: each shard scans its
    frames) of weave over sp 2, two batches of 2; its tiled state into a
    fresh port pipeline (``from_tpuvf(tiled=True)``, `load_mesh_state`),
    whose next call through the shard graphs matches tpuvf's next call
    within 1 LSB, as tests/test_torch_sp_tpuvf.py holds the eager mesh."""
    monkeypatch.setenv("TPUVF_NO_SPLIT_LINKS", "1")
    if len(jax.devices()) < 8:
        pytest.skip("tpuvf's mesh needs 8 host devices")
    desc = ("videotestsrc num-buffers=4 pattern=ball ! video/x-raw,format="
            "NV12,width=64,height=48 ! vfmetaldeinterlace method=weave ! "
            "vfmetalvideofilter contrast=1.2 ! appsink")
    axes = {"dp": 1, "sp": 2}
    tp = _fed(desc, {}, parse=tpuvf_parse)
    tmesh = tpuvf_mesh.make_mesh(axes)
    tp.run_batched(4, batch_size=2, mesh=tmesh, sp_axis="sp")
    _, tiled = tp._mesh_state
    shards = [{}]
    for name, st in tiled.items():
        shards[0][name] = from_tpuvf({}, st, "cpu", tiled=True)[1][0]
    mesh = make_mesh(axes, devices=CPU8)
    pipe = _fed(desc, {})
    replay_on_cpu(pipe)
    pipe.load_mesh_state(mesh, "sp", shards)
    tp.sinks[0].frames.clear()
    tp.run_batched(4, batch_size=2, mesh=tmesh, sp_axis="sp")
    pipe.run_batched(4, batch_size=2, mesh=mesh, sp_axis="sp")
    assert pipe.compiled.batch_captures == 1  # batch 1; batch 0 eager
    want, got = tp.sinks[0].frames, pipe.sinks[0].frames
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        for k in w:
            d = np.abs(g[k].astype(np.int32) - w[k].astype(np.int32))
            assert d.max() <= 1, (k, int(d.max()))
