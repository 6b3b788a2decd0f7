"""The upload straight from a source's recurring frame pool
(``core/frame.py`` `HostRegistry`, `HostLayout.upload_into`).

On the CPU the registry is driven with an injected register/unregister pair
and `upload_into` writes CPU tensors: a root is registered when a later
upload brings it again, never in the upload that first brings it, however
many of its frames that upload takes; a fresh array a frame is never
registered nor kept alive; a read-only root, a non-contiguous plane, a
failed registration and a root beyond the cap take the fill path; what is
registered stays within the cap in all, the least recently used root
unregistered to make room; memory already pinned is used and never
unregistered; `Pipeline.reset` unregisters; the counters count the frames
of each path; the rows a frame gets straight from the pool equal the filled
rows, byte for byte, in every host layout; a payload piece that is a view of
the fixed inputs is copied.

The tests marked ``card`` need a CUDA card and skip without one (run them
on the card with ``python -m pytest --noconftest -m card
tests/test_torch_upload_direct.py``): the run loops over a recurring pool
whose frames all differ, on the copy stream, byte-equal to the same runs
with the registry off and every step eager, also with the steps or the
copies held back on the card, so that an upload not ordered after the step
before it, or a step not ordered after its upload, would read wrong rows;
chains that pass an input plane on to the sink as it came in, with the
steps or the readbacks held back, so that a readback of the fixed inputs
would read the next upload's rows; a file source that hands out a fresh
array a frame stays on the fill path, also where a compositor takes its
frames at two rates; memory the caller pinned, and torch's pinned memory;
the registrations undone when the pipeline is freed.  The batch readback on
a stream of its own over two output sets taken in turns
(`CompiledStep.reading_back`): `run_batched` over recurring pools, 48 frames
in batches of 6, through the 4K convert+filter chain and BASELINE config 5's
four-pad 4K compositor (the benchmark's ``compositor_4k`` with an appsink),
byte-equal to the eager fill run, with the readback stream held before each
batch's copies (so the replays run ahead, kept from writing the output set
being read by the compute stream's wait on `_outputs_free` and the loop's
wait on each batch's delivery; once with every step eager, its payloads
from the caching allocator), and the
compute stream before each step and before the fourth alone (which only the
readback stream's wait on `_step_done` keeps the copies from outrunning).
The upload of a source's region (``tests/test_torch_upload_cull.py`` on the
CPU): config 5 at full size, every upload poisoning its rows first, byte-
equal to the eager fill run with s0's hidden quadrant never copied
(`upload_culled`); the inset sliding over s0 while s0 keeps its buffer, equal
to the eager run, and red where the memo ignores the regions.
"""

import gc
import json
import weakref
from contextlib import contextmanager
from pathlib import Path

import numpy as np
import pytest
import torch

from tpuvf_torch.cli.launch import parse_pipeline
from tpuvf_torch.core import region
from tpuvf_torch.core.formats import VideoFormat
from tpuvf_torch.core.frame import HostLayout, HostRegistry, host_pieces
from tpuvf_torch.core.spec import FrameSpec
from tpuvf_torch.runtime.compiled import CompiledStep, _unaliased
from vfbench import inputs

CPU = torch.device("cpu")
NV12 = FrameSpec(VideoFormat.NV12, 16, 8)


class FakeCuda:
    """The register/unregister pair and the pinned test the registry calls,
    recorded; each registration answers `code`, each test `pinned`."""

    def __init__(self, code=0, pinned=False):
        self.code = code
        self.pinned = pinned
        self.registered, self.unregistered = [], []

    def register(self, ptr, nbytes):
        self.registered.append((ptr, nbytes))
        return self.code

    def unregister(self, ptr):
        self.unregistered.append(ptr)

    def is_pinned(self, root):
        return self.pinned


def registry(code=0, pinned=False):
    fake = FakeCuda(code, pinned)
    return HostRegistry(CPU, fake.register, fake.unregister,
                        fake.is_pinned), fake


def pool(spec, n, seed=0, frames=None):
    """n distinct host frames of `spec` cut from one root, the way a
    decoder's frame pool lies (`vfbench/inputs.py` `frame_pool`), in a root
    of `frames` frames' bytes (n by default) -> (root, frames)."""
    layout = HostLayout(spec)
    rng = np.random.default_rng(seed)
    root = rng.integers(0, 256, (frames or n) * layout.nbytes,
                        dtype=np.uint8)
    rows = root[:n * layout.nbytes].reshape(n, layout.nbytes)
    out = []
    for row in rows:
        parts, off = {}, 0
        for key, shape in host_pieces(spec):
            size = int(np.prod(shape))
            parts[key] = row[off:off + size].reshape(shape)
            off += size
        out.append(parts[None] if None in parts else parts)
    return root, out


def upload(frames, reg=None, spec=NV12):
    """-> (the rows `upload_into` wrote, how many went straight)."""
    layout = HostLayout(spec)
    out = torch.zeros((len(frames), layout.nbytes), dtype=torch.uint8)
    direct, culled = layout.upload_into(frames, out, registry=reg)
    assert culled == 0  # no spans: every frame whole
    return out, direct


def row_bytes(frame, spec=NV12) -> np.ndarray:
    parts = HostLayout(spec)._parts(frame)
    return np.concatenate([np.ascontiguousarray(p).ravel() for p in parts])


# -- the registry -------------------------------------------------------------


def test_a_root_is_registered_on_its_second_sighting():
    reg, fake = registry()
    root, frames = pool(NV12, 4)
    _, direct = upload(frames[:1], reg)
    assert direct == 0 and fake.registered == []  # both planes, one sighting
    assert len(reg._roots) == 1
    _, direct = upload(frames[1:], reg)
    assert direct == 3
    assert fake.registered == [(root.ctypes.data, root.nbytes)]
    _, direct = upload(frames, reg)  # registered once, used from now on
    assert direct == 4 and len(fake.registered) == 1


def test_a_batch_registers_at_its_second_frame():
    """A batch's frames of one root are one sighting: its second frame
    registers nothing, the next batch registers the root."""
    reg, fake = registry()
    root, frames = pool(NV12, 8)
    out, direct = upload(frames, reg)
    assert direct == 0 and fake.registered == []
    out, direct = upload(frames, reg)
    assert direct == 8 and len(fake.registered) == 1
    for i, frame in enumerate(frames):
        assert np.array_equal(out[i].numpy(), row_bytes(frame))


def test_a_frame_twice_in_one_upload_is_one_sighting():
    """An output clock that picks one buffer for two frames of a batch (two
    rates) hands the same fresh frame twice: never registered nor kept."""
    reg, fake = registry()
    refs = []
    for seed in range(4):
        _, frames = pool(NV12, 2, seed)
        refs.append(weakref.ref(frames[0]["y"].base))
        _, direct = upload([frames[0], frames[0], frames[1], frames[1]], reg)
        assert direct == 0
        del frames
        gc.collect()
    assert fake.registered == [] and reg._held == {}
    assert all(r() is None for r in refs) and len(reg._roots) == 0


def test_a_fresh_array_per_frame_is_never_registered_nor_kept():
    reg, fake = registry()
    refs = []
    for seed in range(6):
        _, frames = pool(NV12, 1, seed)
        refs.append(weakref.ref(frames[0]["y"].base))
        _, direct = upload(frames, reg)
        assert direct == 0
        del frames
        gc.collect()
    assert all(r() is None for r in refs)
    assert fake.registered == [] and len(reg._roots) == 0


def test_rows_of_one_fresh_frame_in_a_batch_are_one_sighting(monkeypatch,
                                                              tmp_path):
    """Batches of 8 at 60 fps over a compositor whose second file source (a
    fresh array a frame) runs at 5 fps: its frame fills several rows of a
    batch, some of which hold it already, and the compiled step uploads the
    source's rows in one call, so that frame is one sighting and nothing is
    registered (the CUDA path's registry injected on the CPU)."""
    reg, fake = registry()
    real = HostLayout.upload_into

    def upload_into(self, frames, out, edge=None, index=None, registry=None,
                    spans=None):
        return real(self, frames, out, edge, index, reg, spans)

    monkeypatch.setattr(HostLayout, "upload_into", upload_into)
    paths = []
    for k, (spec, n) in enumerate(((NV12, 24),
                                   (FrameSpec(VideoFormat.BGRA, 8, 4), 2))):
        _, frames = pool(spec, n, seed=40 + k)
        paths.append(tmp_path / f"in{k}.raw")
        paths[-1].write_bytes(b"".join(row_bytes(f, spec).tobytes()
                                       for f in frames))
    pipe = parse_pipeline(
        "vfmetalcompositor name=c sink_1::xpos=4 ! video/x-raw,format=BGRA,"
        "width=16,height=8 ! appsink "
        f"rawvideosrc location={paths[0]} format=NV12 width=16 height=8 "
        "! video/x-raw,framerate=60/1 ! c.sink_0 "
        f"rawvideosrc location={paths[1]} format=BGRA width=8 height=4 "
        "! video/x-raw,framerate=5/1 ! c.sink_1", device="cpu")
    pipe.run_batched(24, batch_size=8)
    assert fake.registered == [] and reg._held == {}
    assert (pipe.stats.upload_direct, pipe.stats.upload_filled) == (0, 48)


@pytest.mark.parametrize("case", ["read_only", "not_contiguous", "failed"])
def test_fill_path_and_no_retry(case):
    reg, fake = registry(code=1 if case == "failed" else 0)
    root, frames = pool(NV12, 4)
    if case == "read_only":  # the frames' views were cut while writable
        root.flags.writeable = False
    elif case == "not_contiguous":
        for f in frames:
            wide = np.zeros((NV12.height, 2 * NV12.width), np.uint8)
            wide[:, ::2] = f["y"]
            f["y"] = wide[:, ::2]
    for _ in range(3):
        out, direct = upload(frames, reg)
        assert direct == 0
        for i, frame in enumerate(frames):
            assert np.array_equal(out[i].numpy(), row_bytes(frame))
    assert fake.registered == ([(root.ctypes.data, root.nbytes)]
                               if case == "failed" else [])


@pytest.mark.parametrize("frames, registered", [(64, True), (65, False)])
def test_the_cap_of_64_frames(frames, registered):
    assert HostRegistry.CAP_FRAMES == 64
    reg, fake = registry()
    _, pooled = pool(NV12, 3, frames=frames)
    for _ in range(2):
        _, direct = upload(pooled, reg)
    assert direct == (3 if registered else 0)
    assert len(fake.registered) == int(registered)


def test_registered_memory_is_capped_in_all():
    """Roots of 40 frames each: registering another unregisters the least
    recently used one, never one the current upload brings."""
    reg, fake = registry()
    (a, fa), (b, fb), (c, fc) = (pool(NV12, 2, seed, frames=40)
                                 for seed in range(3))
    for _ in range(2):
        upload(fa, reg)
    assert [id(r) for r in reg._held.values()] == [id(a)]
    for _ in range(2):  # a and b together: b cannot make room
        _, direct = upload(fa + fb, reg)
        assert direct == 2
    assert [id(r) for r in reg._held.values()] == [id(a)]
    upload(fc, reg)
    _, direct = upload(fc, reg)  # a was not in this upload: it makes room
    assert direct == 2
    assert fake.unregistered == [a.ctypes.data]
    assert [id(r) for r in reg._held.values()] == [id(c)]
    _, direct = upload(fa, reg)  # unregistered, it is registered anew
    assert direct == 2 and fake.unregistered[-1] == c.ctypes.data
    assert sum(r.nbytes for r in reg._held.values()) <= (
        HostRegistry.CAP_FRAMES * HostLayout(NV12).nbytes)


def test_four_sources_share_one_budget(monkeypatch):
    """BASELINE config 5's four sources at a twentieth of their sizes (the
    same byte ratios: 4K BGRA, 1080p NV12, 720p BGRA, 720p NV12), 8-frame
    pools, six batches uploaded as `run_batched` uploads them, source by
    source through a layout of its own: each pool registered once, at the
    second batch, none unregistered and the device never synchronised, so a
    small source's admission does not evict the 4K pool."""
    reg, fake = registry()
    syncs = []
    monkeypatch.setattr(reg, "_sync", lambda: syncs.append(1))
    specs = [FrameSpec(VideoFormat.BGRA, 192, 108),
             FrameSpec(VideoFormat.NV12, 96, 54),
             FrameSpec(VideoFormat.BGRA, 64, 36),
             FrameSpec(VideoFormat.NV12, 64, 36)]
    layouts = [HostLayout(s) for s in specs]
    pools = [pool(s, 8, seed) for seed, s in enumerate(specs)]
    for batch in range(6):
        for layout, (root, frames) in zip(layouts, pools):
            out = torch.zeros((8, layout.nbytes), dtype=torch.uint8)
            direct, _ = layout.upload_into(frames, out, registry=reg)
            assert direct == (0 if batch == 0 else 8)
        if batch == 1:
            assert fake.registered == [(root.ctypes.data, root.nbytes)
                                       for root, _ in pools]
    assert len(fake.registered) == 4
    assert fake.unregistered == [] and syncs == []
    assert reg.budget() == HostRegistry.CAP_FRAMES * sum(
        lay.nbytes for lay in layouts)


def test_memory_already_pinned_is_used_and_never_unregistered():
    reg, fake = registry(pinned=True)
    root, frames = pool(NV12, 4)
    upload(frames, reg)
    _, direct = upload(frames, reg)
    assert direct == 4 and fake.registered == []
    reg.release()
    assert fake.unregistered == []
    assert len(reg._roots) == 0


def test_reset_unregisters():
    reg, fake = registry()
    root, frames = pool(NV12, 2)
    upload(frames, reg)
    upload(frames, reg)
    pipe = parse_pipeline(
        "appsrc format=NV12 width=16 height=8 ! fakesink", device="cpu")
    assert pipe._host_memory is None  # none on the CPU
    pipe._host_memory = reg
    pipe.reset()
    assert fake.unregistered == [root.ctypes.data]
    assert len(reg._roots) == 0
    ref = weakref.ref(root)
    del root, frames
    gc.collect()
    assert ref() is None  # held only while registered


@pytest.mark.parametrize("loop", ["run", "run_batched", "mesh"])
def test_the_counters_on_the_cpu(loop):
    """On the CPU every frame a source is filled (no registry)."""
    from tpuvf_torch.parallel.mesh import make_mesh

    _, frames = pool(NV12, 4)
    pipe = parse_pipeline(
        "appsrc format=NV12 width=16 height=8 ! vfmetalvideofilter "
        "brightness=0.1 ! appsink", device="cpu")
    for k in range(8):
        pipe["appsrc0"].push(frames[k % 4])
    pipe["appsrc0"].end_of_stream()
    if loop == "run":
        pipe.run(8)
    elif loop == "run_batched":
        pipe.run_batched(8, batch_size=4)
    else:
        pipe.run_batched(8, batch_size=4,
                         mesh=make_mesh({"dp": 2}, devices=["cpu"] * 2))
    assert (pipe.stats.upload_direct, pipe.stats.upload_filled) == (0, 8)
    assert pipe.stats.readback_async == 0  # no readback stream
    pipe.build()  # the stats start afresh with the build
    assert (pipe.stats.upload_direct, pipe.stats.upload_filled) == (0, 0)


@pytest.mark.parametrize("fmt", ["NV12", "I420", "BGRA", "UYVY"])
def test_direct_and_filled_rows_are_equal(fmt):
    spec = FrameSpec(VideoFormat(fmt), 24, 10)
    reg, _ = registry()
    _, frames = pool(spec, 4, seed=7)
    fresh = pool(spec, 1, seed=8)[1]
    batch = [frames[0], fresh[0], frames[1], frames[2], frames[3]]
    upload(frames[:1], reg, spec)
    direct_rows, direct = upload(batch, reg, spec)
    assert direct == 4  # the pool's frames, not the fresh one
    filled_rows, none = upload(batch, None, spec)
    assert none == 0
    assert torch.equal(direct_rows, filled_rows)
    for i, frame in enumerate(batch):
        assert np.array_equal(direct_rows[i].numpy(), row_bytes(frame, spec))


def test_upload_into_refuses_a_wrong_buffer():
    reg, _ = registry()
    _, frames = pool(NV12, 2)
    layout = HostLayout(NV12)
    with pytest.raises(ValueError, match="2 frames into"):
        layout.upload_into(frames, torch.zeros((3, layout.nbytes),
                                               dtype=torch.uint8),
                           registry=reg)


@pytest.mark.parametrize("fmt, aliased", [("I420", [True, True, True]),
                                          ("NV12", [True, False])])
def test_a_payload_that_aliases_the_fixed_inputs_is_copied(monkeypatch, fmt,
                                                           aliased):
    """A chain at its input's caps passes the input planes on: the sink's
    payload pieces are views of the fixed inputs, which `_unaliased`
    replaces by copies (on CUDA inside the body)."""
    seen = []
    real = CompiledStep._batch_body

    def spy(self, rows, metas, state, index):
        out = real(self, rows, metas, state, index)
        seen.append((out[0], self._rows[len(rows)][0].values()))
        return out

    monkeypatch.setattr(CompiledStep, "_batch_body", spy)
    spec = FrameSpec(VideoFormat(fmt), 16, 8)
    _, frames = pool(spec, 4, seed=3)
    pipe = parse_pipeline(
        f"appsrc format={fmt} width=16 height=8 ! vfmetalconvertscale ! "
        f"video/x-raw,format={fmt},width=16,height=8 ! appsink", device="cpu")
    for frame in frames:
        pipe["appsrc0"].push(frame)
    pipe["appsrc0"].end_of_stream()
    pipe.run_batched(4, batch_size=2)
    payloads, flats = seen[-1]
    held = {f.untyped_storage().data_ptr() for f in flats}
    ((_, _, pieces),) = payloads[-1]
    assert [p.untyped_storage().data_ptr() in held for p in pieces] == aliased
    ((_, _, owned),) = _unaliased(payloads[-1], flats)
    for piece, mine, alias in zip(pieces, owned, aliased):
        assert torch.equal(piece, mine)
        assert (mine is not piece) == alias
        assert mine.untyped_storage().data_ptr() not in held


# -- on the card ----------------------------------------------------------------


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


CHAIN = ("appsrc format=NV12 width=3840 height=2160 ! vfmetalconvertscale ! "
         "video/x-raw,format=BGRA,width=3840,height=2160 ! vfmetalvideofilter "
         "brightness=0.05 contrast=1.1 saturation=1.2 ! appsink")


HOLD_CYCLES = 400_000_000  # about 0.2 s of the card's clock


def hold(monkeypatch, what: str) -> None:
    """Hold a stream back on the card (`torch.cuda._sleep`).  "steps": the
    compute stream before each step, after its wait on the upload (and a
    batch's on its output set), so the host enqueues the next upload
    before the step has read its rows, which only the copy stream's wait
    on `_inputs_free` keeps from being overwritten, and a batch's readback
    before the step has written its payloads, which only the readback
    stream's wait on `_step_done` keeps from reading them early.
    "step3": the same before the fourth step alone (`run_batched`'s
    fourth batch, the second on its output set), the readback stream idle
    and ahead of it.  "copies": the copy stream before each upload's
    copies, which only the step's wait on `_inputs_ready` keeps it from
    outrunning.  "readbacks": the readback stream before each batch's
    copies (`CompiledStep.reading_back`, after its wait on `_step_done`),
    so the next batches' replays run ahead: the next upload writes the
    fixed inputs before the readback has read its payload, which must
    therefore not be a view of them (`_unaliased`), and the replay two
    batches later would write the payloads being read but for its wait on
    `_outputs_free` (and the loop's wait on the batch's delivery)."""
    if what in ("steps", "step3"):
        real = CompiledStep._over_inputs
        steps = []

        def held(self, run):
            def later():
                if what == "steps" or len(steps) == 3:
                    torch.cuda._sleep(HOLD_CYCLES)
                steps.append(1)
                return run()
            return real(self, later)

        monkeypatch.setattr(CompiledStep, "_over_inputs", held)
    elif what == "copies":
        real_upload = HostLayout.upload_into

        def held_upload(self, *a, **k):
            torch.cuda._sleep(HOLD_CYCLES)  # on the copy stream
            return real_upload(self, *a, **k)

        monkeypatch.setattr(HostLayout, "upload_into", held_upload)
    elif what == "readbacks":
        real_reading = CompiledStep.reading_back

        @contextmanager
        def held_reading(self, outs):
            with real_reading(self, outs) as stream:
                torch.cuda._sleep(HOLD_CYCLES)  # on the readback stream
                yield stream

        monkeypatch.setattr(CompiledStep, "reading_back", held_reading)


def _card_run(loop, frames, n, direct=True, chain=CHAIN):
    """`loop` over `frames` ({source: frames}, or appsrc0's) in a cycle
    through `chain`, n frames -> (the sink's frames as bytes, the
    pipeline's stats).  `direct` False: the registry off and every step
    eager, the reference."""
    pipe = parse_pipeline(chain, device="cuda")
    pools = frames if isinstance(frames, dict) else {"appsrc0": frames}
    for name, pooled in pools.items():
        for k in range(n):
            pipe[name].push(pooled[k % len(pooled)])
        pipe[name].end_of_stream()
    if not direct:
        pipe._host_memory = None
        pipe.compiled.graphs = False
    if loop == "run_batched":  # 6 a batch: a row takes another frame each
        pipe.run_batched(n, batch_size=6)
    elif loop == "run":
        pipe.run(n)
    else:
        pipe.run_live(n, time_fn=lambda: 0.0, sleep_fn=lambda s: None)
    out = [row_bytes(f, pipe._source_spec(pipe["appsrc0"])).tobytes()
           if isinstance(f, dict) else np.ascontiguousarray(f).tobytes()
           for f in pipe.sinks[0].frames]
    return out, pipe.stats


@pytest.mark.card
@pytest.mark.parametrize("held", ["nothing", "steps", "copies"])
@pytest.mark.parametrize("loop", ["run_batched", "run", "run_live"])
def test_the_loops_over_a_recurring_pool_on_the_card(card, monkeypatch,
                                                      loop, held):
    """As they run, and with either stream held back (`hold`)."""
    spec = FrameSpec(VideoFormat.NV12, 3840, 2160)
    _, frames = pool(spec, 8, seed=11)
    n = 48 if loop == "run_batched" else 24
    want, ref_stats = _card_run(loop, frames, n, direct=False)
    hold(monkeypatch, held)
    got, stats = _card_run(loop, frames, n)
    first = 6 if loop == "run_batched" else 1  # the first upload's frames
    assert stats.upload_direct == n - first and stats.upload_filled == first
    assert ref_stats.upload_direct == 0
    assert len(set(got[:8])) == 8  # every pool frame differs
    assert len(got) == len(want) == n
    for i, (a, b) in enumerate(zip(got, want)):
        assert a == b, f"frame {i}"


@pytest.mark.card
@pytest.mark.parametrize("held", ["steps", "readbacks"])
@pytest.mark.parametrize("fmt", ["I420", "NV12"])
def test_a_chain_that_passes_planes_on_on_the_card(card, monkeypatch, fmt,
                                                   held):
    """A chain at its input's caps (elided) hands the sink the input's
    planes, all of I420's and NV12's Y: read back byte for byte as the
    eager fill run reads them, with the steps or the readbacks held."""
    spec = FrameSpec(VideoFormat(fmt), 3840, 2160)
    chain = (f"appsrc format={fmt} width=3840 height=2160 ! "
             f"vfmetalconvertscale ! video/x-raw,format={fmt},width=3840,"
             "height=2160 ! appsink")
    _, frames = pool(spec, 8, seed=15)
    want, _ = _card_run("run_batched", frames, 48, False, chain)
    hold(monkeypatch, held)
    got, stats = _card_run("run_batched", frames, 48, chain=chain)
    assert stats.upload_direct == 42 and stats.upload_filled == 6
    assert len(set(got[:8])) == 8 and len(got) == len(want) == 48
    for i, (a, b) in enumerate(zip(got, want)):
        assert a == b, f"frame {i}"


@pytest.mark.card
def test_a_fresh_array_per_frame_stays_on_the_fill_path(card, tmp_path):
    spec = FrameSpec(VideoFormat.NV12, 640, 360)
    _, frames = pool(spec, 6, seed=12)
    path = tmp_path / "in.nv12"
    path.write_bytes(b"".join(row_bytes(f, spec).tobytes() for f in frames))
    pipe = parse_pipeline(
        f"rawvideosrc location={path} format=NV12 width=640 height=360 ! "
        "vfmetalvideofilter brightness=0.1 ! appsink", device="cuda")
    pipe.run_batched(6, batch_size=3)
    assert (pipe.stats.upload_direct, pipe.stats.upload_filled) == (0, 6)
    gc.collect()
    assert len(pipe._host_memory._roots) == 0


@pytest.mark.card
def test_two_rates_of_fresh_arrays_stay_on_the_fill_path(card, tmp_path):
    """A 30 fps file source beside a 60 fps one: the output clock picks
    each of its frames for two frames of a batch, one sighting."""
    paths = []
    for k, (w, h) in enumerate(((640, 360), (320, 180))):
        _, frames = pool(FrameSpec(VideoFormat.NV12, w, h), 12, seed=20 + k)
        paths.append(tmp_path / f"in{k}.nv12")
        paths[-1].write_bytes(b"".join(
            row_bytes(f, FrameSpec(VideoFormat.NV12, w, h)).tobytes()
            for f in frames))
    pipe = parse_pipeline(
        "vfmetalcompositor name=c sink_1::xpos=64 ! video/x-raw,format=BGRA,"
        "width=640,height=360 ! appsink "
        f"rawvideosrc location={paths[0]} format=NV12 width=640 height=360 "
        "! video/x-raw,framerate=60/1 ! c.sink_0 "
        f"rawvideosrc location={paths[1]} format=NV12 width=320 height=180 "
        "! video/x-raw,framerate=30/1 ! c.sink_1", device="cuda")
    pipe.run_batched(12, batch_size=4)
    assert (pipe.stats.upload_direct, pipe.stats.upload_filled) == (0, 24)
    assert pipe._host_memory._held == {}
    gc.collect()
    assert len(pipe._host_memory._roots) == 0


@pytest.mark.card
def test_memory_the_caller_pinned_on_the_card(card):
    """A pool the caller registered itself, and torch's own pinned memory
    (``cudaHostAlloc``, which CUDA refuses to register again), are used as
    they are, never registered nor unregistered, and leave no error behind
    for torch's next launch check."""
    rt = torch.cuda.cudart()
    layout = HostLayout(NV12)
    root, frames = pool(NV12, 3, seed=14)
    assert int(rt.cudaHostRegister(root.ctypes.data, root.nbytes, 0)) == 0
    reg = HostRegistry("cuda")
    out = torch.zeros((3, layout.nbytes), dtype=torch.uint8, device="cuda")
    assert layout.upload_into(frames, out, registry=reg) == (0, 0)
    out.zero_()
    assert layout.upload_into(frames, out, registry=reg) == (3, 0)
    assert torch.equal(out.cpu(), torch.from_numpy(root).view(3, -1))
    assert reg._held == {}  # borrowed
    reg.release()
    assert int(rt.cudaHostUnregister(root.ctypes.data)) == 0  # still ours

    pinned = torch.zeros((3, layout.nbytes), dtype=torch.uint8,
                         pin_memory=True)
    pinned.copy_(torch.from_numpy(root).view(3, -1))
    host = pinned.numpy()
    frames = [{"y": row[:128].reshape(8, 16), "uv": row[128:].reshape(4, 16)}
              for row in host]
    out.zero_()
    assert layout.upload_into(frames, out, registry=reg) == (0, 0)
    assert layout.upload_into(frames, out, registry=reg) == (3, 0)
    assert torch.equal(out.cpu(), pinned) and reg._held == {}
    assert (torch.ones(4, device="cuda") + 1).sum().item() == 8
    reg.release()


@pytest.mark.card
def test_registrations_are_undone_when_the_pipeline_is_freed(card):
    spec = FrameSpec(VideoFormat.NV12, 640, 360)
    root, frames = pool(spec, 4, seed=13)
    pipe = parse_pipeline(
        "appsrc format=NV12 width=640 height=360 ! vfmetalvideofilter "
        "brightness=0.1 ! fakesink", device="cuda")
    for k in range(8):
        pipe["appsrc0"].push(frames[k % 4])
    pipe["appsrc0"].end_of_stream()
    pipe.run_batched(8, batch_size=4)
    assert pipe.stats.upload_direct == 4
    assert [id(r) for r in pipe._host_memory._held.values()] == [id(root)]
    del pipe
    gc.collect()
    rt = torch.cuda.cudart()
    assert int(rt.cudaHostRegister(root.ctypes.data, root.nbytes, 0)) == 0
    assert int(rt.cudaHostUnregister(root.ctypes.data)) == 0


# -- the batch readback on a stream of its own, on the card ---------------------

FRAMES = 48  # 8 batches of 6
CONFIG5 = Path(__file__).parents[1] / "vfbench/configs/compositor_4k.json"


def compositor(tmp_path):
    """BASELINE config 5's launch with an appsink, and a pool of 8 frames a
    source -> (launch, {source: frames})."""
    cfg = json.loads(CONFIG5.read_text())
    ref = cfg["reference"]
    png = inputs.write_png(tmp_path / "overlay.png",
                           inputs.overlay_image(ref["overlay"]))
    desc = cfg["launch"].format(fps="30/1", png=png).replace(
        "vfbenchsink name=out", "appsink name=out")
    pools = {name: pool(FrameSpec(VideoFormat(s["format"]), s["width"],
                                  s["height"]), 8, seed=40 + k)[1]
             for k, (name, s) in enumerate(sorted(ref["sources"].items()))}
    return desc, pools


@pytest.mark.card
@pytest.mark.parametrize("held", ["readbacks", "steps", "step3",
                                  "readbacks eager"])
@pytest.mark.parametrize("config", ["convert_filter", "compositor"])
def test_the_batch_readback_stream_on_the_card(card, monkeypatch, tmp_path,
                                               config, held):
    if config == "compositor":
        desc, frames = compositor(tmp_path)
    else:
        desc = CHAIN
        frames = pool(FrameSpec(VideoFormat.NV12, 3840, 2160), 8, seed=41)[1]
    want, _ = _card_run("run_batched", frames, FRAMES, False, desc)
    what, _, eager = held.partition(" ")
    hold(monkeypatch, what)
    got, stats = _card_run("run_batched", frames, FRAMES, not eager, desc)
    assert len(set(want[:8])) == 8  # every pool frame differs
    assert len(got) == len(want) == FRAMES
    wrong = [i for i, (a, b) in enumerate(zip(got, want)) if a != b]
    assert not wrong, f"{len(wrong)} of {FRAMES} frames wrong: {wrong}"
    assert stats.readback_async == FRAMES


# -- the upload of a source's region, on the card --------------------------------

CULLED = 1920 * 1080 * 4  # s0's bytes under the opaque 1080p inset


def _poison_rows(monkeypatch, value: int) -> None:
    """Every upload into fixed rows first fills them with `value` on the
    copy stream, so a byte its region leaves out holds the poison."""
    real = HostLayout.upload_into

    def poisoned(self, frames, out, *a, **k):
        out.fill_(value)
        return real(self, frames, out, *a, **k)

    monkeypatch.setattr(HostLayout, "upload_into", poisoned)


def _sliding_run(desc, pools, direct):
    """`run` over 16 frames of config 5 with s0 at 5 fps and the inset
    sliding 1920 -> 0 -> 1920 over 12 frames -> (the sink's frames as bytes,
    the stats); `direct` False: the eager whole-frame reference."""
    pipe = parse_pipeline(desc.replace("framerate=30/1 ! c.sink_0",
                                       "framerate=5/1 ! c.sink_0"),
                          device="cuda")
    for name, pooled in pools.items():
        for k in range(16):
            pipe[name].push(pooled[k % len(pooled)])
        pipe[name].end_of_stream()
    pipe["c"].control("sink_1::xpos",
                      [320 * abs(6 - k % 12) for k in range(16)])
    if not direct:
        pipe._host_memory = None
        pipe.compiled.graphs = False
    pipe.run(16)
    return [np.ascontiguousarray(f).tobytes()
            for f in pipe.sinks[0].frames], pipe.stats


@pytest.mark.card
@pytest.mark.parametrize("poison", [0xFF, 0x00])
def test_config5_uploads_its_region_on_the_card(card, monkeypatch, tmp_path,
                                                poison):
    """`run_batched` over recurring pools, 48 frames in batches of 6, with
    every upload poisoning its rows first: byte-equal to the eager fill
    run, and s0's top right quadrant never copied once s0 goes
    straight."""
    desc, frames = compositor(tmp_path)
    want, _ = _card_run("run_batched", frames, FRAMES, False, desc)
    _poison_rows(monkeypatch, poison)
    got, stats = _card_run("run_batched", frames, FRAMES, True, desc)
    wrong = [i for i, (a, b) in enumerate(zip(got, want)) if a != b]
    assert len(got) == len(want) == FRAMES
    assert not wrong, f"{len(wrong)} of {FRAMES} frames wrong: {wrong}"
    assert stats.upload_direct == 4 * (FRAMES - 6)
    assert stats.upload_culled == (FRAMES - 6) * CULLED


@pytest.mark.card
@pytest.mark.parametrize("memo", ["as built", "ignores the region"])
def test_a_sliding_inset_on_the_card(card, monkeypatch, tmp_path, memo):
    """The inset slides over s0 while s0 keeps its buffer for 6 frames: a
    row whose region grows is uploaded again.  With the memo's region test
    made to always pass, frames 7 and 13 (the first after s0's culled
    uploads at frames 6 and 12) read poison."""
    desc, frames = compositor(tmp_path)
    want, _ = _sliding_run(desc, frames, False)
    _poison_rows(monkeypatch, 0xFF)
    if memo != "as built":
        monkeypatch.setattr(region, "contains", lambda held, need: True)
    got, stats = _sliding_run(desc, frames, True)
    wrong = [i for i, (a, b) in enumerate(zip(got, want)) if a != b]
    assert len(got) == len(want) == 16 and stats.upload_culled > 0
    if memo == "as built":
        assert not wrong, f"{len(wrong)} of 16 frames wrong: {wrong}"
    else:
        assert {7, 13} <= set(wrong), wrong
