"""The upload of a source's region (``runtime/compiled.py``
`CompiledStep.upload_rows`, ``core/region.py``, ``core/frame.py``
`HostLayout.spans`): a frame copied straight from a source's registered
memory carries only the pixels its compositor's draw table reads.

On the CPU the pipeline's registry is a fake one (``FakeCuda``), so the
frames after a source's first upload go straight, and every upload first
poisons the rows it writes (0xFF, then 0x00): a byte that the region leaves
out keeps the poison, and the frames of `run_batched` (and of `run`, for the
sliding inset) must still equal, byte for byte, those of the eager
`step_sources`, which uploads every frame whole.  Each case also checks the
regions the rows hold and `upload_culled`.  The cases, on BASELINE config
5's geometry at a twentieth of its size: config 5 (the opaque NV12 inset
hides the 4K pad's top right quadrant; the other sources whole); the inset
at alpha 0.99, in BGRA (a per-pixel alpha) or with ``add``: nothing culled;
an NV12 pad under an inset at an odd column: the chroma taps' margin kept,
and through a sharpening filter its reach as well; a pad the inset hides wholly: no byte; a source through a tee, or sampled
at another size: whole.  The inset sliding over the 4K pad as
``vfbench/traffic/live_pip.json`` slides it, under a source at a sixth of
the output's rate, so a row keeps its buffer while the region it needs
grows: equal to the eager frames, and red where the memo ignores the
regions.
"""

import numpy as np
import pytest
import torch

from tests.test_torch_upload_direct import pool, registry
from tpuvf_torch.cli.launch import parse_pipeline
from tpuvf_torch.core import region
from tpuvf_torch.core.formats import VideoFormat
from tpuvf_torch.core.frame import HostLayout
from tpuvf_torch.core.spec import FrameSpec
from tpuvf_torch.io import png

torch.set_num_threads(1)

# BASELINE config 5 at a twentieth: 192x108 BGRA, 96x54 NV12 at (96, 0),
# 64x36 BGRA alpha 0.7 at (0, 54), 64x36 NV12 add at (96, 54)
PADS = ("sink_1::xpos=96 sink_2::ypos=54 sink_2::alpha=0.7 sink_3::xpos=96 "
        "sink_3::ypos=54 sink_3::operator=add")
SOURCES = {"s0": ("BGRA", 192, 108), "s1": ("NV12", 96, 54),
           "s2": ("BGRA", 64, 36), "s3": ("NV12", 64, 36)}
TOP_RIGHT = ((0, 54, 0, 96), (54, 108, 0, 192))  # s0 without (96, 0)-(192, 54)

NV12_S0 = {"s0": ("NV12", 192, 108)}
# case -> (compositor properties, {source: (format, w, h)} changed, s0's
# way to its pad, s0's expected region)
CASES = {
    "config5": ("", {}, "{pad}", TOP_RIGHT),
    "alpha 0.99": ("sink_1::alpha=0.99", {}, "{pad}", None),
    "bgra inset": ("", {"s1": ("BGRA", 96, 54)}, "{pad}", None),
    "add inset": ("sink_1::operator=add", {}, "{pad}", None),
    # the pad's chroma taps: 2 pixels, rounded out to even
    "chroma margin": ("sink_1::xpos=97", NV12_S0, "{pad}",
                      ((0, 52, 0, 100), (52, 108, 0, 192))),
    # then the filter's: the 9-tap blur's 4 and its chroma taps' 2, and 2
    # more for its YUV input
    "through a filter": ("", NV12_S0, "vfmetalvideofilter brightness=0.1 "
                         "sharpness=0.5 ! {pad}",
                         ((0, 44, 0, 106), (44, 108, 0, 192))),
    "covered": ("sink_1::xpos=0", {"s0": ("BGRA", 96, 54)}, "{pad}", ()),
    "tee": ("sink_4::xpos=150 sink_4::alpha=0.5", {},
            "tee name=t ! {pad} t. ! queue ! c.sink_4", None),
    "scaled": ("sink_0::width=192 sink_0::height=108",
               {"s0": ("BGRA", 96, 54)}, "{pad}", None),
}


def launch(props: str, sources: dict, via: str, png_path, rates=None):
    """Config 5's launch at a twentieth with an appsink, s0 reaching its pad
    through `via`."""
    rates = rates or {}
    parts = [f"vfmetalcompositor name=c background=black {PADS} {props} ! "
             "video/x-raw,format=BGRA,width=192,height=108 ! "
             f"vfmetaloverlay location={png_path} x=6 y=6 ! appsink name=out"]
    for name, (fmt, w, h) in sources.items():
        pad = name.replace("s", "c.sink_")
        rate = rates.get(name, "30/1")
        way = via.format(pad=pad) if name == "s0" else pad
        parts.append(f"appsrc name={name} format={fmt} width={w} height={h} "
                     f"! video/x-raw,framerate={rate} ! {way}")
    return " ".join(parts)


@pytest.fixture
def overlay(tmp_path):
    image = np.random.default_rng(9).integers(0, 256, (12, 12, 4),
                                              dtype=np.uint8)
    path = str(tmp_path / "ov.png")
    png.write(path, image)
    return path


def fed(desc: str, sources: dict, counts: dict):
    """The pipeline with each source's pool (one root a source, so the fake
    registry admits it at its second upload) pushed."""
    pipe = parse_pipeline(desc, device="cpu")
    for seed, (name, (fmt, w, h)) in enumerate(sources.items()):
        _, frames = pool(FrameSpec(VideoFormat(fmt), w, h), counts[name],
                         seed=70 + seed)
        for frame in frames:
            pipe[name].push(frame)
        pipe[name].end_of_stream()
    pipe.negotiate()
    pipe.build()
    return pipe


def poisoned(monkeypatch, value: int):
    """Every upload into fixed rows first fills them with `value`, and
    takes the fake registry -> its record."""
    reg, fake = registry()
    real = HostLayout.upload_into

    def upload_into(self, frames, out, edge=None, index=None, registry=None,
                    spans=None):
        out.fill_(value)
        return real(self, frames, out, edge, index, reg, spans)

    monkeypatch.setattr(HostLayout, "upload_into", upload_into)
    return fake


def eager_frames(pipe, n: int) -> list:
    """The eager `step_sources` over frames 0 .. n-1, each frame's buffers
    picked, uploaded whole and its controllers synced as `run` does -> the
    sink's bytes a frame."""
    out_fps, infos = pipe._clock()
    state, frames = pipe.state, []
    for k in range(n):
        for el in pipe._controlled():
            el.sync_frame(k)
        inputs = {}
        for name, (j, meta) in pipe._select_buffers(k, out_fps,
                                                   infos).items():
            src = pipe[name]
            host = src.generate(j, pipe._source_spec(src))
            inputs[name] = dict(pipe.upload_sources({name: host})[name],
                                __meta__=meta)
        planes, state = pipe.step_sources(inputs, state, pipe.params(), k)
        frames.append(b"".join(p.numpy().tobytes()
                               for _, _, pieces in pipe._payloads(planes, k)
                               for p in pieces))
    return frames


def sink_frames(pipe) -> list:
    return [np.ascontiguousarray(f).tobytes() for f in pipe["out"].frames]


@pytest.mark.parametrize("poison", [0xFF, 0x00])
@pytest.mark.parametrize("case", list(CASES))
def test_culled_uploads_equal_the_eager_frames(monkeypatch, overlay, case,
                                               poison):
    """`run_batched`, 8 frames in batches of 4: the first batch fills every
    row whole, the second goes straight and copies each source's
    region."""
    props, changed, via, want_s0 = CASES[case]
    sources = dict(SOURCES, **changed)
    desc = launch(props, sources, via, overlay)
    counts = dict.fromkeys(sources, 8)
    want = eager_frames(fed(desc, sources, counts), 8)
    fake = poisoned(monkeypatch, poison)
    pipe = fed(desc, sources, counts)
    pipe.run_batched(8, batch_size=4)
    assert sink_frames(pipe) == want
    assert len(fake.registered) == len(sources)
    assert (pipe.stats.upload_direct, pipe.stats.upload_filled) == (
        4 * len(sources), 4 * len(sources))
    compiled, culled = pipe.compiled, 0
    for name, (fmt, w, h) in sources.items():
        want_region = want_s0 if name == "s0" else None
        assert compiled._uploaded[(4, name)] == (
            [4, 5, 6, 7], [want_region] * 4), name
        layout = HostLayout(FrameSpec(VideoFormat(fmt), w, h))
        spans = layout.spans(want_region)
        if spans is not None:
            culled += 4 * (layout.nbytes - sum((r1 - r0) * (b1 - b0)
                                               for _, r0, r1, b0, b1 in spans))
    assert pipe.stats.upload_culled == culled
    assert (culled > 0) == (want_s0 is not None), case


def _sliding(overlay, counts):
    """Config 5 at a twentieth, s0 at 5 fps beside the others' 30, the
    inset sliding 96 -> 0 -> 96 over 12 frames (``live_pip.json``'s
    triangle): s0's buffer changes at frames 6 and 12, where the inset
    stands at 0 and 96 and the next frame's region is the whole pad."""
    desc = launch("", SOURCES, "{pad}", overlay, rates={"s0": "5/1"})
    pipe = fed(desc, SOURCES, counts)
    pipe["c"].control("sink_1::xpos",
                      [16 * abs(6 - k % 12) for k in range(16)])
    return pipe


@pytest.mark.parametrize("memo", ["as built", "ignores the region"])
@pytest.mark.parametrize("poison", [0xFF, 0x00])
def test_a_sliding_inset_uploads_what_it_uncovers(monkeypatch, overlay,
                                                  poison, memo):
    """`run` over 16 frames: a row that holds its buffer with a smaller
    region is uploaded again.  With the memo's region test made to always
    pass, the frames after a buffer's first culled upload read poison."""
    counts = {"s0": 3, "s1": 16, "s2": 16, "s3": 16}
    want = eager_frames(_sliding(overlay, counts), 16)
    poisoned(monkeypatch, poison)
    if memo != "as built":
        monkeypatch.setattr(region, "contains", lambda held, need: True)
    pipe = _sliding(overlay, counts)
    pipe.run(16)
    got = sink_frames(pipe)
    wrong = [k for k, (a, b) in enumerate(zip(got, want)) if a != b]
    assert len(got) == 16 and pipe.stats.upload_culled > 0
    if memo == "as built":
        assert wrong == []
    else:
        assert {7, 13} <= set(wrong), wrong


# -- the region's algebra, against pixel masks -----------------------------------


def _mask(reg, w: int, h: int) -> np.ndarray:
    m = np.zeros((h, w), bool)
    if reg is None:
        m[:] = True
    for y0, y1, x0, x1 in reg or ():
        m[y0:y1, x0:x1] = True
    return m


def _row_hulls(m: np.ndarray) -> np.ndarray:
    """Each row's run from its first set pixel to its last."""
    out = np.zeros_like(m)
    for y, row in enumerate(m):
        xs = np.flatnonzero(row)
        if xs.size:
            out[y, xs[0]:xs[-1] + 1] = True
    return out


@pytest.mark.parametrize("seed", range(6))
def test_region_algebra_against_pixel_masks(seed):
    """`uncovered` is each row's hull of the rect's uncovered pixels;
    `widen` holds the region's dilation by its reach, on the chroma grid
    where asked; `contains` is the masks' inclusion."""
    rng = np.random.default_rng(seed)
    w, h = 40, 30

    def rect():
        x0, y0 = rng.integers(-5, 35, 2)
        return (int(x0), int(y0), int(x0 + rng.integers(1, 30)),
                int(y0 + rng.integers(1, 30)))

    regions = []
    for _ in range(20):
        x0, y0, x1, y1 = rect()
        pad = (min(max(x0, 0), w), min(max(y0, 0), h), min(x1, w),
               min(y1, h))  # clamped as the prepare pass clamps
        covers = [rect() for _ in range(rng.integers(0, 4))]
        got = region.uncovered(pad, covers)
        want = np.zeros((h, w), bool)
        want[pad[1]:pad[3], pad[0]:pad[2]] = True
        for c in covers:
            want[max(c[1], 0):max(c[3], 0), max(c[0], 0):max(c[2], 0)] = False
        assert np.array_equal(_mask(got, w, h), _row_hulls(want))
        assert all(b[0] < b[1] <= c[0] for b, c in zip(got, got[1:]))
        reach, even = int(rng.integers(0, 4)), bool(rng.integers(0, 2))
        wide = region.widen(got, reach, w, h, even)
        grown = _mask(wide, w, h)
        for y, x in zip(*np.nonzero(_mask(got, w, h))):
            assert grown[max(y - reach, 0):y + reach + 1,
                         max(x - reach, 0):x + reach + 1].all()
        if even and wide is not None:
            assert all(v % 2 == 0 or v in (w, h) for b in wide for v in b)
        regions += [got, wide]
    for held in regions + [None, ()]:
        for need in regions[:10] + [None, ()]:
            inside = not (_mask(need, w, h) & ~_mask(held, w, h)).any()
            assert region.contains(held, need) == inside
