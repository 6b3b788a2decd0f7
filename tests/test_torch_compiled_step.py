"""The compiled step (`runtime/compiled.py`) on the CPU: `Pipeline.run` and
`run_batched` step every frame through `CompiledStep`, whose body runs
eagerly here over the same fixed buffers the card's graphs replay (the
capture itself needs the card: chip_smoke.py phase (n)).

- Every chain shape of chip_smoke's (a)-(h'') at a narrow size: the frames
  of `Pipeline.run` equal, byte for byte, those of a loop over the eager
  `step_sources` that picks the buffers as `run` does.
- A (c)-shaped chain is within tpuvf's contract of tpuvf itself (<= 1 LSB,
  ROADMAP's parity contract) under TPUVF_NO_SPLIT_LINKS=1 and
  TPUVF_LUT_F32=1, as tests/test_torch_lut.py runs it.
- The key: a brightness ramp and a pad's xpos/alpha ramp (off the canvas,
  alpha 0, an opaque pad obscuring the other and the background) keep one
  key; alternating TFF takes two; greedy-H's first frame and its steady
  state at most two; a rebuilding write drops the keys and keeps the carry.
- The state write-back across `run`, `run_batched` and `reset()`, and the
  deinterlace alias case (an RGB input is its own texture).
- K4's table route: the plain fold of the compositor's draw table equals
  the per-frame `Draw`-list fold of the former host prepare pass on seeded
  random geometry, and a band's rows equal the frame's.
- `_locate_failure`'s twin: a fault the compiled step cannot name is
  located by the frame's eager re-run.

Everything here is exact, except the tpuvf comparison (<= 1 LSB).
"""

import numpy as np
import pytest
import torch

from tests.test_torch_elements import diff_stats
from tests.test_torch_lut import grade, write_cube
from tpuvf.cli.launch import parse_pipeline as tpuvf_parse
from tpuvf_torch.cli.launch import parse_pipeline as port_parse
from tpuvf_torch.core.formats import VideoFormat as PFormat
from tpuvf_torch.core.spec import FrameSpec as PSpec
from tpuvf_torch.elements.compositor import (
    DRAW_TABLE,
    Compositor,
    _plan_sampler,
)
from tpuvf_torch.io import png
from tpuvf_torch.kernels.composite import (
    OP_ADD,
    OP_OVER,
    OP_SOURCE,
    Background,
    Draw,
    Source,
    background_colors,
    composite_fold_plain,
    fold_draws_plain,
    pack_draws,
)
from tpuvf_torch.runtime.observability import PipelineError
from tpuvf_torch.runtime.staging import read_params

torch.set_num_threads(1)

BCS = "vfmetalvideofilter brightness=0.05 contrast=1.1 saturation=1.2"
CONFIG3 = ("vfmetalvideofilter brightness=0.1 contrast=1.2 saturation=1.3 "
           "chroma-key-enabled=true")
FRAMES = 4


def nv12(n, w, h, seed):
    rng = np.random.default_rng(seed)
    return [{"y": rng.integers(0, 256, (h, w), dtype=np.uint8),
             "uv": rng.integers(0, 256, (h // 2, w), dtype=np.uint8)}
            for _ in range(n)]


def i420(n, w, h, seed):
    rng = np.random.default_rng(seed)
    return [{"y": rng.integers(0, 256, (h, w), dtype=np.uint8),
             "u": rng.integers(0, 256, (h // 2, w // 2), dtype=np.uint8),
             "v": rng.integers(0, 256, (h // 2, w // 2), dtype=np.uint8)}
            for _ in range(n)]


def rgba(n, w, h, seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, (h, w, 4), dtype=np.uint8)
            for _ in range(n)]


def fed(desc, feeds, tffs=None, parse=port_parse, **kw):
    """The pipeline with {appsrc: frames} pushed (each with its TFF flag
    from {appsrc: [bool]} where given), negotiated and built."""
    pipe = parse(desc, **kw)
    for name, frames in feeds.items():
        flags = (tffs or {}).get(name) or [None] * len(frames)
        for f, tff in zip(frames, flags):
            pipe[name].push(f, tff=tff)
        pipe[name].end_of_stream()
    pipe.negotiate()
    pipe.build()
    return pipe


def payload_bytes(payload) -> bytes:
    if isinstance(payload, dict):
        return b"".join(np.ascontiguousarray(v).tobytes()
                        for v in payload.values())
    return np.ascontiguousarray(payload).tobytes()


def run_frames(pipe, n=None, sink="appsink0") -> list:
    pipe.run(n)
    return [payload_bytes(f) for f in pipe[sink].frames]


def eager_frames(pipe, n, state=None) -> list:
    """A loop over the eager `step_sources`, each frame's buffers picked
    and its controlled properties synced as `run` does -> the only sink's
    host payload bytes per frame."""
    out_fps, infos = pipe._clock()
    state = pipe.state if state is None else state
    frames = []
    for i in range(n):
        for el in pipe._controlled():
            el.sync_frame(i)
        inputs = {}
        for name, (j, meta) in pipe._select_buffers(i, out_fps,
                                                   infos).items():
            src = pipe[name]
            host = src.generate(j, pipe._source_spec(src))
            inputs[name] = dict(pipe.upload_sources({name: host})[name],
                                __meta__=meta)
        out, state = pipe.step_sources(inputs, state, pipe.params(), i)
        frames.append(b"".join(p.numpy().tobytes()
                               for _, _, pieces in pipe._payloads(out, i)
                               for p in pieces))
    pipe.state = state
    return frames


@pytest.fixture(scope="module")
def assets(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("compiled")
    image = np.random.default_rng(8).integers(0, 256, (8, 8, 4),
                                              dtype=np.uint8)
    image[..., 3] = 128
    red = str(tmp / "ov.png")
    png.write(red, image)
    return {"lut9": write_cube(tmp / "g9.cube", grade(9, 3)),
            "lut5": write_cube(tmp / "g5.cube", grade(5, 17)), "png": red}


COMPOSITE5 = (
    "vfmetalcompositor name=c background=black sink_1::xpos=32 "
    "sink_2::ypos=24 sink_2::alpha=0.7 sink_3::xpos=32 sink_3::ypos=24 "
    "sink_3::operator=add ! video/x-raw,format={fmt},width=64,height=48 "
    "! vfmetaloverlay location={png} x=4 y=4 ! appsink "
    "appsrc name=s0 format=BGRA width=64 height=48 ! c.sink_0 "
    "appsrc name=s1 format=NV12 width=32 height=24 ! c.sink_1 "
    "appsrc name=s2 format=BGRA width=24 height=16 ! c.sink_2 "
    "appsrc name=s3 format=NV12 width=24 height=16 ! c.sink_3")
COMPOSITE5_FEEDS = {"s0": rgba(FRAMES, 64, 48, 50),
                    "s1": nv12(FRAMES, 32, 24, 51),
                    "s2": rgba(FRAMES, 24, 16, 52),
                    "s3": nv12(FRAMES, 24, 16, 53)}
CHAIN_F = ("vfmetalcompositor name=c background=checker sink_0::width=40 "
           "sink_0::height=24 sink_0::xpos=-6 sink_0::ypos=3 "
           "sink_1::xpos=30 sink_1::ypos=12 sink_1::width=26 "
           "sink_1::height=20 sink_1::sizing-policy=keep-aspect-ratio "
           "sink_1::alpha=0.8 ! video/x-raw,format=NV12,width=64,height=36 "
           "! appsink appsrc name=s0 format=NV12 width=64 height=36 ! "
           "c.sink_0 appsrc name=s1 format=BGRA width=40 height=24 ! c.sink_1")
CHAIN_F_FEEDS = {"s0": nv12(FRAMES, 64, 36, 60), "s1": rgba(FRAMES, 40, 24, 61)}

# chip_smoke's chains (a)-(h'') at narrow sizes:
# (label, description, {appsrc: frames}, {appsrc: [tff]} or None)
CHAINS = [
    ("a", f"appsrc format=NV12 width=64 height=48 ! vfmetalconvertscale ! "
          f"video/x-raw,format=BGRA,width=32,height=24 ! {BCS} ! appsink",
     {"appsrc0": nv12(FRAMES, 64, 48, 1)}, None),
    ("b", f"appsrc format=NV12 width=64 height=48 ! vfmetalconvertscale ! "
          f"video/x-raw,format=BGRA,width=64,height=48 ! {BCS} ! appsink",
     {"appsrc0": nv12(FRAMES, 64, 48, 2)}, None),
    ("c-nv12", f"appsrc format=NV12 width=64 height=48 ! {CONFIG3} "
               f"lut-file={{lut9}} ! appsink",
     {"appsrc0": nv12(FRAMES, 64, 48, 3)}, None),
    ("c-bgra", f"appsrc format=NV12 width=64 height=48 ! {CONFIG3} "
               f"lut-file={{lut9}} ! vfmetalconvertscale ! "
               f"video/x-raw,format=BGRA ! appsink",
     {"appsrc0": nv12(FRAMES, 64, 48, 4)}, None),
    ("d", "appsrc format=RGBA width=32 height=24 ! vfmetalvideofilter "
          "lut-file={lut5} contrast=1.1 sharpness=0.5 ! vfmetalconvertscale "
          "! video/x-raw,format=BGRA ! appsink",
     {"appsrc0": rgba(FRAMES, 32, 24, 5)}, None),
    ("e", COMPOSITE5.replace("{fmt}", "BGRA"), COMPOSITE5_FEEDS, None),
    ("e-nv12", COMPOSITE5.replace("{fmt}", "NV12"), COMPOSITE5_FEEDS, None),
    ("f", CHAIN_F, CHAIN_F_FEEDS, None),
    ("g", "appsrc format=I420 width=64 height=36 ! video/x-raw,"
          "interlace-mode=interleaved ! vfmetaldeinterlace method=greedyh "
          "motion-threshold=0.3 ! appsink",
     {"appsrc0": i420(FRAMES, 64, 36, 6)}, None),
    ("g-weave", "appsrc format=BGRA width=32 height=24 ! vfmetaldeinterlace "
                "method=weave field-layout=auto ! appsink",
     {"appsrc0": rgba(FRAMES, 32, 24, 7)},
     {"appsrc0": [i % 2 == 0 for i in range(FRAMES)]}),
    ("h", "appsrc format=BGRA width=32 height=24 ! vfmetaltransform "
          "method=clockwise crop-left=4 crop-top=2 ! appsink",
     {"appsrc0": rgba(FRAMES, 32, 24, 8)}, None),
    ("h-ccw", "appsrc format=NV12 width=64 height=36 ! vfmetaltransform "
              "method=counterclockwise crop-right=8 ! appsink",
     {"appsrc0": nv12(FRAMES, 64, 36, 9)}, None),
    ("h-180", "appsrc format=NV12 width=64 height=36 ! vfmetaltransform "
              "method=rotate-180 ! appsink",
     {"appsrc0": nv12(FRAMES, 64, 36, 10)}, None),
]


@pytest.mark.parametrize("label,desc,feeds,tffs", CHAINS,
                         ids=[c[0] for c in CHAINS])
def test_run_equals_the_eager_step(label, desc, feeds, tffs, assets):
    desc = desc.format(**assets)
    pipe = fed(desc, feeds, tffs, device="cpu")
    got = run_frames(pipe)
    want = eager_frames(fed(desc, feeds, tffs, device="cpu"), len(got))
    assert len(got) == FRAMES and got == want, label
    compiled = pipe.compiled
    assert compiled.eager == FRAMES and compiled.batch_captures == 0
    # greedy-H: has_prev False, then True; weave: that, then each TFF
    assert 1 <= compiled.keys <= 3


def test_chain_c_matches_tpuvf(assets, monkeypatch):
    """The compiled body's (c) -> BGRA within tpuvf's contract (module
    doc), as tests/test_torch_lut.py runs the LUT chains."""
    monkeypatch.setenv("TPUVF_NO_SPLIT_LINKS", "1")
    monkeypatch.setenv("TPUVF_LUT_F32", "1")
    _, desc, feeds, _ = next(c for c in CHAINS if c[0] == "c-bgra")
    desc = desc.format(**assets)
    want = fed(desc, feeds, parse=tpuvf_parse)
    want.run()
    got = fed(desc, feeds, device="cpu")
    got.run()
    assert got.compiled.eager == FRAMES
    for g, w in zip(got["appsink0"].frames, want["appsink0"].frames):
        worst, share = diff_stats({"frame": w}, {"frame": g})
        print(f"(c) -> BGRA vs tpuvf: max {worst} LSB, {share:.4%} differ")
        assert worst <= 1


# -- the key -----------------------------------------------------------------

RAMP = [0.05 + 0.02 * i for i in range(16)]


def _brightness_ramp():
    desc = "appsrc format=RGBA width=32 height=24 ! vfmetalvideofilter " \
           "brightness=0.05 ! appsink"
    pipe = fed(desc, {"appsrc0": rgba(1, 32, 24, 11) * 16}, device="cpu")
    pipe["vfmetalvideofilter0"].control("brightness", RAMP)
    return pipe, rgba(1, 32, 24, 11)


def _xpos_ramp():
    """An RGBA pad under an opaque NV12 pad whose xpos and alpha ramp:
    covering the canvas (the RGBA pad and the background obscured), off
    it on both sides, alpha 0, half alpha."""
    desc = ("vfmetalcompositor name=c background=checker sink_1::zorder=1 "
            "! video/x-raw,format=BGRA,width=48,height=32 ! appsink "
            "appsrc name=s0 format=RGBA width=48 height=32 ! c.sink_0 "
            "appsrc name=s1 format=NV12 width=48 height=32 ! c.sink_1")
    pipe = fed(desc, {"s0": rgba(16, 48, 32, 12), "s1": nv12(16, 48, 32, 13)},
               device="cpu")
    comp = pipe["c"]
    comp.control("sink_1::xpos", [0, 10, -100, 200, 5, 0, -47, 47, 3, 0,
                                  -2**31, 2**31 - 1, 16, 0, 1, 0])
    comp.control("sink_1::alpha", [1.0, 1.0, 1.0, 1.0, 0.0, 0.5, 1.0, 1.0,
                                   0.0, 1.0, 1.0, 1.0, 0.25, 1.0, 1.0, 1.0])
    return pipe


def test_brightness_ramp_keeps_one_key_and_follows_the_ramp():
    pipe, frame = _brightness_ramp()
    got = run_frames(pipe, 16)
    assert pipe.compiled.keys == 1 and pipe.compiled.eager == 16
    means = [np.frombuffer(f, np.uint8).reshape(24, 32, 4)[..., :3].mean()
             for f in got]
    assert all(b > a for a, b in zip(means, means[1:]))
    ref, _ = _brightness_ramp()
    assert got == eager_frames(ref, 16)


def test_xpos_ramp_keeps_one_key():
    pipe = _xpos_ramp()
    got = run_frames(pipe, 16)
    assert pipe.compiled.keys == 1
    assert got == eager_frames(_xpos_ramp(), 16)
    assert len(set(got)) > 8  # the pad moved


def test_xpos_ramp_tables_cover_every_case():
    """The ramp's draw tables: the RGBA pad obscured at xpos 0 alpha 1, the
    background then not drawn, the NV12 pad not drawn off the canvas and
    at alpha 0."""
    pipe = _xpos_ramp()
    comp = pipe["c"]
    metas = {"s0": {"active": 1.0, "eos": 0.0},
             "s1": {"active": 1.0, "eos": 0.0}}
    rows = {}
    for i in (0, 2, 3, 4, 5):
        comp.sync_frame(i)
        reads = {comp.name: comp.traced_values("cpu")}
        t = pipe._frame_tables(reads, metas)
        rows[i] = (int(t[0]), int(t[9]), int(t[18]))  # bg, drawn 0, drawn 1
    assert rows[0] == (0, 0, 1)  # covered: pad 0 and background obscured
    assert rows[2] == (1, 1, 0) and rows[3] == (1, 1, 0)  # off the canvas
    assert rows[4] == (1, 1, 0)  # alpha 0
    assert rows[5] == (1, 1, 1)  # half alpha: obscures nothing


@pytest.mark.parametrize("method,keys", [("bob", 2), ("weave", 3)])
def test_alternating_tff_takes_two_keys(method, keys):
    """Each TFF value is one key; weave's first frame (no previous frame)
    is one more."""
    _, desc, feeds, tffs = next(c for c in CHAINS if c[0] == "g-weave")
    pipe = fed(desc.replace("weave", method), feeds, tffs, device="cpu")
    pipe.run()
    assert pipe.compiled.keys == keys
    flags = {k[1][0][1] for k in pipe.compiled._after}  # the frame keys
    assert len(flags) == 2


def test_greedyh_first_frame_then_steady_state():
    _, desc, feeds, _ = next(c for c in CHAINS if c[0] == "g")
    pipe = fed(desc, feeds, device="cpu")
    pipe.run()
    assert pipe.compiled.keys == 2  # has_prev False, then True


def test_rebuild_drops_the_keys_and_keeps_the_carry():
    _, desc, feeds, _ = next(c for c in CHAINS if c[0] == "g")
    desc = desc.replace("! appsink", "! vfmetalvideofilter brightness=0.1 "
                                     "! appsink")
    pipe = fed(desc, feeds, device="cpu")
    pipe.run(2)
    old = pipe.compiled
    carried = {k: dict(v) for k, v in pipe.state.items()}
    carried["vfmetaldeinterlace0"]["prev"] = \
        pipe.state["vfmetaldeinterlace0"]["prev"].clone()
    pipe["vfmetalvideofilter0"].set_property("hue", 0.3)  # a static gate
    got = run_frames(pipe, 2)[2:]
    assert pipe.compiled is not old and old.keys == 2
    assert pipe.compiled.keys == 1  # has_prev carried: True from frame 0
    ref = fed(desc, feeds, device="cpu")
    ref["vfmetalvideofilter0"].set_property("hue", 0.3)
    ref.build()
    carried["vfmetalvideofilter0"] = {"frame_index": torch.tensor(2)}
    assert got == eager_frames(ref, 2, state=carried)


# -- the state write-back ----------------------------------------------------


def test_run_then_run_batched_then_reset():
    _, desc, feeds, _ = next(c for c in CHAINS if c[0] == "g")
    pipe = fed(desc, feeds, device="cpu")
    pipe.run()
    pipe.run_batched(FRAMES, batch_size=2)
    got = [payload_bytes(f) for f in pipe["appsink0"].frames]
    ref = fed(desc, feeds, device="cpu")
    want = eager_frames(ref, FRAMES)
    want += eager_frames(ref, FRAMES)  # the clock restarts, the carry not
    assert got == want
    assert pipe.compiled.keys == 2
    pipe.reset()
    pipe["appsink0"].frames.clear()
    fresh = fed(desc, feeds, device="cpu")
    assert run_frames(pipe, 2) == eager_frames(fresh, 2)


def test_the_texture_does_not_alias_the_fixed_input():
    """vfdeinterlace carries an RGB input's planes as its texture: the
    fixed input buffer must not become `prev`."""
    frames = rgba(2, 32, 24, 14)
    pipe = fed("appsrc format=RGBA width=32 height=24 ! vfmetaldeinterlace "
               "method=weave ! appsink", {"appsrc0": frames}, device="cpu")
    pipe.run(1)
    compiled = pipe.compiled
    prev = pipe.state["vfmetaldeinterlace0"]["prev"]
    fixed = compiled.batch_inputs(1)["appsrc0"]
    lo, hi = fixed.data_ptr(), fixed.data_ptr() + fixed.numel()
    assert not lo <= prev.data_ptr() < hi
    assert torch.equal(prev, torch.from_numpy(frames[0]).permute(2, 0, 1))
    compiled.upload_rows([{"appsrc0": (1, {})}])  # the next upload
    assert torch.equal(prev, torch.from_numpy(frames[0]).permute(2, 0, 1))


# -- K4's table route ------------------------------------------------------------


def _old_prepare(pads, out_w, out_h):
    """The compositor's former per-frame host pass, transcribed: each pad
    (src, x, y, alpha, op, opaque, buffered) -> (bg_drawn, [Draw]) with
    only the drawn pads."""
    prep = []
    for src, x, y, alpha, op, opaque, buffered in pads:
        h, w = src.shape[1], src.shape[2]
        rect = (min(max(x, 0), out_w), min(max(y, 0), out_h),
                min(max(x + w, 0), out_w), min(max(y + h, 0), out_h))
        nonempty = rect[2] > rect[0] and rect[3] > rect[1]
        prep.append(dict(src=src, x=x, y=y, w=w, h=h, alpha=alpha, op=op,
                         rect=rect,
                         visible=buffered and alpha > 0 and nonempty,
                         obscuring=opaque and buffered and alpha >= 1.0))

    def contains(q, x0, y0, x1, y1):
        return (q["x"] <= x0 and q["y"] <= y0 and q["x"] + q["w"] >= x1
                and q["y"] + q["h"] >= y1)

    bg_drawn = not any(p["obscuring"] and p["visible"]
                       and contains(p, 0, 0, out_w, out_h) for p in prep)
    draws = []
    for i, p in enumerate(prep):
        if not p["visible"] or any(q["obscuring"] and contains(q, *p["rect"])
                                   for q in prep[i + 1:]):
            continue
        draws.append(Draw(p["src"], p["x"], p["y"], p["rect"], p["op"],
                          p["alpha"]))
    return bg_drawn, draws


@pytest.mark.parametrize("seed", range(12))
def test_table_fold_equals_the_draw_list_fold(seed):
    rng = np.random.default_rng(seed)
    out_w, out_h = int(rng.integers(8, 40)), int(rng.integers(8, 30))
    mode = ("checker", "black", "transparent")[seed % 3]
    comp = Compositor(name="c", background=(0, 1, 3)[seed % 3])
    specs, inputs, pads, meta = {}, {}, [], {}
    count = int(rng.integers(1, 5))
    for i in range(count):
        name = f"sink_{i}"
        w, h = int(rng.integers(1, 30)), int(rng.integers(1, 25))
        opaque = bool(rng.integers(0, 2))
        if seed % 2 and i == count - 1:  # an ADD over what it obscures
            opaque = True
        fmt = PFormat.NV12 if opaque else PFormat.RGBA
        x = int(rng.choice([rng.integers(-40, 50), -2**31, 2**31 - 1 - 64,
                            0]))
        y = int(rng.integers(-30, 40))
        if opaque and rng.random() < 0.5:  # covers what lies below it
            x, y = -int(rng.integers(0, 3)), -int(rng.integers(0, 3))
            w, h = out_w + int(rng.integers(2, 5)), out_h + 3
        w, h = (w + w % 2, h + h % 2) if opaque else (w, h)
        alpha = float(np.float32(rng.choice([0.0, 1.0, 1.0, rng.random()])))
        op = int(rng.integers(0, 3))
        buffered = bool(rng.integers(0, 4))
        if seed % 2 and i == count - 1:
            x, y, w, h = -1, 0, out_w + 2 + out_w % 2, out_h + out_h % 2
            alpha, op, buffered = 1.0, OP_ADD, True
        for prop, v in (("xpos", x), ("ypos", y), ("alpha", alpha),
                        ("operator", op)):
            comp.get_pad(name).set(prop, v)
        specs[name] = PSpec(fmt, w, h)
        if opaque:
            inputs[name] = {
                "y": torch.from_numpy(rng.integers(0, 256, (h, w),
                                                   dtype=np.uint8)),
                "u": torch.from_numpy(rng.integers(
                    0, 256, (h // 2, w // 2), dtype=np.uint8)),
                "v": torch.from_numpy(rng.integers(
                    0, 256, (h // 2, w // 2), dtype=np.uint8))}
        else:
            inputs[name] = {"rgba": torch.from_numpy(rng.integers(
                0, 256, (4, h, w), dtype=np.uint8))}
        meta[name] = {"active": 1.0 if buffered else 0.0, "eos": 0.0}
        pads.append((name, x, y, alpha, op, opaque, buffered))
    out_spec = PSpec(PFormat.RGBA, out_w, out_h)
    proc = comp.make_aggregate(specs, out_spec, "cpu")
    params = comp.traced_params("cpu")
    table = torch.from_numpy(proc.draw_table(params, meta))
    got, _ = proc(inputs, (), dict(params, **{DRAW_TABLE: table}))
    # the reference: the same samples, the former prepare pass, the fold
    samples = _pad_samples(comp, specs, out_spec, inputs)
    bg_drawn, draws = _old_prepare(
        [(s,) + p[1:] for s, p in zip(samples, pads)], out_w, out_h)
    bg = Background(background_colors(
        {"checker": ((0.5, 0.5, 0.5, 1.0), (0.75, 0.75, 0.75, 1.0)),
         "black": ((0.0, 0.0, 0.0, 1.0),) * 2,
         "transparent": ((0.0,) * 4,) * 2}[mode]))
    want = fold_draws_plain(out_h, out_w, bg, bg_drawn, draws, "cpu")
    assert torch.equal(got["rgba"], want)
    # a band's canvas from the same table: the frame's rows
    lo = int(rng.integers(0, out_h))
    rows = int(rng.integers(1, out_h - lo + 1))
    sources = [Source(s) for s in samples]
    band = composite_fold_plain(rows, out_w, bg._replace(row0=lo), sources,
                                table, "cpu")
    assert torch.equal(band, want[:, lo:lo + rows])


def _pad_samples(comp, specs, out_spec, inputs):
    """Each pad sampled at its size as the compositor samples it."""
    out = []
    for pad in comp._sorted_pads(specs):
        w, h, _, _ = pad.output_size(comp, out_spec.par)
        out.append(_plan_sampler(pad.spec, w, h, "cpu")(inputs[pad.name]))
    return out


def test_table_route_operators_and_flags():
    """Every operator, a draw flag of 0 and the background's flag, through
    a hand-written table."""
    rng = np.random.default_rng(21)
    src = [torch.from_numpy(rng.integers(0, 256, (4, 6, 7), dtype=np.uint8))
           for _ in range(3)]
    bg = Background(background_colors(((0.5, 0.5, 0.5, 1.0),
                                       (0.75, 0.75, 0.75, 1.0))))
    for op in (OP_SOURCE, OP_OVER, OP_ADD):
        for drawn in (0, 1):
            for bg_drawn in (False, True):
                draws = [Draw(src[0], -2, 1, (0, 1, 5, 7), op, 0.6, drawn),
                         Draw(src[1], 3, -1, (3, 0, 10, 5), OP_OVER, 1.0),
                         Draw(src[2], 9, 4, (9, 4, 12, 10), op, 0.3,
                              keep_alpha=True)]
                sources, table = pack_draws(10, 12, draws, bg_drawn)
                got = composite_fold_plain(10, 12, bg, sources, table, "cpu")
                want = fold_draws_plain(
                    10, 12, bg, bg_drawn,
                    [d for d in draws if d.draw], "cpu")
                assert torch.equal(got, want), (op, drawn, bg_drawn)


# -- failures ------------------------------------------------------------------


class _FailingEvent:
    def synchronize(self):
        raise RuntimeError("a device fault at the wait")


@pytest.mark.parametrize("stage_fails", [True, False])
@pytest.mark.parametrize("where", ["step", "wait"])
def test_unnamed_fault_is_located_by_the_eager_rerun(where, stage_fails,
                                                     monkeypatch):
    desc = f"appsrc format=NV12 width=32 height=24 ! {BCS} ! appsink"
    pipe = fed(desc, {"appsrc0": nv12(2, 32, 24, 15)}, device="cpu")
    st = next(st for st in pipe.stages if not st.passthrough)
    real = st.process

    def process(*a):
        if stage_fails:
            raise ValueError("the stage's own fault")
        return real(*a)

    if where == "step":
        def fault(*a, **k):
            st.process = process  # the re-run meets the failing stage
            raise RuntimeError("a device fault at the replay")

        monkeypatch.setattr(pipe.compiled, "step_batch", fault)
        with pytest.raises(PipelineError) as info:
            pipe.run()
        assert info.value.frame_index == 0
    else:
        pipe.run(1)
        out_fps, infos = pipe._clock()
        sel = pipe._select_buffers(0, out_fps, infos)
        retry = pipe._eager_retry(sel, read_params(pipe._active(), "cpu"))
        st.process = process
        with pytest.raises(PipelineError) as info:
            pipe._deliver(5, [], _FailingEvent(), retry)
        assert info.value.frame_index == 5
    assert info.value.element == (st.element.name if stage_fails
                                  else "<pipeline>")
    assert "device fault" in str(info.value.cause)


def test_a_window_change_drops_the_graphs():
    """A vfvideosink's render plan is captured with the step: a window
    change (`payload_key`) drops the keys, and the next frames render the
    new window."""
    desc = ("appsrc format=NV12 width=32 height=24 ! "
            "vfmetalvideosink window-width=40 window-height=40")
    pipe = fed(desc, {"appsrc0": nv12(4, 32, 24, 16)}, device="cpu")
    sink = pipe["vfmetalvideosink0"]
    sink.bind_device("cpu")
    pipe.run(2)
    compiled = pipe.compiled
    assert compiled.keys == 1 and sink.window.shape == (40, 40, 4)
    sink.set_window_size(48, 30)
    pipe.run(2)
    assert pipe.compiled is compiled and compiled.keys == 2
    assert sink.window.shape == (30, 48, 4)
