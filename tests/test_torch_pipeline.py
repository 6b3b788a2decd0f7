"""The port's whole slice against tpuvf: NV12 -> vfconvertscale ->
vfvideofilter (b/c/s) -> BGRA through `parse_pipeline`, on the same appsrc
frames.  tpuvf runs under TPUVF_NO_SPLIT_LINKS=1, which makes every element
boundary canonical — the dataflow the port implements.

Tolerance: <= 1 LSB per value (resampling re-expressions and the b/c/s fold
association, as in test_torch_elements).  Three frames, so the videofilter's
frame counter advances.
"""

import numpy as np
import pytest
import torch

from tpuvf.cli.launch import parse_pipeline as tpuvf_parse
from tpuvf_torch.cli.launch import main as port_main, parse_pipeline as port_parse
from tpuvf_torch.parallel.mesh import make_mesh
from tpuvf_torch.runtime.pipeline import Pipeline

torch.set_num_threads(1)

BCS = "vfmetalvideofilter brightness=0.05 contrast=1.1 saturation=1.2"
CHAINS = {
    # __graft_entry__.entry's chain, cut to 128x72 -> 64x48
    "entry": ("appsrc format=NV12 width=128 height=72 ! vfmetalconvertscale ! "
              "video/x-raw,format=BGRA,width=64,height=48 ! " + BCS
              + " ! appsink"),
    # bench.py's chain (identity geometry), cut to 128x72
    "bench": ("appsrc format=NV12 width=128 height=72 ! vfmetalconvertscale ! "
              "video/x-raw,format=BGRA,width=128,height=72 ! " + BCS
              + " ! appsink"),
}


def _nv12_frames(n, w, h, seed):
    rng = np.random.default_rng(seed)
    return [{"y": rng.integers(0, 256, (h, w), dtype=np.uint8),
             "uv": rng.integers(0, 256, (h // 2, w), dtype=np.uint8)}
            for _ in range(n)]


def _run(parse, desc, frames, **kw):
    pipe = parse(desc, **kw)
    src = pipe["appsrc0"]
    for f in frames:
        src.push(f)
    src.end_of_stream()
    pipe.negotiate()
    pipe.build()
    assert pipe.run() == len(frames)
    return pipe["appsink0"].frames


@pytest.mark.parametrize("chain", sorted(CHAINS))
def test_slice_matches_tpuvf_pipeline(chain, monkeypatch):
    monkeypatch.setenv("TPUVF_NO_SPLIT_LINKS", "1")
    frames = _nv12_frames(3, 128, 72, seed=11)
    want = _run(tpuvf_parse, CHAINS[chain], frames)
    got = _run(port_parse, CHAINS[chain], frames, device="cpu")
    assert len(got) == len(want) == 3
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.shape == w.shape and g.dtype == np.uint8
        d = np.abs(g.astype(np.int32) - w.astype(np.int32))
        print(f"{chain} frame {i}: max {int(d.max())} LSB, "
              f"{float((d > 0).mean()):.4%} values differ")
        assert int(d.max()) <= 1  # <= 1 LSB (module doc)


def test_cli_main_runs_to_eos_on_cpu(capsys):
    rc = port_main([
        "--device", "cpu",
        "videotestsrc num-buffers=2 ! video/x-raw,format=NV12,width=64,height=36"
        " ! vfmetalconvertscale ! video/x-raw,format=BGRA,width=32,height=24"
        " ! " + BCS + " ! fakesink"])
    assert rc == 0
    assert "processed 2 frames on cpu, reached end of stream" in capsys.readouterr().out


def test_passthrough_elements_are_elided():
    pipe = port_parse(
        "videotestsrc num-buffers=1 ! video/x-raw,format=BGRA,width=32,height=24"
        " ! vfmetalconvertscale ! vfmetalvideofilter ! appsink", device="cpu")
    pipe.build()
    assert [st.passthrough for st in pipe.stages] == [True, True]
    assert pipe.params() == {}
    assert pipe.run() == 1
    assert pipe["appsink0"].frames[0].shape == (24, 32, 4)


def test_unported_features_raise(capsys):
    """Sharpness, the packed 4:2:2 host repack and tee run, and so do
    batched runs and the launcher's -b/--batch and --live on the CPU;
    run_batched's `sp_axis` without a mesh is ignored, as in tpuvf, and a
    mesh without a 'dp' axis is refused with tpuvf's error."""
    pipe = port_parse(
        "videotestsrc num-buffers=1 ! video/x-raw,format=BGRA,width=32,height=24"
        " ! vfmetalvideofilter sharpness=0.5 ! appsink", device="cpu")
    pipe.build()
    assert pipe.run() == 1
    assert pipe["appsink0"].frames[0].shape == (24, 32, 4)
    pipe = port_parse(
        "videotestsrc num-buffers=1 ! video/x-raw,format=UYVY,width=32,height=24"
        " ! vfmetalconvertscale ! video/x-raw,format=BGRA ! appsink",
        device="cpu")
    pipe.build()
    assert pipe.run() == 1
    assert pipe["appsink0"].frames[0].shape == (24, 32, 4)
    pipe = port_parse("videotestsrc num-buffers=1 ! tee ! appsink",
                      device="cpu")
    assert pipe.run() == 1
    assert pipe.run_batched(3, batch_size=2) == 1
    assert pipe.run_batched(1, sp_axis="sp") == 1
    with pytest.raises(ValueError, match="has no 'dp' axis"):
        pipe.run_batched(1, mesh=make_mesh({"sp": 2}, devices=["cpu"] * 2))
    desc = ("videotestsrc num-buffers=3 ! video/x-raw,format=BGRA,width=32,"
            "height=24 ! vfmetalvideofilter brightness=0.1 ! fakesink")
    for flags in (["-b", "2"], ["--live"]):
        capsys.readouterr()
        assert port_main(["--device", "cpu", *flags, desc]) == 0
        assert "processed 3 frames on cpu" in capsys.readouterr().out


def test_auto_field_order_per_buffer_flip():
    """The port of tests/test_deinterlace.py's per-buffer flip: with
    field-layout=auto each buffer deinterlaces with its own TFF flag, which
    the runtime hands the filter as ``params["__meta__"]``."""
    w, h = 16, 12
    rng = np.random.default_rng(23)
    hosts = [rng.integers(0, 256, (h, w, 4), dtype=np.uint8) for _ in range(3)]
    tffs = [True, False, True]

    def run(layout, frames, flags=None):
        pipe = port_parse(f"appsrc format=RGBA width={w} height={h} "
                          f"! vfmetaldeinterlace method=bob field-layout={layout}"
                          f" ! appsink", device="cpu")
        for i, host in enumerate(frames):
            pipe["appsrc0"].push(host, tff=None if flags is None else flags[i])
        pipe["appsrc0"].end_of_stream()
        assert pipe.run() == len(frames)
        return pipe["appsink0"].frames

    frames = run("auto", hosts, tffs)
    for i, (host, tff) in enumerate(zip(hosts, tffs)):
        layout = "top-field-first" if tff else "bottom-field-first"
        assert np.array_equal(frames[i], run(layout, [host])[0]), (i, tff)
    # the two field orders genuinely differ on this data
    assert not np.array_equal(run("top-field-first", hosts[1:2])[0],
                              run("bottom-field-first", hosts[1:2])[0])


CLI_CHAINS = {
    "vfmetaldeinterlace": "video/x-raw,format=I420,width=32,height=24,"
                          "interlace-mode=interleaved ! vfmetaldeinterlace "
                          "method=greedyh motion-threshold=0.3",
    "vfmetaltransform": "video/x-raw,format=NV12,width=32,height=24 ! "
                        "vfmetaltransform method=counterclockwise crop-right=4",
    "vfmetaloverlay": "video/x-raw,format=BGRA,width=32,height=24 ! "
                      "vfmetaloverlay location={png} x=4 y=2 alpha=0.5",
}


@pytest.mark.parametrize("name", sorted(CLI_CHAINS))
def test_cli_reaches_the_new_elements(name, tmp_path, capsys):
    from tpuvf.io import png

    path = tmp_path / "ov.png"
    png.write(str(path), np.full((6, 8, 4), 200, np.uint8))
    desc = ("videotestsrc num-buffers=2 ! "
            + CLI_CHAINS[name].format(png=path) + " ! fakesink")
    pipe = port_parse(desc, device="cpu")
    pipe.build()
    assert [st.passthrough for st in pipe.stages] == [False]
    assert type(pipe.stages[0].element).ELEMENT_NAME == name.replace(
        "vfmetal", "vf")
    assert port_main(["--device", "cpu", desc]) == 0
    assert "processed 2 frames on cpu" in capsys.readouterr().out


def test_cli_default_cuda_device_fails_without_cuda(capsys):
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    assert port_main(["videotestsrc num-buffers=1 ! fakesink"]) == 1
    assert "torch.cuda.is_available() is False" in capsys.readouterr().err
    assert Pipeline(device="cpu").device.type == "cpu"
