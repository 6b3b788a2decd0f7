"""The port's tool modules: `cli/inspect.py` against tpuvf's,
`runtime/device.py`, `runtime/benchmark.py` and the per-frame param
staging of `runtime/staging.py`, on the CPU.

inspect: tpuvf's text for every factory, and tpuvf's listing.
"""

from pathlib import Path

import numpy as np
import pytest
import torch

from tpuvf.cli import inspect as tpuvf_inspect
from tpuvf.core import registry as tpuvf_registry
from tpuvf_torch.cli import inspect as port_inspect
from tpuvf_torch.core import registry as port_registry
from tpuvf_torch.core.formats import VideoFormat
from tpuvf_torch.core.spec import FrameSpec
from tpuvf_torch.runtime import benchmark, device
from tpuvf_torch.runtime.compiled import _ParamRows
from tpuvf_torch.runtime.staging import ParamStager

torch.set_num_threads(1)


@pytest.mark.parametrize("name", sorted(tpuvf_registry.all_factories()))
def test_inspect_matches_tpuvf(name):
    want = tpuvf_inspect.format_element(tpuvf_registry.lookup(name))
    got = port_inspect.format_element(port_registry.lookup(name))
    assert got == want


def test_inspect_main_listing_and_unknown(capsys):
    assert port_inspect.main([]) == 0
    listing = capsys.readouterr().out.splitlines()
    assert listing[0] == "Available elements:"
    assert listing[1:] == [
        f"  {name:<22} {cls.DESCRIPTION}"
        for name, cls in sorted(tpuvf_registry.all_factories().items())]
    names = [line.split()[0] for line in listing[1:]]
    assert names == sorted(port_registry.all_factories())
    assert port_inspect.main(["vfmetalvideofilter"]) == 0
    out = capsys.readouterr().out
    assert "GstVideoFilter" in out and "controllable" in out
    assert port_inspect.main(["no-such-element"]) == 1
    assert "No such element: no-such-element" in capsys.readouterr().err


def test_get_device_needs_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        device.get_device()
    with pytest.raises(RuntimeError):
        device.device_info()
    with pytest.raises(ValueError, match="cpu or cuda"):
        device.get_device("mps")
    assert device.get_device("cpu") == torch.device("cpu")
    assert device.device_info("cpu").startswith("cpu (torch ")


def test_enable_executable_cache(tmp_path):
    from tpuvf_torch.kernels import _build

    default = _build.BUILD_DIR
    try:
        assert device.enable_executable_cache(tmp_path) == tmp_path
        assert _build.LIBRARY.parent == tmp_path
    finally:
        assert device.enable_executable_cache() == default
    assert _build.LIBRARY == default / "libtpuvf_kernels.so"
    # the default build directory is one .gitignore lists
    root = Path(__file__).resolve().parent.parent
    ignored = (root / ".gitignore").read_text().split()
    assert default.relative_to(root).as_posix() + "/" in ignored


def _step(planes, state, params):
    """A stateful per-frame step: a running sum of the frames."""
    acc = state["acc"] + planes["rgba"].to(torch.int64)
    return {"rgba": (acc % 256).to(torch.uint8)}, {"acc": acc}


def test_make_batch_fn_equals_steps():
    spec = FrameSpec(VideoFormat.RGBA, 8, 6)
    planes = benchmark.random_planes_for_spec(spec, 4, device="cpu")
    state0 = {"acc": torch.zeros((4, 6, 8), dtype=torch.int64)}
    outs, state = benchmark.make_batch_fn(_step)(planes, state0, {})
    st = state0
    for b in range(4):
        out, st = _step({"rgba": planes["rgba"][b]}, st, {})
        assert torch.equal(outs["rgba"][b], out["rgba"])
    assert torch.equal(state["acc"], st["acc"])
    assert benchmark.sync(outs).shape == (1,)


def test_measure_fps_and_device_time_on_cpu():
    spec = FrameSpec(VideoFormat.NV12, 16, 8)
    state0 = {"acc": torch.zeros((8, 16), dtype=torch.int64)}

    def step(planes, state, params):
        acc = state["acc"] + planes["y"].to(torch.int64)
        return {"rgba": (acc % 256).to(torch.uint8)}, {"acc": acc}

    def make(n):
        return benchmark.random_planes_for_spec(spec, n, device="cpu")

    assert set(make(2)) == {"y", "u", "v"}
    res = benchmark.measure_fps(step, make, state0, reps=2)
    assert res["fps"] > 0 and res["batches"] == (4, 16)
    # a CPU time is never the card's
    with pytest.raises(ValueError, match="CUDA"):
        benchmark.measure_device_us(step, make, state0)


def test_random_planes_refuses_link_layouts(monkeypatch):
    spec = FrameSpec(VideoFormat.NV12, 16, 8)
    for split in (True, "quad", "pair"):
        with pytest.raises(NotImplementedError, match="not ported"):
            benchmark.random_planes_for_spec(spec, 1, split=split,
                                             device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        benchmark.random_planes_for_spec(spec, 1)


def test_stager_restages_only_changed_scalars():
    """Unchanged scalars keep their staged tensors; a change stages a new
    vector (the old one is not written in place); other values pass as
    they are; a batch's fixed rows (`_ParamRows`) give each frame its row
    of one tensor."""
    stager = ParamStager(torch.device("cpu"))
    table = torch.ones(3)
    reads = {"f": ({"a": 0.5, "b": 2.0}, {"lut": table}),
             "c": ({}, {"pad.sink_0.xpos": 4})}
    first = stager.frame(reads)
    again = stager.frame({k: (dict(s), dict(o)) for k, (s, o) in
                          reads.items()})
    assert again["f"]["a"] is first["f"]["a"]
    assert again["f"]["lut"] is table and again["c"] == {"pad.sink_0.xpos": 4}
    changed = stager.frame({"f": ({"a": 0.25, "b": 2.0}, {}), "c": ({}, {})})
    assert changed["f"]["a"].item() == 0.25 and first["f"]["a"].item() == 0.5
    assert changed["f"]["a"].dtype == torch.float32
    block = _ParamRows(torch.device("cpu"), 4, [])
    batch = [{"f": ({"a": float(v)}, {})} for v in np.arange(4) / 8]
    block.stage(stager, batch, [None] * 4)
    rows = [block.params(j, r) for j, r in enumerate(batch)]
    assert [r["f"]["a"].item() for r in rows] == [0.0, 0.125, 0.25, 0.375]
    base = rows[0]["f"]["a"]._base
    assert base is not None and base.shape == (4, 1)
    with pytest.raises(ValueError, match="same params"):
        block.stage(stager, [{"f": ({"a": 0.0}, {})},
                             {"f": ({"b": 0.0}, {})}], [None] * 2)
