"""BENCHMARK.json and the files it names: every cell's configuration,
traffic mix and per-layer readers found by name, names and units within
the contract's characters, and each configuration's launch description
(those no cell uses yet too) negotiating, through the program, to the
geometry its reference reads."""

from __future__ import annotations

import json
import re

import pytest

from vfbench import roofline, spec
from vfbench.reference import OPERATORS

ROOT = spec.HERE.parent
BENCH = spec.load_benchmark(ROOT)
CELLS = [w["name"] for w in BENCH["workloads"]]
CONFIGS = {c["name"]: c for c in BENCH["configs"]}
# every configuration file, those no cell uses yet included
CONFIG_FILES = sorted(p.stem for p in (spec.HERE / "configs").glob("*.json"))
KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
        "end_to_end", "per_layer"}


def test_top_level_keys_and_command():
    assert set(BENCH) == KEYS
    assert BENCH["paths"] == ["vfbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    for word in BENCH["command"]:
        assert not word.startswith("/") and ".." not in word


def test_names_and_units():
    metrics = BENCH["end_to_end"] + BENCH["per_layer"]
    names = ([m["name"] for m in metrics] + CELLS + list(CONFIGS)
             + [w["traffic"] for w in BENCH["workloads"]])
    for name in names:
        assert spec.NAME_RE.match(name), name
    for group in (metrics, BENCH["workloads"], BENCH["configs"]):
        assert len({x["name"] for x in group}) == len(group)
    for m in metrics:
        assert spec.UNIT_RE.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
    for w in BENCH["workloads"]:
        assert 1 <= len(w["why"]) <= 200 and "\n" not in w["why"]


@pytest.mark.parametrize("cell", CELLS)
def test_cell_files_found_by_name(cell):
    c = spec.load_cell(ROOT, cell)
    assert spec.traffic_path(
        next(w["traffic"] for w in BENCH["workloads"]
             if w["name"] == cell)).exists()
    assert any(m["name"] == "setup_s" for m in c.end_to_end)
    assert len(c.end_to_end) >= 2 and c.per_layer
    for m in c.per_layer:
        assert spec.reader_path(m["name"]).exists(), m["name"]
        assert callable(spec.load_reader(m["name"]).read)
        assert m["moves"] in {e["name"] for e in c.end_to_end}
    assert set(c.config["limits"]) == {"missing", "max_lsb", "diff_ppm"}


@pytest.mark.parametrize("name", CONFIG_FILES)
def test_config_file_and_bytes(name):
    with open(spec.HERE / "configs" / f"{name}.json") as fh:
        cfg = json.load(fh)
    assert cfg["name"] == name and cfg["reduced"] == []
    if name in CONFIGS:
        assert CONFIGS[name]["reduced"] == cfg["reduced"]
        assert CONFIGS[name]["file"] == f"vfbench/configs/{name}.json"
    want = {"convert_filter_4k": 45_619_200, "compositor_4k": 74_796_544}
    assert roofline.bytes_per_frame(cfg["reference"]) == want[name]


@pytest.mark.parametrize("name", CONFIG_FILES)
def test_launch_negotiates_to_the_reference_geometry(name, tmp_path):
    from tpuvf_torch.cli.launch import parse_pipeline

    from vfbench import inputs, sink

    sink.register()
    with open(spec.HERE / "configs" / f"{name}.json") as fh:
        cfg = json.load(fh)
    ref = cfg["reference"]
    png = tmp_path / "o.png"
    if ref.get("overlay"):
        inputs.write_png(png, inputs.overlay_image(ref["overlay"]))
    pipe = parse_pipeline(cfg["launch"].format(fps="60/1", png=png),
                          device="cpu")
    pipe.negotiate()
    for src, s in ref["sources"].items():
        spec_ = pipe._source_spec(pipe[src])
        assert (spec_.format.name, spec_.width, spec_.height) == (
            s["format"], s["width"], s["height"])
    out = pipe._incoming(pipe["out"])[0].spec
    o = ref["output"]
    assert (out.format.name, out.width, out.height) == (
        o["format"], o["width"], o["height"])
    for pad in ref.get("pads", ()):
        bag = pipe["c"].get_pad(pad["pad"])
        assert bag.get("xpos") == pad["xpos"]
        assert bag.get("ypos") == pad["ypos"]
        assert abs(bag.get("alpha") - pad["alpha"]) < 1e-12
        assert bag.get("operator") in (pad["operator"],
                                       OPERATORS[pad["operator"]])
    for key in ("brightness", "contrast", "saturation"):
        if "filter" in ref:
            el = next(e for e in pipe.elements
                      if re.match("vfvideofilter|vfmetalvideofilter",
                                  type(e).ELEMENT_NAME))
            assert el.get_property(key) == ref["filter"][key]
