"""What the harness and the reference load, and how a run ends without a
card: a CPU dry run of the harness and the reference in a fresh process
loads no module whose top-level name is jax, jaxlib, flax or tpuvf, and the
reference alone loads nothing of tpuvf_torch either (names compared whole:
tpuvf_torch begins with tpuvf)."""

from __future__ import annotations

import json
import shutil
import subprocess
import sys

import pytest

from vfbench import spec

ROOT = spec.HERE.parent

DRY_RUN = """
import json, sys
from vfbench import harness
from vfbench.tests import small
r = harness.run_cell(small.cell("compositor_4k", "live_pip"), 5, 0.3, True,
                     "cpu")
assert r["correct"], r["check"]
print(json.dumps(sorted({m.split(".")[0] for m in sys.modules})))
"""


REFERENCE_RUN = """
import json, sys
import torch
from vfbench import check, inputs
from vfbench.reference import Reference
from vfbench.tests import small
for name in ("convert_filter_4k", "compositor_4k"):
    cfg = small.config(name)
    ref = cfg["reference"]
    pool = inputs.frame_pool(ref["sources"], 2, 9, "cpu")
    frames = {s: f[0] for s, f in pool.items()}
    a = Reference("cpu").frame(ref, frames, {})
    b = Reference("cpu", torch.bfloat16).frame(ref, frames, {})
    check.compare(a.numpy(), b)
print(json.dumps(sorted({m.split(".")[0] for m in sys.modules})))
"""


def _modules(code: str) -> set:
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_harness_dry_run_loads_no_jax_or_tpuvf():
    mods = _modules(DRY_RUN)
    assert "tpuvf_torch" in mods
    assert not mods & {"jax", "jaxlib", "flax", "tpuvf"}


def test_reference_loads_nothing_of_the_program():
    mods = _modules(REFERENCE_RUN)
    assert not mods & {"jax", "jaxlib", "flax", "tpuvf", "tpuvf_torch"}


def _run_py(cwd, *extra):
    return subprocess.run(
        [sys.executable, "-m", "vfbench.run", "--workload", "cf4k-batch",
         "--seed", "3", "--seconds", "1", "--trace", "0", *extra],
        cwd=cwd, capture_output=True, text=True, timeout=300,
        env={"PATH": "/usr/bin:/bin", "CUDA_VISIBLE_DEVICES": ""})


def _has_result(stdout: str) -> bool:
    lines = stdout.strip().splitlines()
    return bool(lines) and lines[-1].startswith("{")


def test_run_without_a_card_prints_no_result():
    out = _run_py(ROOT)
    assert out.returncode != 0 and not _has_result(out.stdout)


def test_run_without_the_program_prints_no_result(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "vfbench", tmp_path / "vfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = _run_py(tmp_path)
    assert out.returncode != 0 and not _has_result(out.stdout)


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.card
@pytest.mark.parametrize("cell", [w["name"] for w in
                                  spec.load_benchmark(ROOT)["workloads"]])
def test_cell_runs_correct_on_the_card(card, cell):
    out = subprocess.run(
        [sys.executable, "-m", "vfbench.run", "--workload", cell, "--seed",
         str(2**32 + 77), "--seconds", "2", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"], result["check"]
