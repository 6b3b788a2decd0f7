"""The check on the CPU at a twentieth of the size: the reference agrees
with the program's CPU path for both configurations under every traffic
mix (the picture-in-picture schedule included); the control, the reference
in bfloat16 in the program's place, comes out not correct; a run with the
timed path broken underneath comes out not correct, once for each fault a
cell can have; and the frames the check reads cover every batch slot."""

from __future__ import annotations

import pytest
import torch

from vfbench import calibrate, faults, harness, inputs
from vfbench.tests import small

CELLS = [("convert_filter_4k", "batch8"), ("convert_filter_4k", "live60"),
         ("compositor_4k", "batch8"), ("compositor_4k", "live_pip")]
SEED = 2**33 + 12345  # wider than 32 bits, as a benchmark seed may be


def run(cfg, trf, seconds=0.5):
    return harness.run_cell(small.cell(cfg, trf), SEED, seconds, False, "cpu")


@pytest.mark.parametrize("cfg,trf", CELLS)
def test_reference_agrees_with_the_program(cfg, trf):
    r = run(cfg, trf)
    assert r["correct"], r["check"]
    assert r["check_frames"] >= 8
    assert r["check"]["max_lsb"]["value"] <= 2


def test_pip_schedule_moves_the_pad():
    c = small.cell("compositor_4k", "live_pip")
    xs = [inputs.frame_values(c.traffic, k)["sink_1::xpos"]
          for k in range(0, 241, 60)]
    assert xs == [96, 48, 0, 48, 96]


@pytest.mark.parametrize("cfg,trf", CELLS)
def test_control_is_not_correct(cfg, trf):
    r = calibrate.control(small.cell(cfg, trf), SEED, 0.5, "cpu",
                          dtype=torch.bfloat16, fps_guess=200.0)
    assert not r["correct"]
    assert r["check"]["diff_ppm"]["value"] > r["check"]["diff_ppm"]["limit"]


# -- faults planted under the timed path -------------------------------------

@pytest.mark.parametrize("fault", sorted(faults.FAULTS))
@pytest.mark.parametrize("cfg,trf", CELLS)
def test_fault_is_not_correct(monkeypatch, fault, cfg, trf):
    faults.plant(fault, monkeypatch.setattr)
    r = run(cfg, trf)
    assert not r["correct"], (fault, r["check"])


@pytest.mark.parametrize("trf", ["batch8", "live60"])
def test_sample_covers_every_slot_and_pool_frame(trf):
    t = small.traffic(trf)
    period = inputs.sample_period(t)
    for seed in (SEED, 1, 2**31 + 9):
        for n in (8 * 3, 26_000, 10_001):
            ks = inputs.sample_frames(seed, n, t)
            assert ks[0] == 0 and ks[-1] == n - 1 and len(set(ks)) == len(ks)
            assert {k % period for k in ks} == set(range(period))
    assert inputs.sample_frames(SEED, 26_000, t) == inputs.sample_frames(
        SEED, 26_000, t)
