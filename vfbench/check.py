"""The comparison that decides ``correct``.

For each frame the check reads (drawn from the seed), the program's output
bytes, as the sink received them, against the reference's.  The numbers
compared, each against the configuration's ``limits``:

- ``missing``: frames due for the check that never reached the sink (a
  batch frame not delivered; a live frame that was delivered but whose
  bytes were not kept);
- ``max_lsb``: the largest difference of one byte, over every byte of every
  frame read;
- ``diff_ppm``: the share of bytes that differ at all, in parts per
  million, of the worst frame read.
"""

from __future__ import annotations

import numpy as np
import torch

NUMBERS = ("missing", "max_lsb", "diff_ppm")


def compare(program: np.ndarray, reference: torch.Tensor) -> tuple:
    """-> (largest byte difference, share of bytes that differ in ppm)."""
    got = torch.from_numpy(np.ascontiguousarray(program)).to(reference.device)
    if tuple(got.shape) != tuple(reference.shape):
        return 255, 1e6
    d = (got.to(torch.int16) - reference.to(torch.int16)).abs()
    return int(d.max()), float((d != 0).sum()) * 1e6 / d.numel()


class Tally:
    def __init__(self):
        self.missing = 0
        self.max_lsb = 0
        self.diff_ppm = 0.0
        self.frames = 0

    def add(self, max_lsb: int, diff_ppm: float) -> None:
        self.frames += 1
        self.max_lsb = max(self.max_lsb, max_lsb)
        self.diff_ppm = max(self.diff_ppm, diff_ppm)

    def numbers(self) -> dict:
        return {k: getattr(self, k) for k in NUMBERS}


def judge(numbers: dict, limits: dict) -> tuple:
    """-> (correct, {name: {"value", "limit"}}) over NUMBERS."""
    out = {k: {"value": numbers[k], "limit": limits[k]} for k in NUMBERS}
    return all(v["value"] <= v["limit"] for v in out.values()), out
