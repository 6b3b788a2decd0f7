"""Readings that set the check's limits, on the card, at a cell's own size.

    python3 -m vfbench.calibrate control --workload W --seeds S.. [--seconds s]
    python3 -m vfbench.calibrate fault   --workload W --seeds S.. [--seconds s]
                                         --fault altered|slot|stale|half

- ``control``: the reference in the program's place, computed in bfloat16
  (the precision below the configurations' float32), judged by the same
  comparison on the same frames at the cell's own size; it has to come out
  not correct;
- ``fault``: a whole run of the cell (``harness.run_cell``, as
  ``vfbench.run`` makes it) with a fault of ``vfbench/faults.py`` planted
  under the timed path; it has to come out not correct.

Each prints one JSON line a seed.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import torch

from vfbench import check, faults, harness, inputs, spec
from vfbench.reference import Reference


def control(cell: spec.Cell, seed: int, seconds: float, device,
            dtype=torch.bfloat16, fps_guess: float = 800.0) -> dict:
    """The control's compared numbers on the frames a run of `seconds`
    would check."""
    ref, trf = cell.config["reference"], cell.traffic
    device = torch.device(device)
    pool = inputs.frame_pool(ref["sources"], trf["pool"],
                             harness.seed64(seed), device)
    if trf["loop"] == "batched":
        bs = int(trf["batch_size"])
        n = max(bs, int(fps_guess * seconds / bs) * bs)
    else:
        n = max(2, int(round(float(trf["rate"]) * seconds)))
    low, exact = Reference(device, dtype), Reference(device)
    tally = check.Tally()
    for k in inputs.sample_frames(seed, n, trf):
        frames = {s: pool[s][k % len(pool[s])] for s in pool}
        values = inputs.frame_values(trf, k)
        got = low.frame(ref, frames, values).cpu().numpy()
        tally.add(*check.compare(got, exact.frame(ref, frames, values)))
    correct, numbers = check.judge(tally.numbers(), cell.config["limits"])
    return {"seed": seed, "control": str(dtype), "correct": correct,
            "check": numbers}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="vfbench.calibrate")
    ap.add_argument("mode", choices=("control", "fault"))
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="*", default=[1])
    ap.add_argument("--seconds", type=float, default=4.0)
    ap.add_argument("--fault", choices=sorted(faults.FAULTS))
    args = ap.parse_args(argv)
    if args.mode == "fault" and not args.fault:
        ap.error("fault needs --fault")
    cell = spec.load_cell(Path.cwd(), args.workload)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = "cuda" if torch.cuda.is_available() else "cpu"
    if args.mode == "fault":
        faults.plant(args.fault)
    for seed in args.seeds:
        if args.mode == "control":
            line = control(cell, seed, args.seconds, device)
        else:
            r = harness.run_cell(cell, seed, args.seconds, False, device)
            line = {"seed": seed, "fault": args.fault,
                    "correct": r["correct"], "attempted": r["attempted"],
                    "failed": r["failed"], "check": r["check"]}
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
