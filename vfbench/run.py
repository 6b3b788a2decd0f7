"""Run one cell of the benchmark once, from the root of a checkout.

    python3 -m vfbench.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

The last line of standard output is the result, one JSON object; the
numbers the check compared, each beside its limit, are the last lines of
standard error and the result's last key.  Without a CUDA card, or with
fewer cards than the cell asks for, it prints no result and exits 2; if a
module of JAX or of the JAX package is loaded once the window has closed, it
exits 3.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "tpuvf")


def forbidden_modules() -> list:
    """Loaded modules whose whole top-level name is JAX's or tpuvf's."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def cache_dirs(root: Path) -> None:
    """Every build and kernel cache at a fixed path inside the checkout
    (the program's own kernels build into tpuvf_torch/_build)."""
    base = root / ".vfbench_cache"
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "nv")):
        os.environ[var] = str(base / sub)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="vfbench.run")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from vfbench import spec

    root = Path.cwd()
    cache_dirs(root)
    cell = spec.load_cell(root, args.workload)

    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"vfbench: {args.workload} needs {cell.chips} CUDA card(s); "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from vfbench import harness

    result = harness.run_cell(cell, args.seed, args.seconds,
                              bool(args.trace), "cuda", T_START)
    bad = forbidden_modules()
    if bad:
        print(f"vfbench: loaded in this process: {', '.join(bad)}",
              file=sys.stderr)
        return 3
    for name, v in result["check"].items():
        print(f"check {name} {v['value']} limit {v['limit']}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
