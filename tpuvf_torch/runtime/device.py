"""Device management (port of ``tpuvf.runtime.device``).

tpuvf keeps one process-wide device picker, an info string for diagnostics
and the persistent executable cache (the reference's VfMetalDevice,
vfmetaldevice.m:30-64, 87-93).  The port's counterparts:

- `get_device` returns the card the caller names, "cuda" by default, and
  raises without one.  Unlike tpuvf's picker it never falls back to the
  CPU: a caller that wants the CPU asks for "cpu".
- `device_info` names the card, its compute capability and count, and the
  torch and CUDA versions.
- `enable_executable_cache` sets where the hand-written kernels are built
  and kept (``kernels/_build.py``), the counterpart of tpuvf's compilation
  cache directory.
"""

from __future__ import annotations

import contextlib
from pathlib import Path

import torch


def get_device(device="cuda") -> torch.device:
    """torch.device for `device`; a CUDA device must be available."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {device!r} requested but torch.cuda.is_available() "
                f"is False")
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {device!r} (cpu or cuda)")
    return dev


def on_device(device):
    """The CUDA device context of `device` (a no-op for the CPU): kernels
    and events enqueued inside go to its card."""
    if device.type == "cuda":
        return torch.cuda.device(device)
    return contextlib.nullcontext()


def device_info(device="cuda") -> str:
    """One line naming `device` for diagnostics."""
    dev = get_device(device)
    versions = f"torch {torch.__version__}"
    if dev.type == "cpu":
        return f"cpu ({versions})"
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    major, minor = torch.cuda.get_device_capability(index)
    n = torch.cuda.device_count()
    return (f"{torch.cuda.get_device_name(index)} (compute capability "
            f"{major}.{minor}, cuda:{index}, {n} device"
            f"{'s' if n != 1 else ''} visible, {versions}, CUDA "
            f"{torch.version.cuda})")


def enable_executable_cache(path=None) -> Path:
    """Build and keep the kernel library under `path` (default: the
    package's ``_build`` directory, which .gitignore lists); -> the
    directory.  It applies to the next build or load: a library this
    process has already loaded stays loaded."""
    from tpuvf_torch.kernels import _build

    return _build.set_build_dir(path)
