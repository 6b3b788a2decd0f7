"""The PyTorch port imports without JAX and refuses a missing CUDA device."""

import subprocess
import sys
from pathlib import Path

import pytest
import torch

from tpuvf_torch.runtime.device import get_device
from tpuvf_torch.runtime.pipeline import Pipeline

REPO = Path(__file__).resolve().parent.parent

MODULES = [
    "tpuvf_torch",
    "tpuvf_torch.core.element", "tpuvf_torch.core.formats",
    "tpuvf_torch.core.frame", "tpuvf_torch.core.properties",
    "tpuvf_torch.core.registry", "tpuvf_torch.core.spec",
    "tpuvf_torch.kernels._build", "tpuvf_torch.kernels.color",
    "tpuvf_torch.kernels.composite", "tpuvf_torch.kernels.convert",
    "tpuvf_torch.kernels.deinterlace", "tpuvf_torch.kernels.emit",
    "tpuvf_torch.kernels.filter", "tpuvf_torch.kernels.lut",
    "tpuvf_torch.kernels.overlay", "tpuvf_torch.kernels.resample",
    "tpuvf_torch.kernels.sample", "tpuvf_torch.elements",
    "tpuvf_torch.elements.compositor", "tpuvf_torch.elements.deinterlace",
    "tpuvf_torch.elements.overlay", "tpuvf_torch.elements.transform",
    "tpuvf_torch.runtime.pipeline",
    "tpuvf_torch.runtime.params", "tpuvf_torch.cli.launch",
    "tpuvf_torch.runtime.observability", "tpuvf_torch.elements.codecs",
    "tpuvf_torch.elements.sinks", "tpuvf_torch.elements.sources",
    "tpuvf_torch.elements.util_elements", "tpuvf_torch.elements.videosink",
    "tpuvf_torch.io.png", "tpuvf_torch.io.y4m", "tpuvf_torch.native",
    "tpuvf_torch.native.jpeg", "tpuvf_torch.parallel",
    "tpuvf_torch.parallel.bands", "tpuvf_torch.parallel.halo",
    "tpuvf_torch.parallel.mesh",
]


def test_port_imports_without_jax():
    code = (
        "import importlib, sys\n"
        f"for m in {MODULES!r}:\n"
        "    importlib.import_module(m)\n"
        "from tpuvf_torch.core import registry\n"
        "registry.lookup('vfmetalcompositor')  # imports every element\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'tpuvf' or m.startswith('tpuvf.'))\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"


def test_cuda_device_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        Pipeline(device="cuda")
    with pytest.raises(ValueError):
        get_device("mps")
    assert get_device("cpu") == torch.device("cpu")
