"""tpuvf_torch — the PyTorch + CUDA port of tpuvf for NVIDIA Hopper (H100).

The JAX package `tpuvf` beside it is the reference this port is held
against.  The port runs the canonical dataflow of tpuvf's elements with
PyTorch tensors on one `torch.device`, and every TPU kernel on its path is a
hand-written CUDA kernel (`tpuvf_torch/csrc`), built with nvcc at first use.
It imports torch and numpy, never jax.
"""

from tpuvf_torch.core.formats import VideoFormat
from tpuvf_torch.core.spec import Fraction, FrameSpec

__version__ = "0.1.0"

__all__ = ["VideoFormat", "FrameSpec", "Fraction", "__version__"]
