"""K3: the trilinear 3D-LUT lookup (vfvideofilter's `lut-file` stage).

`lut3d` is the port of the LUT-gather Pallas probes of tpuvf
(``scripts/bench_gather*.py``), whose product is
``tpuvf/kernels/filter.py::apply_lut_t``.  On a CUDA tensor it launches the
hand-written kernel ``lut3d_trilinear_f32`` (``csrc/lut.cu``) on the current
stream; on a CPU tensor it calls `lut3d_plain`, which is
``filter.apply_lut_t_plain`` plus the same quantizer.  There is no other
path: a CUDA launch that fails raises.  The kernel is bitwise equal to its
plain version.

The launcher picks the table path from the size (`table_path`): up to
`MAX_SHARED_SIZE` the node table is staged in shared memory
(`PATH_SHARED`); above it each pixel gathers its packed corner row
(`PATH_GATHER`); and 4 pixels a thread where the planes allow it.
`lut3d_path` says which (csrc/lut.cu's header gives the design and what
bounds it).

The wrapper counts its kernel launches in ``lut3d.launches``.
"""

from __future__ import annotations

import torch

from tpuvf_torch.kernels import _build
from tpuvf_torch.kernels.color import quant
from tpuvf_torch.kernels.filter import apply_lut_t_plain


# csrc/lut.cu kPathGather, kPathShared
PATH_GATHER, PATH_SHARED = 0, 1
PATH_NAMES = {PATH_GATHER: "packed row gather",
              PATH_SHARED: "shared-memory nodes"}
MAX_SHARED_SIZE = 23  # csrc/lut.cu kMaxSharedSize: 23^3 float4 nodes


def table_path(size: int) -> int:
    """The table path the launcher takes for a size (csrc/lut.cu
    `table_path`)."""
    return PATH_SHARED if size <= MAX_SHARED_SIZE else PATH_GATHER


def lut3d_plain(rgba: torch.Tensor, table: torch.Tensor, size: int,
                quantize: bool = False) -> torch.Tensor:
    """(4, H, W) float32 -> (4, H, W) float32, or uint8 RGBA planes
    quantized as the render target stores them when `quantize`."""
    chans = apply_lut_t_plain(tuple(rgba.unbind(-3)), table, size)
    if quantize:
        chans = tuple(quant(c) for c in chans)
    return torch.stack(chans, dim=-3)


def _check(rgba: torch.Tensor, table: torch.Tensor, size: int) -> None:
    if rgba.dtype != torch.float32 or table.dtype != torch.float32:
        raise TypeError(f"lut3d: expected float32 planes and table, got "
                        f"{rgba.dtype} and {table.dtype}")
    if rgba.dim() != 3 or rgba.shape[0] != 4:
        raise ValueError(f"lut3d: expected (4, H, W) planes, got "
                         f"{tuple(rgba.shape)}")
    if not 2 <= size <= 64 or tuple(table.shape) != (size ** 3, 24):
        raise ValueError(f"lut3d: table {tuple(table.shape)} is not the "
                         f"corner-packed ({size}^3, 24) table of size {size}")
    if table.device != rgba.device:
        raise ValueError(f"lut3d: table on {table.device}, planes on "
                         f"{rgba.device}")
    if rgba.device.type not in ("cpu", "cuda"):
        raise ValueError(f"lut3d: unsupported device {rgba.device}")


def lut3d(rgba: torch.Tensor, table: torch.Tensor, size: int,
          quantize: bool = False) -> torch.Tensor:
    """K3: trilinear lookup of the (4, H, W) float32 planes r, g, b, a in the
    corner-packed float32 (S^3, 24) table; alpha passes through."""
    _check(rgba, table, size)
    if rgba.device.type == "cpu":
        return lut3d_plain(rgba, table, size, quantize)
    if not (rgba.is_contiguous() and table.is_contiguous()):
        raise ValueError("lut3d: the kernel needs contiguous planes and table")
    out = torch.empty(rgba.shape, device=rgba.device,
                      dtype=torch.uint8 if quantize else torch.float32)
    n = rgba.shape[1] * rgba.shape[2]
    if n == 0:
        return out
    stream = torch.cuda.current_stream(rgba.device).cuda_stream
    err = _build.load().lut3d_trilinear_f32(
        rgba.data_ptr(), table.data_ptr(), size, n, out.data_ptr(),
        int(quantize), stream)
    if err != 0:
        raise RuntimeError(f"lut3d_trilinear_f32 launch failed: cudaError {err}")
    lut3d.launches += 1
    return out


lut3d.launches = 0


def lut3d_path(rgba: torch.Tensor, out: torch.Tensor, size: int) -> str:
    """The paths K3's launcher takes for these planes and this output (its
    exported query), e.g. "shared-memory nodes, 4 pixels a thread"."""
    code = _build.load().lut3d_path(rgba.data_ptr(), out.data_ptr(), size,
                                    rgba.shape[1] * rgba.shape[2],
                                    int(out.dtype == torch.uint8))
    return (PATH_NAMES[code & 3]
            + (", 4 pixels a thread" if code & 4 else ", 1 pixel a thread"))
