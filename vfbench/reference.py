"""The plain reference of each configuration, in plain PyTorch.

It follows the vfmetal shaders' arithmetic literally (the Metal sampler with
half-texel centres and clamp to edge, limited-range BT.601/BT.709 YUV to RGB,
the video filter's adjustment chain, the compositor's premultiplied
blends with the 8-bit render target quantized after each draw, the overlay's
mix), element by element in the precision it is given: float32 for the
reference, a lower one for the control.  It reads only the host frames, the
configuration's sizes and the schedules' values, and works out every plane,
tap and draw again; it imports nothing of the program.

`Reference` holds that arithmetic; each kind of configuration composes it
in a file of its own, ``vfbench/references/<kind>.py``, found by the
``kind`` of the configuration's reference description.  Every kind returns
the output frame in its host byte layout: an (H, W, 4) uint8 tensor, BGRA
byte order for a BGRA output.
"""

from __future__ import annotations

import importlib.util
import re
from pathlib import Path

import numpy as np
import torch

HERE = Path(__file__).resolve().parent
NAME_RE = re.compile(r"^[A-Za-z0-9_]+$")

YUV_OFFSET = (16.0 / 255.0, 128.0 / 255.0, 128.0 / 255.0)
YUV_TO_RGB = {
    "bt601": ((1.164383, 0.0, 1.596027),
              (1.164383, -0.391762, -0.812968),
              (1.164383, 2.017232, 0.0)),
    "bt709": ((1.164383, 0.0, 1.792741),
              (1.164383, -0.213249, -0.532909),
              (1.164383, 2.112402, 0.0)),
}
LUMA = (0.2126, 0.7152, 0.0722)
OPERATORS = {"source": 0, "over": 1, "add": 2}


class Reference:
    """The reference on `device`, its arithmetic in `dtype`."""

    def __init__(self, device="cpu", dtype=torch.float32):
        self.device = torch.device(device)
        self.dtype = dtype
        self._kinds = {}

    # -- elements of the arithmetic ----------------------------------------

    def const(self, v):
        return torch.tensor(v, dtype=self.dtype, device=self.device)

    def dequant(self, x: torch.Tensor) -> torch.Tensor:
        """A Unorm8 read: v / 255."""
        return x.to(self.device).to(self.dtype) / self.const(255.0)

    @staticmethod
    def quant(x: torch.Tensor) -> torch.Tensor:
        """A Unorm8 write: round(clamp(v, 0, 1) * 255), half to even."""
        return torch.round(torch.clamp(x.float(), 0.0, 1.0) * 255.0).to(
            torch.uint8)

    def bilinear(self, plane: torch.Tensor, out_w: int, out_h: int):
        """The Metal sampler (linear, clamp to edge) of a (h, w) plane at
        the centres of an out_h x out_w grid spanning it."""
        h, w = plane.shape

        def taps(n_out, n_in):
            t = (np.arange(n_out, dtype=np.float64) + 0.5) / n_out
            s = t * n_in - 0.5
            i0 = np.floor(s)
            f = (s - i0).astype(np.float32)
            i0 = i0.astype(np.int64)
            lo = torch.from_numpy(np.clip(i0, 0, n_in - 1)).to(self.device)
            hi = torch.from_numpy(np.clip(i0 + 1, 0, n_in - 1)).to(self.device)
            return lo, hi, torch.from_numpy(f).to(self.device).to(self.dtype)

        x0, x1, fx = taps(out_w, w)
        y0, y1, fy = taps(out_h, h)
        one = self.const(1.0)
        top = plane[y0][:, x0] * (one - fx) + plane[y0][:, x1] * fx
        bot = plane[y1][:, x0] * (one - fx) + plane[y1][:, x1] * fx
        return top * (one - fy)[:, None] + bot * fy[:, None]

    def yuv_to_rgb(self, y, u, v, matrix: str):
        m = YUV_TO_RGB[matrix]
        yo = y - self.const(YUV_OFFSET[0])
        uo = u - self.const(YUV_OFFSET[1])
        vo = v - self.const(YUV_OFFSET[2])
        out = []
        for row in m:
            c = (self.const(row[0]) * yo + self.const(row[1]) * uo
                 + self.const(row[2]) * vo)
            out.append(torch.clamp(c, 0.0, 1.0))
        return out

    def source_rgba(self, frame, fmt: str, width: int, height: int):
        """A host frame -> [r, g, b, a] planes in [0, 1], at its own size
        (a 4:2:0 frame's chroma sampled up by the Metal sampler)."""
        if fmt in ("BGRA", "RGBA"):
            px = torch.as_tensor(np.asarray(frame)).to(self.device)
            order = (2, 1, 0, 3) if fmt == "BGRA" else (0, 1, 2, 3)
            return [self.dequant(px[..., c]) for c in order]
        if fmt in ("NV12", "I420"):
            y = self.dequant(torch.as_tensor(np.asarray(frame["y"])))
            if fmt == "NV12":
                uv = torch.as_tensor(np.asarray(frame["uv"]))
                u, v = uv[:, 0::2], uv[:, 1::2]
            else:
                u = torch.as_tensor(np.asarray(frame["u"]))
                v = torch.as_tensor(np.asarray(frame["v"]))
            u = self.bilinear(self.dequant(u), width, height)
            v = self.bilinear(self.dequant(v), width, height)
            r, g, b = self.yuv_to_rgb(y, u, v, matrix_for(height))
            return [r, g, b, torch.ones_like(r)]
        raise ValueError(f"reference: no source format {fmt!r}")

    @staticmethod
    def host_layout(rgba_u8: list, fmt: str) -> torch.Tensor:
        """[r, g, b, a] uint8 planes -> the (H, W, 4) host bytes."""
        order = (2, 1, 0, 3) if fmt == "BGRA" else (0, 1, 2, 3)
        return torch.stack([rgba_u8[c] for c in order], dim=-1)

    def overlay(self, canvas: list, ov: dict) -> list:
        """vfoverlay's mix of a straight-alpha image, premultiplied as it
        is decoded, at its own size at (x, y): c = v (1 - a) + o a with
        a = o_alpha, channels 0-2; the canvas keeps its alpha."""
        H, W = canvas[0].shape
        x0, y0 = max(ov["x"], 0), max(ov["y"], 0)
        x1, y1 = min(ov["x"] + ov["width"], W), min(ov["y"] + ov["height"], H)
        if x1 <= x0 or y1 <= y0:
            return canvas
        r, g, b, a = (float(v) for v in ov["rgba"])
        pm = np.round(np.float32([r, g, b]) * np.float32(a / 255.0))
        o = [self.const(float(v)) / self.const(255.0) for v in pm]
        oa = self.const(a) / self.const(255.0)
        one = self.const(1.0)
        out = [c.clone() for c in canvas]
        for c in range(3):
            dv = self.dequant(canvas[c][y0:y1, x0:x1])
            out[c][y0:y1, x0:x1] = self.quant(dv * (one - oa) + o[c] * oa)
        return out

    def frame(self, ref: dict, frames: dict, values: dict) -> torch.Tensor:
        """One output frame of the configuration described by `ref`, from
        its sources' host frames and the frame's scheduled `values`: the
        function ``frame`` of ``vfbench/references/<ref["kind"]>.py``."""
        kind = ref["kind"]
        if kind not in self._kinds:
            path = HERE / "references" / f"{kind}.py"
            if not NAME_RE.match(kind) or not path.exists():
                raise ValueError(f"reference: no configuration kind {kind!r}")
            spec = importlib.util.spec_from_file_location(
                f"vfbench.references.{kind}", path)
            module = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(module)
            self._kinds[kind] = module
        return self._kinds[kind].frame(self, ref, frames, values)


def matrix_for(height: int) -> str:
    """GStreamer's default colorimetry: BT.709 above 576 lines."""
    return "bt709" if height > 576 else "bt601"
