"""The bytes a frame's work must move, from the configuration's shapes, and
the table of peaks.

A frame reads each input byte once and writes each output byte once: every
source frame, the overlay image (its straight RGBA bytes) and the output
frame.  The least time a frame's work could take is those bytes at the
card's peak memory bandwidth.
"""

from __future__ import annotations

from vfbench.inputs import frame_bytes

# published peak memory bandwidth, bytes/s, by the name
# torch.cuda.get_device_name() gives (NVIDIA's data sheets)
PEAK_BYTES_S = {
    "NVIDIA H100 80GB HBM3": 3.35e12,  # SXM5
    "NVIDIA H100 PCIe": 2.0e12,
    "NVIDIA H100 NVL": 3.9e12,
}


def bytes_per_frame(ref: dict) -> int:
    n = sum(frame_bytes(s["format"], s["width"], s["height"])
            for s in ref["sources"].values())
    out = ref["output"]
    n += frame_bytes(out["format"], out["width"], out["height"])
    ov = ref.get("overlay")
    if ov:
        n += ov["width"] * ov["height"] * 4
    return n


def peak_bytes_s(kind: str):
    """The card's peak bandwidth, or None for a card the table lacks."""
    return PEAK_BYTES_S.get(kind)
