"""Element implementations (import side effect: registry population)."""

from tpuvf_torch.elements import (  # noqa: F401
    compositor,
    convertscale,
    deinterlace,
    overlay,
    sinks,
    sources,
    testsrc,
    transform,
    videofilter,
)
