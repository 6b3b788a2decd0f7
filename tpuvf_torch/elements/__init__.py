"""Element implementations (import side effect: registry population)."""

from tpuvf_torch.elements import (  # noqa: F401
    codecs,
    compositor,
    convertscale,
    deinterlace,
    overlay,
    sinks,
    sources,
    testsrc,
    transform,
    util_elements,
    videofilter,
    videosink,
)
