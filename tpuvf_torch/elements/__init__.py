"""Element implementations (import side effect: registry population)."""

from tpuvf_torch.elements import (  # noqa: F401
    convertscale,
    sinks,
    sources,
    testsrc,
    videofilter,
)
