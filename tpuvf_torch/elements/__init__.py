"""Element implementations (import side effect: registry population)."""

from tpuvf_torch.elements import (  # noqa: F401
    compositor,
    convertscale,
    sinks,
    sources,
    testsrc,
    videofilter,
)
