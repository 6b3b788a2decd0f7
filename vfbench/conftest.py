"""pytest settings of the benchmark's own tests (``python -m pytest
vfbench/tests``): the marker of the tests that need a CUDA card."""


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card; skips where there is none")
