"""Registers the marker of tests that need an NVIDIA card."""


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a CUDA card; skips on a machine without one")
