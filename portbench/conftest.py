"""Registers the marker of the benchmark's tests that need a CUDA card."""


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA device; skips without one")
