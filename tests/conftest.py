import pytest


def pytest_configure(config):
    config.addinivalue_line("markers",
                            "slow: multi-device subprocess tests")
    config.addinivalue_line("markers",
                            "cuda: needs an NVIDIA GPU (skips without one)")
