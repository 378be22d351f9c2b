"""CPU tests of the benchmark harness (``python -m pytest crane_bench/tests``).
Tests that need the card carry the ``chip`` marker and skip without one,
deciding inside the test."""

import torch


def pytest_configure(config):
    config.addinivalue_line("markers", "chip: needs an NVIDIA card; skips without one")
    torch.set_num_threads(2)
