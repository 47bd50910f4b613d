"""The benchmark's own tests (``python -m pytest benchmark -q``). Tests that
need a CUDA card carry the ``cuda`` marker and skip without one, deciding
in the ``cuda_device`` fixture."""
import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA card; skips without one")


@pytest.fixture
def cuda_device():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card")
    return "cuda"
