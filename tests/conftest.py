import os
import sys

# tests must see ONE cpu device (the dry-run alone uses 512 host devices)
os.environ.setdefault("JAX_PLATFORMS", "cpu")
sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import numpy as np
import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a CUDA card (skips without one, decided at "
        "run time inside a fixture)")


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(0)
