import warnings

warnings.filterwarnings("ignore")

# NOTE: no XLA_FLAGS here — smoke tests and benches must see 1 CPU device.
# Only launch/dryrun.py forces 512 virtual devices (and only in its own
# process).

import numpy as np
import pytest


@pytest.fixture
def rng():
    return np.random.default_rng(0)


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "cuda: needs an NVIDIA GPU and nvcc (a CUDA kernel has no CPU "
        "mode); skipped without one")
