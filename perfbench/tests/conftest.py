def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "cuda: needs an NVIDIA GPU and nvcc (a CUDA kernel has no CPU "
        "mode); skipped without one")
