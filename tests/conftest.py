"""Registers the ``cuda`` marker: tests that need an NVIDIA GPU (the
PyTorch port's CUDA kernels). Each such test decides inside a fixture
whether a card is present and skips with a reason when it is not."""


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "cuda: needs an NVIDIA GPU (the port's CUDA kernels); skips elsewhere")
