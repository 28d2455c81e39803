"""Settings of the benchmark's own tests (``python -m pytest gpbench/tests``)."""


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs a CUDA card; runs the benchmark's command on it")
