"""pytest settings of the benchmark's own tests (``python -m pytest splatbench/tests``)."""


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card; decided inside the test, which skips without one")
