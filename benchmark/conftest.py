"""pytest settings of the benchmark's own tests (`python -m pytest benchmark/`)."""


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card; skipped (inside the test) where there is none")
