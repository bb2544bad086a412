"""The benchmark's CPU tests (helpers in ``bench_smoke.py``)."""


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: runs on a CUDA device; skips where none is present")
