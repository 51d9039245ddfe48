"""pytest settings of the benchmark's own tests (``slambench/tests``):
the ``card`` marker, for tests that need a CUDA device. Such a test
decides inside itself whether there is one, and skips when not."""


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA device; skips without one")
