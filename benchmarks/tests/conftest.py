"""The benchmark's own tests. Card-only cases carry the ``cuda`` marker and
decide inside the test whether a card is there."""


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs an NVIDIA card; skips without one")
