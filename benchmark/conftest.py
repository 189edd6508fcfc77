"""Settings for the benchmark's own tests (``python3 -m pytest benchmark``).

Tests that need a CUDA card carry the ``chip`` marker and decide inside
the test whether a card is there; on a machine with a card run them with
``python3 -m pytest benchmark -m chip``.
"""

import os

os.environ.setdefault("USE_FLAX", "0")


def pytest_configure(config):
    config.addinivalue_line("markers", "chip: needs a CUDA card; skips without one")
