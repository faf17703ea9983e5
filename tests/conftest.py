"""Shared fixtures.  NOTE: no XLA_FLAGS here — unit tests run on the real
single CPU device; anything needing a multi-device mesh spawns a subprocess
(see test_collectives.py) so the dry-run's 512-device forcing never leaks
into this session."""

import numpy as np
import pytest


@pytest.fixture(scope="session")
def sf5():
    from repro.core.topology import slim_fly
    return slim_fly(5)


@pytest.fixture(scope="session")
def df4():
    from repro.core.topology import dragonfly
    return dragonfly(4)


@pytest.fixture(scope="session")
def rt0():
    from repro.dist.sharding import Runtime
    return Runtime(mesh=None)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a CUDA device; the test skips itself without one")
