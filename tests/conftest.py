"""Shared fixtures.  NOTE: no XLA_FLAGS here — tests run on 1 CPU device;
only launch/dryrun.py forces 512 placeholder devices."""
import os

import numpy as np
import pytest

try:  # optional dep (requirements-dev.txt): property tests importorskip it
    from hypothesis import settings

    # deterministic CI profile: derandomize pins the example stream to the
    # test body (no hidden per-run seed — the stale-seed wart), no deadline
    # because first-call jit compilation dwarfs any per-example budget
    settings.register_profile("ci", deadline=None, derandomize=True)
    settings.load_profile(os.environ.get("HYPOTHESIS_PROFILE", "ci"))
except ImportError:
    pass


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA card; skips (with its reason) without one")


@pytest.fixture
def rng():
    return np.random.default_rng(0)
