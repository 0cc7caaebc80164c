"""Test configuration: an 8-virtual-device CPU backend by default.

Tests are hermetic CPU runs; multi-chip sharding is exercised on the
virtual device mesh, per the multi-host test strategy in SURVEY.md §4.
JAX_PLATFORMS defaults to cpu here; tests marked `chip` compare the
compiled GPU ops with their references and skip unless the run is given
a GPU (`JAX_PLATFORMS=cuda,cpu python -m pytest -m chip tests/`).
"""
import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture
def rng():
    return np.random.default_rng(0)
