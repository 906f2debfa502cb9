"""Test configuration: run all JAX tests on a virtual 8-device CPU mesh.

Environment must be set before jax is first imported anywhere in the process;
pytest imports this conftest before any test module.
"""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import numpy as np
import pytest

from bang_jax.formats import synthetic


@pytest.fixture(scope="session")
def tiny_index(tmp_path_factory):
    """A small on-disk synthetic index bundle shared by end-to-end tests."""
    prefix = str(tmp_path_factory.mktemp("index") / "tiny")
    info = synthetic.build_synthetic_index(
        prefix, n=4000, dim=48, r=24, m=12, n_queries=128, k=10, seed=3
    )
    return info


@pytest.fixture(scope="session")
def tiny_uint8_index(tmp_path_factory):
    prefix = str(tmp_path_factory.mktemp("index_u8") / "tiny_u8")
    info = synthetic.build_synthetic_index(
        prefix, n=3000, dim=32, r=20, m=8, n_queries=64, k=10, dtype=np.uint8, seed=5
    )
    return info
