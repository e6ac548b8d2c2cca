"""Test configuration: force an 8-virtual-device CPU platform so multi-device
sharding paths are exercised without accelerator hardware, plus the seeded
fixtures the reference suite relies on (tests/conftest.py:54-99).

``-m gpu`` selects the card-only tier (tests/gpu/) and leaves the platform
to JAX, so those tests run on the GPU; every other selection runs on the CPU.
Whether a card is present is decided inside the ``gpu`` fixture, never at
import or collection time.

JAX is imported lazily here: its platform setting is read from the
environment when it is first imported, after pytest_configure has run.
"""

import os

import numpy as np
import pytest


def _selects_gpu_tier(markexpr: str) -> bool:
    return "gpu" in markexpr and "not gpu" not in markexpr


def pytest_configure(config):
    for marker in ("unit", "integration", "e2e", "slow", "multidevice"):
        config.addinivalue_line("markers", f"{marker}: {marker} tests")
    config.addinivalue_line(
        "markers", "gpu: needs a GPU (compiled kernels); skips elsewhere")
    if not _selects_gpu_tier(config.option.markexpr or ""):
        os.environ["JAX_PLATFORMS"] = "cpu"
        flags = os.environ.get("XLA_FLAGS", "")
        if "xla_force_host_platform_device_count" not in flags:
            os.environ["XLA_FLAGS"] = (
                flags + " --xla_force_host_platform_device_count=8").strip()


@pytest.fixture
def gpu():
    """The first JAX device; skips the test unless it is a GPU."""
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip(f"needs a GPU; JAX found {dev.platform!r}")
    return dev


@pytest.fixture(autouse=True)
def _seed_everything():
    np.random.seed(42)
    yield


@pytest.fixture
def key():
    import jax

    return jax.random.key(42)


@pytest.fixture
def small_problem():
    """16-spin random +-J instance."""
    from spinglass_tpu.core import topology
    from spinglass_tpu.core.problem import IsingProblem

    j = topology.fully_connected(16, dist="binary", seed=7)
    h = np.random.default_rng(7).normal(0, 0.5, 16)
    return IsingProblem.from_dense(j, h)


@pytest.fixture
def grid_problem():
    """8x8 2D grid (2-colorable) ferromagnet with weak fields."""
    from spinglass_tpu.core import topology
    from spinglass_tpu.core.problem import IsingProblem

    j = topology.grid_2d(8, 8, dist="ferromagnetic", scale=1.0, seed=3)
    return IsingProblem.from_dense(j, np.zeros(64))
