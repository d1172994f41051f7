"""Test configuration: virtual 8-device CPU mesh so sharding tests run without real chips.

Mirrors the reference's tiled-vs-whole-array testing strategy (SURVEY.md §4): all kernels are
validated on CPU against independent numpy oracles, plus single-device-vs-sharded equivalence.
"""

import os

# Must be set before jax is imported anywhere. Force CPU: tests run on a virtual 8-device CPU
# mesh for speed and sharding coverage, and never open an accelerator.
os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

# jax may already have been imported with another platform; override through the config
# API too (backends are not initialized until first use).
jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(42)


@pytest.fixture(scope="session")
def ref_dem_test():
    from xdem_tpu import examples

    return examples.get_ref_dem_test()


@pytest.fixture(scope="session")
def tba_dem_test():
    from xdem_tpu import examples

    return examples.get_tba_dem_test()


@pytest.fixture(scope="session")
def ref_dem_full():
    from xdem_tpu import examples

    return examples.get_ref_dem()


@pytest.fixture(scope="session")
def tba_dem_full():
    from xdem_tpu import examples

    return examples.get_tba_dem()
