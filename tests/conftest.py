"""Test configuration: run on a virtual 8-device CPU mesh by default.

The env vars must be set BEFORE jax is imported anywhere (SURVEY.md §4's
multi-host testing recipe the reference lacks). JAX_PLATFORMS defaults to
cpu; the tests marked `gpu` need a card and skip without one. On a
machine with a GPU they run with

    JAX_PLATFORMS=cuda,cpu python -m pytest -m gpu tests/
"""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402

jax.config.update("jax_default_matmul_precision", "highest")


@pytest.fixture()
def rng():
    # function-scoped: a session-scoped shared generator makes every
    # test's data depend on which tests ran before it (order-dependent
    # flakiness); a fresh seeded generator per test is deterministic
    # under any test selection.
    return np.random.default_rng(0)


@pytest.fixture(scope="session")
def sift_like():
    """Small synthetic SIFT-like dataset shared across tests."""
    from cvt_tpu.io.datasets import synthetic_sift
    base, queries = synthetic_sift(4096, 128, n_queries=64, seed=0)
    return base, queries


@pytest.fixture()
def gpu():
    """The default GPU device; skips the test where there is none."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip(f"needs a GPU (default device is {dev.platform})")
    return dev


@pytest.fixture()
def cpu_devices():
    """All CPU devices; skips a mesh test that gets fewer than 8."""
    devs = jax.devices("cpu")
    if len(devs) < 8:
        pytest.skip(f"needs 8 virtual CPU devices, have {len(devs)}")
    return devs
