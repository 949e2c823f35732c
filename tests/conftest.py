"""Test configuration: an 8-virtual-device CPU platform.

Multi-device sharding tests use XLA's host-platform device-count emulation
(SURVEY.md §4).  Tests marked `gpu` need an NVIDIA card: `chip_smoke.py`
runs them in its own process, where JAX already runs on the GPU and the
settings below come too late to change that.
"""

import os

os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture
def rng():
    return np.random.default_rng(0)


@pytest.fixture
def gpu():
    """The first GPU device; skips the test where JAX has none."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip("needs an NVIDIA GPU (chip_smoke.py runs it on the card)")
    return dev


@pytest.fixture(autouse=True, scope="module")
def _clear_jax_caches_between_modules():
    """Bound the in-process XLA:CPU executable state.

    The full suite accumulates several hundred compiled programs in one
    process; past ~90% of the suite the XLA:CPU compiler segfaulted
    flakily in backend_compile_and_load (observed three times in round 5,
    different tests, always late in the run; every affected module passes
    in a fresh process).  Dropping the executable caches after each test
    module keeps the compiler's cumulative state small; cross-module
    recompiles cost seconds on CPU."""
    yield
    jax.clear_caches()
    import gc

    gc.collect()
