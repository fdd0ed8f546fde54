"""Test configuration: run tests on a virtual 8-device CPU mesh.

Tests validate correctness and multi-device sharding on the host platform
(fast, deterministic), per the multi-host-testing strategy in SURVEY.md §4.
Tests marked ``gpu`` need a card and skip elsewhere; on a machine with one
run them with ``MITSUBA_TEST_GPU=1 python -m pytest -m gpu tests/`` (the
CPU platform is then not forced).
"""
import os

ON_GPU = os.environ.get("MITSUBA_TEST_GPU") == "1"
if not ON_GPU:
    os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()
os.environ.setdefault("JAX_ENABLE_X64", "0")

import jax

if not ON_GPU:
    jax.config.update("jax_platforms", "cpu")

import numpy as np
import pytest

# Fast smoke tier: `pytest -m quick` runs these modules (< 90 s total on the
# 8-device CPU mesh), so round-trip iteration doesn't pay the 17-minute full
# suite.  Keep a module here only while its wall time stays a few seconds.
QUICK_MODULES = {
    "test_core.py", "test_io.py", "test_numerics.py", "test_statistics.py",
    "test_sunsky.py", "test_mtsimport.py", "test_rtrans.py",
    "test_native_mesh.py", "test_intersect.py",
}


def pytest_collection_modifyitems(config, items):
    for item in items:
        mod = item.nodeid.split("::")[0].rsplit("/", 1)[-1]
        if mod in QUICK_MODULES:
            item.add_marker(pytest.mark.quick)
    # `slow` trumps `quick`: the fast tier must actually stay fast, so
    # heavyweight cases inside quick modules/classes are deselected here
    if "quick" in (config.option.markexpr or ""):
        slow = [it for it in items if it.get_closest_marker("slow")]
        if slow:
            items[:] = [it for it in items
                        if not it.get_closest_marker("slow")]
            config.hook.pytest_deselected(items=slow)


@pytest.fixture
def rng():
    return np.random.default_rng(42)


@pytest.fixture
def gpu_device():
    """The first GPU; skips where JAX finds none (decided at test time so
    every xdist worker collects the same tests)."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip(f"needs a GPU, JAX found {dev.platform}; on a card run "
                    "MITSUBA_TEST_GPU=1 python -m pytest -m gpu tests/")
    return dev
