"""Test config: the CPU backend with 8 virtual devices, so sharding logic is
tested without several cards (SURVEY.md §4.5). Must run before jax imports.

JAX_PLATFORMS defaults to cpu here; the GPU-marked tests run on the card
with JAX_PLATFORMS=cuda (see pytest.ini) and skip wherever the first device
is not a GPU."""

import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax

# NO persistent compilation cache for the test suite: the XLA:CPU AOT
# deserializer crashes the whole pytest process on bad cache entries —
# observed both from executables compiled on a host with different CPU
# features and from entries truncated by a killed previous run. The
# cross-run compile savings are not worth it.

import numpy as np
import pytest


@pytest.fixture(autouse=True, scope="module")
def _clear_jax_caches_between_modules():
    """Drop compiled executables after each test module: ~197 tests of
    accumulated XLA:CPU JIT state in one process reproducibly crashed the
    compiler around test #160 (in whatever path produced the next
    executable, while the same module passes standalone). Per-module
    clearing keeps within-module reuse and resets the compiler state well
    before that point."""
    yield
    jax.clear_caches()


@pytest.fixture
def gpu():
    """The first JAX device, when it is a GPU; skips the test otherwise.
    Decided here at run time, never at import (pytest-xdist workers must
    collect identical test lists)."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip(f"needs a GPU; JAX's first device is {dev.platform}")
    return dev


@pytest.fixture
def rng():
    return np.random.default_rng(1234)
