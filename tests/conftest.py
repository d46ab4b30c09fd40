"""Test configuration: JAX on the CPU with 8 virtual devices unless
JAX_PLATFORMS says otherwise (the sharding tests need a mesh).

Tests that need the card carry the ``gpu`` marker and take the ``gpu``
fixture, which skips them where JAX's first device is not a GPU:

    JAX_PLATFORMS=cuda python -m pytest tests/ -m gpu
"""

import os
import sys

import pytest

os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

REFERENCE_DIR = "/root/reference"


def reference_available() -> bool:
    return os.path.isdir(REFERENCE_DIR)


@pytest.fixture
def gpu():
    """JAX's first device when it is a GPU; skips the test otherwise."""
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip(f"needs a GPU; JAX's first device is {dev.platform}")
    return dev
