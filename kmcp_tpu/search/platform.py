"""The one platform gate of the device search path.

The jax backend's device path (hash, count tails) is plain XLA and runs
on the GPU and, for tests and CPU-only runs, on the CPU; any other
platform has no route.  Every device-path decision that depends on the
machine reads it here.
"""

from __future__ import annotations

ROUTES = ("gpu", "cpu")


def device_route(platform: str | None = None) -> str:
    """'gpu' or 'cpu' for ``jax.devices()[0].platform`` (or the given
    platform name); any other platform has no route and raises."""
    if platform is None:
        import jax

        platform = jax.devices()[0].platform
    if platform not in ROUTES:
        raise RuntimeError(
            f"the jax search backend has no route for platform "
            f"{platform!r} (supported: {', '.join(ROUTES)})"
        )
    return platform
