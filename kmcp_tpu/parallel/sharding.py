"""Multi-device sharded search: the single-program replacement for the
reference's cluster story.

The reference scales by sharding the database into independent sub-DBs,
running one ``kmcp search`` process per node, and merging TSVs offline
(/root/reference/kmcp/cmd/merge.go; README "Scalable searching").  Here the
same structure becomes a single SPMD program over a
``jax.sharding.Mesh``:

- axis ``d``: data parallelism over the read batch (P4/P7 in SURVEY §2.9)
- axis ``t``: the bit matrix sharded by target words (P3) — each device
  gathers rows from its own shard only (gather is axis-0, shard is
  axis-1, so XLA keeps it fully local, zero communication)
- cross-shard results (per-query total matched targets, global best
  target) reduce over ``t`` with psum/argmax collectives — the
  on-device equivalent of the offline ``kmcp merge``.

Bloom-row positions are derived on host (uint64 modulo; device path keeps
to 32-bit dtypes so it runs without jax_enable_x64).
"""

from __future__ import annotations

import numpy as np


def make_mesh(n_devices: int | None = None, data_parallel: int | None = None):
    """Build a 2D (d, t) mesh over JAX's devices; raises when fewer than
    ``n_devices`` exist (virtual CPU devices come from
    ``JAX_PLATFORMS=cpu`` with --xla_force_host_platform_device_count)."""
    import jax
    from jax.sharding import Mesh

    devs = jax.devices()
    n = n_devices or len(devs)
    if len(devs) < n:
        raise RuntimeError(
            f"mesh of {n} devices requested, {len(devs)} "
            f"{devs[0].platform} device(s) available"
        )
    devs = devs[:n]
    if data_parallel is None:
        data_parallel = 2 if n % 2 == 0 and n >= 4 else 1
    t = n // data_parallel
    arr = np.array(devs[: data_parallel * t]).reshape(data_parallel, t)
    return Mesh(arr, axis_names=("d", "t"))


def make_sharded_search_step(mesh, num_hashes: int = 1):
    """Jitted multi-device search step.

    Args (logical shapes):
      bits  [S, W]   uint32 — sharded over words (axis 1) on mesh axis 't'
      loc   [B, K, h] int32 — Bloom row positions, sharded over batch 'd'
      mask  [B, K]   bool   — validity, sharded over batch 'd'

    Returns:
      counts    [B, W*32] int32 — per-target matched k-mers, sharded (d, t)
      n_matched [B]       int32 — targets with count >= threshold, global
                                  (psum over 't' inserted by XLA)
      best      [B]       int32 — global argmax target (the 'merge' step)
    """
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    min_count = 10

    def step(bits, loc, mask):
        rows = jnp.take(bits, loc, axis=0)  # [B,K,h,W]
        acc = rows[..., 0, :]
        for j in range(1, num_hashes):
            acc = acc & rows[..., j, :]
        acc = jnp.where(mask[..., None], acc, jnp.uint32(0))
        shifts = jnp.arange(32, dtype=jnp.uint32)
        bit = (acc[..., None] >> shifts) & jnp.uint32(1)
        counts = bit.astype(jnp.int32).sum(axis=1)  # [B,W,32]
        counts = counts.reshape(counts.shape[0], -1)  # [B,T]
        n_matched = (counts >= min_count).astype(jnp.int32).sum(axis=1)
        best = jnp.argmax(counts, axis=1).astype(jnp.int32)
        return counts, n_matched, best

    return jax.jit(
        step,
        in_shardings=(
            NamedSharding(mesh, P(None, "t")),
            NamedSharding(mesh, P("d", None, None)),
            NamedSharding(mesh, P("d", None)),
        ),
        out_shardings=(
            NamedSharding(mesh, P("d", "t")),
            NamedSharding(mesh, P("d")),
            NamedSharding(mesh, P("d")),
        ),
    )


def host_locations(hashes: np.ndarray, num_hashes: int, num_sigs: int) -> np.ndarray:
    from ..search.kernel import derive_locations

    return derive_locations(hashes, num_hashes, num_sigs).astype(np.int32)
