"""Multi-host (multi-process) execution via ``jax.distributed``.

The reference scales across machines by giving every node the SAME query
file and a DIFFERENT database shard, then merging TSVs offline
(/root/reference/kmcp/cmd/merge.go; README "Scalable searching",
search.go:123-126).  Here that becomes one SPMD program over a global
mesh:

- axis ``t`` spans PROCESSES: each host owns its target shard of the bit
  matrix (the sub-database), so DB rows never cross hosts;
- axis ``d`` spans each host's local devices: local batch parallelism
  over the (replicated) read batch;
- per-target counts come back sharded (d, t); cross-host reductions
  (total matches, global best) ride the interconnect — the on-device
  equivalent of the offline ``kmcp merge``.

``jax.distributed.initialize()`` needs the coordinator address, process
count and process id (arguments or the environment below); for tests
this runs as N CPU processes with Gloo collectives (verified 2x4
virtual devices).

Note: call :func:`init_distributed` BEFORE any other jax API touches the
backend — platform selection must precede client creation.
"""

from __future__ import annotations

import os

import numpy as np


def init_distributed(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    cpu_devices_per_process: int | None = None,
):
    """Initialize ``jax.distributed`` from args or environment.

    Environment fallbacks: KMCP_TPU_COORDINATOR, KMCP_TPU_NUM_PROCS,
    KMCP_TPU_PROC_ID.  ``cpu_devices_per_process`` forces the CPU
    platform with that many virtual devices (testing / CPU clusters);
    leave it None to use each process's accelerators.
    """
    coordinator_address = coordinator_address or os.environ.get(
        "KMCP_TPU_COORDINATOR"
    )
    if num_processes is None and "KMCP_TPU_NUM_PROCS" in os.environ:
        num_processes = int(os.environ["KMCP_TPU_NUM_PROCS"])
    if process_id is None and "KMCP_TPU_PROC_ID" in os.environ:
        process_id = int(os.environ["KMCP_TPU_PROC_ID"])

    if cpu_devices_per_process:
        flags = os.environ.get("XLA_FLAGS", "")
        if "host_platform_device_count" not in flags:
            os.environ["XLA_FLAGS"] = (
                f"{flags} --xla_force_host_platform_device_count="
                f"{cpu_devices_per_process}"
            ).strip()
        import jax

        jax.config.update("jax_platforms", "cpu")
    import jax

    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
    )
    return jax.process_index(), jax.process_count()


def make_multihost_mesh():
    """Global (d, t) mesh with ``t`` spanning processes.

    Device grid column j holds process j's devices, so a P(None, 't')
    array gives each host its own target shard (per-host sub-database
    ownership) while P('d', ...) arrays shard over each host's local
    devices and replicate across hosts (the shared read batch)."""
    import jax
    from jax.sharding import Mesh

    nproc = jax.process_count()
    per = jax.local_device_count()
    grid = np.empty((per, nproc), dtype=object)
    # deterministic layout: column j = process j's devices in id order
    byproc: dict[int, list] = {}
    for dev in jax.devices():
        byproc.setdefault(dev.process_index, []).append(dev)
    for j in range(nproc):
        col = sorted(byproc[j], key=lambda d: d.id)
        for i in range(per):
            grid[i, j] = col[i]
    return Mesh(grid, axis_names=("d", "t"))


def bits_to_global(mesh, bits_local: np.ndarray):
    """Assemble the global bit matrix from each host's shard columns.

    Every process passes ONLY its own [S, W_local] words; the result is
    a [S, sum(W_local)] jax.Array sharded P(None, 't') whose shard for
    this host never leaves it."""
    from jax.experimental import multihost_utils
    from jax.sharding import PartitionSpec as P

    return multihost_utils.host_local_array_to_global_array(
        bits_local, mesh, P(None, "t")
    )


def reads_to_global(mesh, loc: np.ndarray, mask: np.ndarray):
    """Place the (identical on every host) read batch onto the mesh,
    sharded over the local-device axis ``d``."""
    from jax.experimental import multihost_utils
    from jax.sharding import PartitionSpec as P

    return (
        multihost_utils.host_local_array_to_global_array(
            loc, mesh, P("d", None, None)
        ),
        multihost_utils.host_local_array_to_global_array(
            mask, mesh, P("d", None)
        ),
    )


def make_multihost_search_step(mesh, num_hashes: int = 1, min_count: int = 10):
    """The sharded count/threshold step over the global mesh (same math
    as sharding.make_sharded_search_step; documented there)."""
    from .sharding import make_sharded_search_step

    return make_sharded_search_step(mesh, num_hashes=num_hashes)


def allgather_counts(counts):
    """Collect the (d, t)-sharded per-target counts onto every host —
    the in-program equivalent of the offline TSV merge."""
    from jax.experimental import multihost_utils

    return np.asarray(multihost_utils.process_allgather(counts, tiled=True))
