"""Device-mesh helpers for multi-chip / multi-host rendering.

The reference's only parallelism is a goroutine-per-pixel worker pool
(camera.go:167-175, 202-219). The accelerator replacement (SURVEY.md §2.2):
a `jax.sharding.Mesh` whose axes shard the wavefront ray batch —

* `tiles`: image tiles / pixel blocks (data parallel over pixels);
* `samples`: the spp budget (sample parallel — the reference has none,
  its spp loop is sequential per pixel, camera.go:256-260).

The cards of one GPU host reach each other all to all over NVLink, so the
mesh shape follows the algorithm alone. Across hosts (one process per host,
each driving its local cards) `samples` stays within a host, so the only
cross-host traffic is the final per-pixel sum and the `psum` of
scene-parameter gradients.
"""

from __future__ import annotations

import numpy as np
import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

TILE_AXIS = "tiles"
SAMPLE_AXIS = "samples"


def make_mesh(n_devices: int | None = None, sample_parallel: int = 1) -> Mesh:
    """Build a (tiles, samples) mesh over the first `n_devices` devices.

    `sample_parallel` devices cooperate on the same pixels (different sample
    keys); the remainder shard the pixel axis.
    """
    # Group by host first: jax.devices() order is not guaranteed to keep a
    # host's cards contiguous, and a row-major reshape of an interleaved
    # order would lay the `samples` axis across hosts — every per-pixel psum
    # would then cross the network instead of NVLink. Sorting by
    # (process_index, id) makes each reshape row (one tile / sample group)
    # host-local whenever sample_parallel <= local_device_count.
    devices = sorted(jax.devices(), key=lambda d: (d.process_index, d.id))
    if n_devices is None:
        n_devices = len(devices)
    if n_devices > len(devices):
        raise ValueError(
            f"requested n_devices={n_devices} but only {len(devices)} available"
        )
    if n_devices % sample_parallel != 0:
        raise ValueError(
            f"n_devices={n_devices} not divisible by sample_parallel={sample_parallel}"
        )
    grid = np.array(devices[:n_devices]).reshape(
        n_devices // sample_parallel, sample_parallel
    )
    return Mesh(grid, (TILE_AXIS, SAMPLE_AXIS))


def multihost_mesh(sample_parallel: int | None = None) -> Mesh:
    """Mesh for a multi-host run (call after jax.distributed.initialize):
    tiles across hosts, samples across each host's local cards."""
    n_local = jax.local_device_count()
    return make_mesh(
        jax.device_count(),
        sample_parallel=n_local if sample_parallel is None else sample_parallel,
    )


def ray_sharding(mesh: Mesh) -> NamedSharding:
    """Sharding for a flat ray/pixel-major batch axis: split over both mesh
    axes (tiles major, samples minor)."""
    return NamedSharding(mesh, P((TILE_AXIS, SAMPLE_AXIS)))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())
