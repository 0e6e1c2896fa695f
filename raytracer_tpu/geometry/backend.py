"""The one platform decision: which closest-hit implementation runs.

Every render and gradient path asks `intersectors()` instead of testing the
backend itself, so the choice lives in one place:

* ``"gpu"``: the Pallas-Triton kernel (ops/closest_hit.py) for the forward
  render, and its stop-gradient wrapper for the gradient and edge tracers;
* ``"cpu"``: the dense XLA search (geometry/intersect.py) — the test
  platform, chosen explicitly with ``JAX_PLATFORMS=cpu``;
* anything else raises: no path falls back silently to another platform's
  implementation.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import jax

from raytracer_tpu.geometry.intersect import (
    closest_hit_pallas,
    closest_hit_t_prim,
    intersect_scene,
    intersect_scene_pallas_diff,
)


class Intersectors(NamedTuple):
    # (scene, origin, direction) -> (t (N,), prim (N,) i32): the forward
    # render's closest hit (integrator/wavefront.regen_core).
    closest_hit: Callable
    # (scene, origin, direction) -> HitRecord for integrator.wavefront.trace's
    # intersect_fn. Both choices carry gradients to the scene: the dense
    # search natively, the kernel's wrapper by recomputing the winner's t.
    hit_record: Callable


def intersectors(platform: str | None = None) -> Intersectors:
    """Closest-hit implementations for `platform` (default: JAX's default
    backend)."""
    platform = platform or jax.default_backend()
    if platform == "gpu":
        return Intersectors(closest_hit_pallas, intersect_scene_pallas_diff)
    if platform == "cpu":
        return Intersectors(closest_hit_t_prim, intersect_scene)
    raise ValueError(f"no closest-hit implementation for platform {platform!r}")
