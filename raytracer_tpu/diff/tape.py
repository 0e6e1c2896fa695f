"""Tape-replay differentiable rendering: fast forward, cheap backward.

`render_linear_diff` (diff/grad.py) differentiates the whole wavefront scan:
every bounce — forward AND rematerialized backward — searches ALL primitives
for the closest hit, even though the discrete winner is frozen anyway
(straight-through argmin; see grad.py). At LARGE primitive counts that
search dominates an inverse-render step (at small ones the per-bounce
shade/state glue does — see the measurements below).

This module splits the estimator into the two halves the math already has:

1. **Tape forward (non-differentiable)** — trace the batch with the fast
   path (the platform's closest hit, geometry.backend) on stop-gradient inputs,
   recording ONLY the winning primitive id per (bounce, lane): the
   (max_depth, N) i32 tape. Everything discrete about the path — which
   primitive, which dielectric branch, metal absorb, termination — is a
   deterministic function of (tape, injected uniforms), so nothing else
   needs storing.

2. **Replay (differentiable)** — the SAME checkpointed scan integrator, but
   its intersector looks the winner up on the tape and recomputes only that
   one primitive's t/normal/uv differentiably (_winner_t_diff +
   resolve_hits — O(1) per lane instead of O(primitives)). Radiance and
   every gradient path (hit-point chains, scatter directions, the
   dielectric likelihood-ratio factor) are bit-for-bit the computation
   graph of the scan backend minus the losing candidates — which never
   carried gradient anyway (they are where'd out by the frozen argmin).

Estimator identity: replay radiance == scan radiance for the same injected
uniforms (pinned by test); gradients agree to fp tolerance.

Cost: the replay eliminates backward re-intersection but adds a third loop
pass, so it can pay off only when intersection dominates the step, i.e. at
large primitive counts. The crossover against the scan backend
(render_linear_diff) has not been measured on the GPU.

The reference has no autodiff (SURVEY.md §2.2); both backends serve the
BASELINE.md gradient axis. Visibility boundary terms remain diff/boundary
and diff/shadow_edge — tape replay, like the scan, freezes discrete
visibility.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from raytracer_tpu.core.camera import Camera, camera_frame, camera_rays
from raytracer_tpu.geometry.intersect import (
    DEFAULT_T_MIN,
    _winner_t_diff,
    quad_derived,
    resolve_hits,
)
from raytracer_tpu.geometry.scene import Scene
from raytracer_tpu.integrator.wavefront import trace
from raytracer_tpu.materials.materials import UNIFORMS_PER_BOUNCE


def make_tape_intersect_fn(tape, t_min: float = DEFAULT_T_MIN):
    """Intersector that replays a recorded (max_depth, N) winner tape.

    Row `bounce`, lane L holds the winning primitive id (-1 = miss or lane
    already dead — dead lanes are skipped by the integrator's own alive
    mask, so the two share an encoding). The winner's t is recomputed
    differentiably from the CURRENT scene/ray values, so gradients flow
    exactly as in the dense backend's frozen-argmin path.
    """

    def fn(scene, origin, direction, bounce):
        prim = jax.lax.dynamic_index_in_dim(tape, bounce, 0, keepdims=False)
        hit = prim >= 0
        qd = quad_derived(scene)
        t_nd = jnp.where(hit, 1.0, jnp.inf)
        t = _winner_t_diff(
            scene, qd, origin, direction, jnp.maximum(prim, 0), t_nd, t_min
        )
        return resolve_hits(
            scene, qd, origin, direction, t, jnp.maximum(prim, 0)
        )

    fn.takes_bounce = True
    return fn


def trace_tape(
    scene: Scene,
    origin,
    direction,
    uniform_seq,
    background,
    *,
    max_depth: int,
    sky_gradient: bool = False,
):
    """Differentiable radiance via tape replay (same signature contract as
    trace(differentiable=True) with injected uniforms).

    `uniform_seq` (max_depth, N, UNIFORMS_PER_BOUNCE) MUST be provided: the
    tape pins the discrete decisions the forward made, and the replay must
    consume the identical randomness to reproduce them.
    """
    from raytracer_tpu.geometry.backend import intersectors

    sg = jax.lax.stop_gradient
    _, tape = trace(
        sg(scene),
        sg(origin),
        sg(direction),
        jax.random.PRNGKey(0),  # unused: uniforms injected
        sg(background),
        max_depth=max_depth,
        sky_gradient=sky_gradient,
        uniform_seq=sg(uniform_seq),
        intersect_fn=intersectors().hit_record,
        return_tape=True,
    )
    return trace(
        scene,
        origin,
        direction,
        jax.random.PRNGKey(0),
        background,
        max_depth=max_depth,
        sky_gradient=sky_gradient,
        differentiable=True,
        uniform_seq=uniform_seq,
        intersect_fn=make_tape_intersect_fn(tape),
        intersect_fn_differentiable=True,  # O(1) gathers, no pallas inside
    )


@partial(
    jax.jit,
    static_argnames=("width", "height", "samples_per_pass", "max_depth", "sky_gradient"),
)
def render_linear_tape(
    scene: Scene,
    cam: Camera,
    key,
    *,
    width: int,
    height: int,
    samples_per_pass: int,
    max_depth: int,
    sky_gradient: bool = False,
):
    """Drop-in alternative to diff.grad.render_linear_diff: per-pixel mean
    linear radiance, differentiable w.r.t. scene AND camera, using tape
    replay instead of the in-graph primitive search."""
    n = width * height
    k = samples_per_pass
    frame = camera_frame(cam, width, height)
    pix = jax.lax.broadcasted_iota(jnp.int32, (k * n, 1), 0)[:, 0] % n
    key_cam, key_u = jax.random.split(key)
    cam_uniforms = jax.random.uniform(key_cam, (k * n, 4), jnp.float32)
    origin, direction = camera_rays(frame, pix % width, pix // width, cam_uniforms)
    uniform_seq = jax.random.uniform(
        key_u, (max_depth, k * n, UNIFORMS_PER_BOUNCE), jnp.float32
    )
    radiance = trace_tape(
        scene,
        origin,
        direction,
        uniform_seq,
        cam.background,
        max_depth=max_depth,
        sky_gradient=sky_gradient,
    )
    return radiance.reshape(k, n, 3).mean(axis=0).reshape(height, width, 3)
