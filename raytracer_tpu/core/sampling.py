"""Closed-form random sampling on spheres/disks, reparameterized for autodiff.

The reference uses rejection sampling loops (vec3.go:182-190 unit sphere,
vec3.go:203-210 unit disk). Rejection loops don't vectorize — each lane
would iterate a data-dependent number of times — so we use exact closed-form
(inverse-CDF) constructions over `jax.random` uniforms instead. These produce
the *same distributions* (uniform on the unit sphere / in the unit disk), which
is the level at which parity with the reference is defined (see SURVEY.md §4:
the reference is unseeded, so parity is distributional, not bitwise).

All samplers are smooth functions of their uniforms — gradients flow through
scene parameters via the reparameterization trick.
"""

from __future__ import annotations

import jax.numpy as jnp


def unit_sphere_from_uniform(u):
    """Map uniforms `u` of shape (..., 2) to uniform points on the unit sphere.

    Archimedes/cylinder construction: z uniform in [-1, 1], azimuth uniform.
    Replaces the rejection loop at vec3.go:182-190.
    """
    z = 1.0 - 2.0 * u[..., 0]
    phi = (2.0 * jnp.pi) * u[..., 1]
    r = jnp.sqrt(jnp.maximum(0.0, 1.0 - z * z))
    return jnp.stack([r * jnp.cos(phi), r * jnp.sin(phi), z], axis=-1)


def hemisphere_from_uniform(u, normal):
    """Uniform on the hemisphere around `normal`.

    API parity with vec3.go:194-201 (sample sphere, flip if against the
    normal) — a PUBLIC function the reference itself never calls (grep:
    no caller outside vec3.go; the book's alternative diffuse model).
    Kept for reference-surface parity, unused by any render path here too.
    """
    v = unit_sphere_from_uniform(u)
    sign = jnp.where(jnp.sum(v * normal, axis=-1) < 0.0, -1.0, 1.0)
    return v * sign[..., None]


def unit_disk_from_uniform(u):
    """Map uniforms `u` of shape (..., 2) to uniform points in the unit disk
    (returned as (..., 2) xy).

    Inverse-CDF: radius = sqrt(u1), angle uniform. Replaces the rejection loop
    at vec3.go:203-210 (used for the thin-lens defocus disk, camera.go:277-281).
    """
    r = jnp.sqrt(u[..., 0])
    phi = (2.0 * jnp.pi) * u[..., 1]
    return jnp.stack([r * jnp.cos(phi), r * jnp.sin(phi)], axis=-1)
