"""Vector math over batched `(..., 3)` float32 arrays.

Batched replacement for the reference's scalar Vec3 type
(/root/reference/internal/vec3.go:9-172): there is no vector *class* — every
op is a pure jnp function over arrays whose last axis is xyz, so a "Vec3" here
is any `(..., 3)` array and a batch of N rays is a `(N, 3)` array (SoA).
"""

from __future__ import annotations

import jax.numpy as jnp

# Reference: vec3.go:168 `nearZeroEpsilon float32 = 1e-8`.
NEAR_ZERO_EPS = 1e-8


def vec3(x, y, z, dtype=jnp.float32):
    """Build a single (3,) vector (host-side convenience)."""
    return jnp.array([x, y, z], dtype=dtype)


def dot(a, b):
    """Batched dot product over the last axis. Reference: vec3.go:136-138."""
    return jnp.sum(a * b, axis=-1)


def cross(a, b):
    """Batched cross product. Reference: vec3.go:121-134."""
    return jnp.cross(a, b)


def length_sq(a):
    """Reference: vec3.go:109-111."""
    return jnp.sum(a * a, axis=-1)


def length(a):
    """Reference: vec3.go:113-115."""
    return jnp.sqrt(length_sq(a))


def normalize(a, eps: float = 0.0):
    """Unit vector; `eps` guards 0/0 for dead/degenerate lanes.

    Reference: vec3.go:95-107 (no guard — scalar code never divides by zero on
    the hot path; batched code evaluates masked-off lanes too, hence `eps`).
    """
    return a / jnp.sqrt(length_sq(a) + eps)[..., None]


def near_zero(a):
    """All components < 1e-8 in abs. Reference: vec3.go:170-172."""
    return jnp.all(jnp.abs(a) < NEAR_ZERO_EPS, axis=-1)


def reflect(v, n):
    """Mirror reflection of `v` about unit normal `n`. Reference: vec3.go:212-214."""
    return v - 2.0 * dot(v, n)[..., None] * n


def refract(uv, n, eta_ratio):
    """Snell refraction of unit vector `uv` about unit normal `n`.

    `eta_ratio` = eta_incident / eta_transmitted, shape broadcastable to
    `uv[..., 0]`. Reference: vec3.go:216-221 (note the reference computes
    `perp` first and derives the parallel part from `1 - |perp|^2`, keeping
    that exact formulation for parity).
    """
    cos_theta = dot(-uv, n)
    perp = eta_ratio[..., None] * (uv + cos_theta[..., None] * n)
    # abs() inside sqrt matches the reference's math.Abs guard for
    # total-internal-reflection lanes (vec3.go:219); callers mask those out.
    # The 1e-12 floor keeps sqrt' finite at grazing angles for autodiff.
    par = -jnp.sqrt(jnp.maximum(jnp.abs(1.0 - length_sq(perp)), 1e-12))[..., None] * n
    return perp + par


def schlick_reflectance(cos_theta, eta_ratio):
    """Schlick's approximation. Reference: materials.go:115-119."""
    r0 = (1.0 - eta_ratio) / (1.0 + eta_ratio)
    r0 = r0 * r0
    one_minus = 1.0 - cos_theta
    return r0 + (1.0 - r0) * one_minus**5


def lerp(t, x, y):
    """Reference: math.go:58-60."""
    return x * (1.0 - t) + y * t


def to_radians(degrees):
    """Reference: math.go:50-52."""
    return degrees * (jnp.pi / 180.0)
