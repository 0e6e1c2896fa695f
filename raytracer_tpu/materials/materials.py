"""Branchless material shading: emission + scatter for a wavefront of hits.

Replaces the reference's `Material` interface dispatch (materials.go:9-17)
with an enum + masked-select design: all material branches are evaluated for
the whole batch (they are a handful of VPU ops each) and the per-lane result
selected by `mat_type`. Random decisions are reparameterized through explicit
uniforms so the whole scatter is a smooth(ish) function for autodiff — the
discrete reflect/refract and absorb events use the same stochastic semantics
as the reference (straight-through for gradients).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from raytracer_tpu.core import vecmath as vm
from raytracer_tpu.core.sampling import unit_sphere_from_uniform
from raytracer_tpu.geometry.intersect import HitRecord
from raytracer_tpu.geometry.scene import (
    Scene,
    DIELECTRIC,
    DIFFUSE_LIGHT,
    LAMBERTIAN,
    METAL,
)
from raytracer_tpu.materials.textures import eval_texture_packed

# Number of U[0,1) uniforms consumed per lane per bounce:
# 2 for the unit-sphere sample (Lambertian diffuse dir / Metal fuzz),
# 1 for the Dielectric reflect-vs-refract coin (materials.go:103).
UNIFORMS_PER_BOUNCE = 3


class BounceResult(NamedTuple):
    """Everything the wavefront loop needs from one bounce, produced by the
    fused resolve+shade path (single table gather)."""

    hit: jnp.ndarray  # (N,) bool
    point: jnp.ndarray  # (N, 3)
    direction: jnp.ndarray  # (N, 3) scattered dir
    attenuation: jnp.ndarray  # (N, 3)
    scattered: jnp.ndarray  # (N,) bool
    emitted: jnp.ndarray  # (N, 3)


def _dielectric_lr(reflect_prob, use_reflect, cannot_refract):
    """Likelihood-ratio factor for the stochastic reflect/refract coin:
    P(branch)/sg(P(branch)) == 1.0 in the forward pass, but its gradient
    carries dlogP/d_ior — the branch-probability derivative that plain
    straight-through misses (FD measures it; without this d/d_ior is
    biased). TIR is deterministic (P == 1): factor stays exactly 1."""
    p_clip = jnp.clip(reflect_prob, 1e-4, 1.0 - 1e-4)
    p_branch = jnp.where(use_reflect, p_clip, 1.0 - p_clip)
    return jnp.where(
        cannot_refract, 1.0, p_branch / jax.lax.stop_gradient(p_branch)
    )[..., None]


def resolve_and_shade(
    scene: Scene, table, t, prim, origin, ray_dir, uniforms
) -> BounceResult:
    """Fused hit epilogue + material shading from the winning (t, prim).

    ONE row gather on the extended resolve table replaces the ~9 separate
    per-field gathers of resolve_hits + shade.
    Math identical to geometry.intersect.resolve_hits + shade.
    """
    from raytracer_tpu.geometry.intersect import _sphere_uv
    from raytracer_tpu.materials.packed import (
        COL_C0,
        COL_C1,
        COL_FUZZ,
        COL_IOR,
        COL_MTYPE,
        COL_Q_AV,
        COL_Q_BV,
        COL_Q_NORMAL,
        COL_Q_QAV,
        COL_Q_QBV,
        COL_SPH_CENTER,
        COL_SPH_RADIUS,
        COL_TIMAGE,
        COL_TSCALE,
        COL_TTYPE,
    )

    n = origin.shape[0]
    ns = scene.num_spheres
    hit = jnp.isfinite(t)
    t_safe = jnp.where(hit, t, 0.0)
    prim = jnp.where(hit, prim, 0)
    # Single row gather, then ONE transpose to channel-major: the ~15 column
    # reads below become contiguous (N,) row slices instead of stride-27
    # column slices.
    row_t = table[prim].T  # (N_RESOLVE_COLS, N)

    def col(c):
        return row_t[c]

    def cols3(sl):
        return row_t[sl].T  # (N, 3)

    is_quad = prim >= ns
    point = origin + t_safe[..., None] * ray_dir

    # Normals/UV (resolve_hits math, from row columns).
    s_out = vm.normalize(
        (point - cols3(COL_SPH_CENTER)) * col(COL_SPH_RADIUS)[..., None],
        eps=1e-20,
    )
    s_u, s_v = _sphere_uv(s_out)
    q_out = cols3(COL_Q_NORMAL)
    q_u = vm.dot(point, cols3(COL_Q_AV)) - col(COL_Q_QAV)
    q_v = vm.dot(point, cols3(COL_Q_BV)) - col(COL_Q_QBV)
    outward = jnp.where(is_quad[..., None], q_out, s_out)
    u = jnp.where(is_quad, q_u, s_u)
    v = jnp.where(is_quad, q_v, s_v)
    front_face = vm.dot(ray_dir, outward) < 0.0
    normal = jnp.where(front_face[..., None], outward, -outward)

    # ---- shading (shade() math, from the same row) ----
    mtype = col(COL_MTYPE).astype(jnp.int32)
    tex_color = eval_texture_packed(
        scene,
        col(COL_TTYPE),
        cols3(COL_C0),
        cols3(COL_C1),
        col(COL_TSCALE),
        col(COL_TIMAGE),
        u,
        v,
        point,
    )
    is_light = mtype == DIFFUSE_LIGHT
    emitted = jnp.where(is_light[..., None], tex_color, 0.0)

    sphere_sample = unit_sphere_from_uniform(uniforms[:, 0:2])
    unit_dir = vm.normalize(ray_dir, eps=1e-20)

    lamb_dir = normal + sphere_sample
    lamb_dir = jnp.where(vm.near_zero(lamb_dir)[..., None], normal, lamb_dir)

    reflected = vm.reflect(unit_dir, normal)
    fuzz = col(COL_FUZZ)[..., None]
    metal_dir = reflected + fuzz * sphere_sample
    metal_ok = vm.dot(metal_dir, normal) > 0.0

    ior = col(COL_IOR)
    eta = jnp.where(front_face, 1.0 / ior, ior)
    cos_theta = jnp.minimum(vm.dot(-unit_dir, normal), 1.0)
    sin_theta = jnp.sqrt(jnp.clip(1.0 - cos_theta * cos_theta, 1e-12, 1.0))
    cannot_refract = sin_theta * eta > 1.0
    reflect_prob = vm.schlick_reflectance(cos_theta, eta)
    use_reflect = cannot_refract | (reflect_prob > uniforms[:, 2])
    refracted = vm.refract(unit_dir, normal, eta)
    diel_dir = jnp.where(use_reflect[..., None], reflected, refracted)
    diel_lr = _dielectric_lr(reflect_prob, use_reflect, cannot_refract)

    is_lamb = (mtype == LAMBERTIAN)[..., None]
    is_metal = (mtype == METAL)[..., None]
    is_diel = (mtype == DIELECTRIC)[..., None]
    direction = jnp.where(is_lamb, lamb_dir, jnp.where(is_metal, metal_dir, diel_dir))
    attenuation = jnp.where(
        is_lamb | is_metal,
        tex_color,
        jnp.where(is_diel, jnp.broadcast_to(diel_lr, (n, 3)).astype(ray_dir.dtype), 0.0),
    )
    scattered = jnp.where(
        mtype == METAL,
        metal_ok,
        (mtype == LAMBERTIAN) | (mtype == DIELECTRIC),
    )
    return BounceResult(
        hit=hit,
        point=point,
        direction=direction,
        attenuation=attenuation,
        scattered=scattered,
        emitted=emitted,
    )


class ScatterResult(NamedTuple):
    """Batched analog of ScatterInfo + the did-scatter bool (materials.go:14-17)."""

    direction: jnp.ndarray  # (N, 3) scattered ray direction
    attenuation: jnp.ndarray  # (N, 3)
    scattered: jnp.ndarray  # (N,) bool — False = absorbed / emitter
    emitted: jnp.ndarray  # (N, 3) — emission at the hit (ray.go:41)


def shade(
    scene: Scene, hit: HitRecord, ray_dir, uniforms, packed=None
) -> ScatterResult:
    """Compute emission and the scattered ray for every lane.

    Args:
      scene: scene tables.
      hit: HitRecord from intersect_scene (lanes that missed carry garbage;
        callers mask with hit.hit).
      ray_dir: (N, 3) incoming ray directions (unnormalized, as traced).
      uniforms: (N, UNIFORMS_PER_BOUNCE) U[0,1).
      packed: optional precomputed primitive_shading_table(scene) — pass it on
        hot paths so the table is built once per trace, not per bounce.

    All material/texture parameters come from ONE row gather on the packed
    per-primitive table (see materials/packed.py for why).

    Mirrors Ray.GetColor's emit+scatter sequence (ray.go:41-50) with the four
    concrete materials (materials.go:19-119, 297-313).
    """
    from raytracer_tpu.materials.packed import (
        COL_C0,
        COL_C1,
        COL_FUZZ,
        COL_IOR,
        COL_MTYPE,
        COL_TIMAGE,
        COL_TSCALE,
        COL_TTYPE,
        primitive_shading_table,
    )

    if packed is None:
        packed = primitive_shading_table(scene)
    row = packed[hit.prim_id]  # (N, N_COLS) — the single gather
    mtype = row[:, COL_MTYPE].astype(jnp.int32)
    normal = hit.normal
    n = normal.shape[0]

    # ---- texture color (albedo for Lambertian, emission for lights) --------
    tex_color = eval_texture_packed(
        scene,
        row[:, COL_TTYPE],
        row[:, COL_C0],
        row[:, COL_C1],
        row[:, COL_TSCALE],
        row[:, COL_TIMAGE],
        hit.u,
        hit.v,
        hit.point,
    )

    # ---- emission (DiffuseLight.Emit, materials.go:311-313; others black) --
    is_light = mtype == DIFFUSE_LIGHT
    emitted = jnp.where(is_light[..., None], tex_color, 0.0)

    # ---- shared samples ----------------------------------------------------
    sphere_sample = unit_sphere_from_uniform(uniforms[:, 0:2])  # (N, 3)
    unit_dir = vm.normalize(ray_dir, eps=1e-20)

    # ---- Lambertian (materials.go:33-42) -----------------------------------
    lamb_dir = normal + sphere_sample
    # Degenerate-direction guard (vec3.go:170-172 + materials.go:35-37).
    lamb_dir = jnp.where(vm.near_zero(lamb_dir)[..., None], normal, lamb_dir)

    # ---- Metal (materials.go:60-75) ----------------------------------------
    reflected = vm.reflect(unit_dir, normal)
    fuzz = row[:, COL_FUZZ][..., None]
    metal_dir = reflected + fuzz * sphere_sample
    metal_ok = vm.dot(metal_dir, normal) > 0.0  # absorbed otherwise

    # ---- Dielectric (materials.go:91-113) ----------------------------------
    ior = row[:, COL_IOR]
    eta = jnp.where(hit.front_face, 1.0 / ior, ior)
    cos_theta = jnp.minimum(vm.dot(-unit_dir, normal), 1.0)
    # Clip floor keeps sqrt' finite at normal incidence (cos == 1) — a zero
    # cotangent times sqrt'(0) = inf would inject NaN into scene gradients.
    sin_theta = jnp.sqrt(jnp.clip(1.0 - cos_theta * cos_theta, 1e-12, 1.0))
    cannot_refract = sin_theta * eta > 1.0
    reflect_prob = vm.schlick_reflectance(cos_theta, eta)
    use_reflect = cannot_refract | (reflect_prob > uniforms[:, 2])
    refracted = vm.refract(unit_dir, normal, eta)
    diel_dir = jnp.where(use_reflect[..., None], reflected, refracted)
    diel_lr = _dielectric_lr(reflect_prob, use_reflect, cannot_refract)

    # ---- select per material type ------------------------------------------
    is_lamb = (mtype == LAMBERTIAN)[..., None]
    is_metal = (mtype == METAL)[..., None]
    is_diel = (mtype == DIELECTRIC)[..., None]

    direction = jnp.where(
        is_lamb, lamb_dir, jnp.where(is_metal, metal_dir, diel_dir)
    )
    attenuation = jnp.where(
        is_lamb | is_metal,
        tex_color,  # Lambertian albedo texture (materials.go:40); metal flat
        # albedo rides the same packed color columns (materials.go:70)
        jnp.where(is_diel, jnp.broadcast_to(diel_lr, (n, 3)).astype(ray_dir.dtype), 0.0),
    )
    scattered = jnp.where(
        mtype == METAL,
        metal_ok,
        (mtype == LAMBERTIAN) | (mtype == DIELECTRIC),
    )
    return ScatterResult(
        direction=direction,
        attenuation=attenuation,
        scattered=scattered,
        emitted=emitted,
    )
