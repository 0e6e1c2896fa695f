"""Batched ray–scene intersection as dense masked reductions.

Redesign of the reference's closest-hit machinery: the Go code walks a BVH
with per-ray recursion and branchy scalar intersection tests
(hittables.go:96-132 sphere, hittables.go:167-194 quad, bvh.go:220-249
traversal). Here every ray-primitive test of a batch is one elementwise
expression over the (N, K) ray x primitive domain, and the closest-hit
"shrinking t_max" loop (hittables.go:55-72) becomes a masked min-reduction
over the primitive axis. Everything is branchless — validity conditions are
masks, invalid candidates get t = +inf.

The math reproduces the reference exactly (same half-b quadratic, same strict
open interval (t_min, +inf), same root-selection order, same quad plane/basis
test), so primary-hit t/normal/uv can be compared bit-close against a NumPy
port in the tests. `closest_hit_pallas` / `intersect_scene_pallas_diff` run
the same search through the Pallas-Triton kernel (ops/closest_hit.py), which
keeps the running (t, prim) in registers instead of (N, K) arrays.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from raytracer_tpu.core import vecmath as vm
from raytracer_tpu.geometry.scene import Scene

INF = jnp.inf
# Reference uses a strict open interval with t_min = 0.001 (ray.go:37-40).
DEFAULT_T_MIN = 1e-3
# Quad denominator cutoff (hittables.go:169-171).
QUAD_DENOM_EPS = 1e-8
# Sphere-UV phi offset quirk (hittables.go:124-125) — the reference adds
# 5*pi/12 to phi "to make the earth texture line up"; reproduced for parity.
SPHERE_UV_PHI_OFFSET = 5.0 * jnp.pi / 12.0


def _dot_nk(a, b_t):
    """(N,3) · (3,K) ray-feature dot products as broadcast multiply-adds.

    Deliberately NOT a matmul: a float32 contraction may run at reduced
    precision (TF32 on the GPU's tensor cores) unless every call asks for
    HIGHEST, and a 1.7% hit-t error is a visibly wrong image. Three
    broadcast multiply-adds on the (N,K) domain are exact f32 and fuse with
    the intersection epilogue.
    """
    return (
        a[:, 0:1] * b_t[0][None, :]
        + a[:, 1:2] * b_t[1][None, :]
        + a[:, 2:3] * b_t[2][None, :]
    )


class HitRecord(NamedTuple):
    """SoA hit buffer, the batched analog of HitInfo (hittables.go:12-37)."""

    t: jnp.ndarray  # (N,) f32, +inf on miss
    hit: jnp.ndarray  # (N,) bool
    point: jnp.ndarray  # (N, 3)
    normal: jnp.ndarray  # (N, 3) — flipped to face the ray (hittables.go:23-26)
    front_face: jnp.ndarray  # (N,) bool
    u: jnp.ndarray  # (N,)
    v: jnp.ndarray  # (N,)
    mat_id: jnp.ndarray  # (N,) i32
    prim_id: jnp.ndarray  # (N,) i32 — global primitive index (spheres then quads)


class QuadDerived(NamedTuple):
    """Per-quad derived quantities (hittables.go:149-165), computed in-jit so
    gradients flow back to the raw (Q, u, v) parameters."""

    normal: jnp.ndarray  # (Q, 3) unit plane normal
    d: jnp.ndarray  # (Q,) plane offset D = n̂·Q
    av: jnp.ndarray  # (Q, 3) alpha = p·av basis vector (= v × w)
    bv: jnp.ndarray  # (Q, 3) beta = p·bv basis vector (= w × u)
    q_av: jnp.ndarray  # (Q,) Q·av
    q_bv: jnp.ndarray  # (Q,) Q·bv


def quad_derived(scene: Scene) -> QuadDerived:
    """hittables.go:149-165: n = u×v, n̂, D = n̂·Q, w = n/(n·n).

    The reference computes alpha = w·(p×v), beta = w·(u×p) per hit
    (hittables.go:185-186). By the scalar-triple-product identity these are
    alpha = p·(v×w), beta = p·(w×u) — so we precompute av = v×w, bv = w×u once
    per quad and the per-ray work becomes two more columns of the (N, 3Q)
    dot products.
    """
    n_raw = jnp.cross(scene.quad_u, scene.quad_v)
    nn = vm.length_sq(n_raw)
    # Guard degenerate (dummy) quads; they are rejected by the denom test.
    safe_nn = jnp.where(nn > 0, nn, 1.0)
    w = n_raw / safe_nn[..., None]
    normal = n_raw / jnp.sqrt(safe_nn)[..., None]
    d = vm.dot(normal, scene.quad_q)
    av = jnp.cross(scene.quad_v, w)
    bv = jnp.cross(w, scene.quad_u)
    return QuadDerived(
        normal=normal,
        d=d,
        av=av,
        bv=bv,
        q_av=vm.dot(scene.quad_q, av),
        q_bv=vm.dot(scene.quad_q, bv),
    )


def _sphere_candidate_t(scene: Scene, origin, direction, t_min):
    """Per-(ray, sphere) candidate hit t, +inf where invalid.

    Reference math (hittables.go:96-116), vectorized:
      oc = o - c;  a = |d|^2;  half_b = d·oc;  c = |oc|^2 - r^2
      disc = half_b^2 - a c;  roots (-half_b ∓ sqrt(disc)) / a,
      nearest root first, strict open interval test (bvh.go:18-20).

    oc is formed per (ray, sphere) rather than expanding |o - c|^2 as
    |o|^2 - 2 o·c + |c|^2: the expansion cancels catastrophically for small
    spheres far from the world origin and for rays leaving a surface, where
    it moved a root across t_min by up to ~1e-2. All of it is elementwise
    on (N, S).
    """
    centers = scene.sph_center  # (S, 3)
    radius = scene.sph_radius  # (S,)
    ocx = origin[:, 0:1] - centers[None, :, 0]  # (N, S)
    ocy = origin[:, 1:2] - centers[None, :, 1]
    ocz = origin[:, 2:3] - centers[None, :, 2]
    a = vm.length_sq(direction)[:, None]  # (N, 1)
    half_b = direction[:, 0:1] * ocx + direction[:, 1:2] * ocy + direction[:, 2:3] * ocz
    c = ocx * ocx + ocy * ocy + ocz * ocz - (radius * radius)[None, :]
    disc = half_b * half_b - a * c
    # Safe sqrt: masked-off lanes (disc <= 0) must not see sqrt'(0) = inf —
    # a zero cotangent times an inf partial is NaN and would poison scene
    # gradients (the classic where/NaN autodiff pitfall; double-where fix).
    sq = jnp.sqrt(jnp.where(disc > 0.0, disc, 1.0))
    sq = jnp.where(disc > 0.0, sq, 0.0)
    inv_a = 1.0 / a
    t0 = (-half_b - sq) * inv_a
    t1 = (-half_b + sq) * inv_a

    # disc < 0 -> miss (hittables.go:104-106); radius == 0 marks dummy rows.
    feasible = (disc >= 0.0) & (radius != 0.0)
    ok0 = feasible & (t0 > t_min)
    ok1 = feasible & (t1 > t_min)
    return jnp.where(ok0, t0, jnp.where(ok1, t1, INF))


def _quad_candidate_t(scene: Scene, qd: QuadDerived, origin, direction, t_min):
    """Per-(ray, quad) candidate hit t (+inf invalid) and the (alpha, beta)
    plane coordinates (kept for the winner's UV).

    Reference math (hittables.go:167-194). The six ray-dependent dot products
    (o·n̂, d·n̂, o·av, d·av, o·bv, d·bv) are two (N,3)·(3,3Q) products.
    """
    feats = jnp.concatenate([qd.normal, qd.av, qd.bv], axis=0)  # (3Q, 3)
    o_f = _dot_nk(origin, feats.T)  # (N, 3Q)
    d_f = _dot_nk(direction, feats.T)  # (N, 3Q)
    nq = qd.normal.shape[0]
    o_n, o_av, o_bv = o_f[:, :nq], o_f[:, nq : 2 * nq], o_f[:, 2 * nq :]
    d_n, d_av, d_bv = d_f[:, :nq], d_f[:, nq : 2 * nq], d_f[:, 2 * nq :]

    denom_ok = jnp.abs(d_n) >= QUAD_DENOM_EPS  # hittables.go:169-171
    safe_dn = jnp.where(denom_ok, d_n, 1.0)
    t = (qd.d - o_n) / safe_dn  # hittables.go:173
    alpha = o_av + t * d_av - qd.q_av  # = w·(p×v), hittables.go:183-185
    beta = o_bv + t * d_bv - qd.q_bv  # = w·(u×p), hittables.go:186
    in_plane = (alpha >= 0.0) & (alpha <= 1.0) & (beta >= 0.0) & (beta <= 1.0)
    ok = denom_ok & (t > t_min) & in_plane
    return jnp.where(ok, t, INF), alpha, beta


def _sphere_uv(unit_normal):
    """Spherical UV with the reference's phi-offset quirk (hittables.go:122-126)."""
    ny = jnp.clip(unit_normal[..., 1], -1.0, 1.0)
    theta = jnp.arccos(-ny)
    phi = jnp.arctan2(-unit_normal[..., 2], unit_normal[..., 0]) + jnp.pi
    u = (phi + SPHERE_UV_PHI_OFFSET) / (2.0 * jnp.pi)
    v = theta / jnp.pi
    return u, v


def resolve_hits(scene: Scene, qd: QuadDerived, origin, direction, t, prim) -> HitRecord:
    """Epilogue shared by the dense and kernel candidate searches: given the
    winning (t, prim) per ray, compute point/normal/uv/material/front-face.
    All per-winner quantities are recomputed from gathered primitive rows
    (N-sized work; no (N, S) buffers)."""
    ns = scene.num_spheres
    hit = jnp.isfinite(t)
    t_safe = jnp.where(hit, t, 0.0)
    prim = jnp.where(hit, prim, 0)

    is_quad = prim >= ns
    sidx = jnp.minimum(prim, ns - 1)
    qidx = jnp.clip(prim - ns, 0, scene.num_quads - 1)

    point = origin + t_safe[..., None] * direction

    # Sphere outward normal: unit((p - c) * r) — the multiply by (possibly
    # negative) radius flips normals for hollow-glass spheres
    # (hittables.go:118-120).
    s_center = scene.sph_center[sidx]
    s_radius = scene.sph_radius[sidx]
    s_out = vm.normalize((point - s_center) * s_radius[..., None], eps=1e-20)
    s_u, s_v = _sphere_uv(s_out)

    # Quad UV: alpha = p·av - Q·av, beta = p·bv - Q·bv (hittables.go:183-186,
    # via the triple-product identity — see quad_derived).
    q_out = qd.normal[qidx]
    q_u = vm.dot(point, qd.av[qidx]) - qd.q_av[qidx]
    q_v = vm.dot(point, qd.bv[qidx]) - qd.q_bv[qidx]

    outward = jnp.where(is_quad[..., None], q_out, s_out)
    u = jnp.where(is_quad, q_u, s_u)
    v = jnp.where(is_quad, q_v, s_v)
    mat_id = jnp.where(is_quad, scene.quad_mat[qidx], scene.sph_mat[sidx])

    # Face the normal against the incoming ray (hittables.go:23-26).
    front_face = vm.dot(direction, outward) < 0.0
    normal = jnp.where(front_face[..., None], outward, -outward)

    return HitRecord(
        t=t,
        hit=hit,
        point=point,
        normal=normal,
        front_face=front_face,
        u=u,
        v=v,
        mat_id=mat_id,
        prim_id=prim,
    )


def _winner_t_diff(scene, qd, origin, direction, prim, t_nd, t_min):
    """Differentiable recompute of the winning candidate's t.

    Same per-primitive math as _sphere_candidate_t / _quad_candidate_t
    (hittables.go:96-116, 167-173) evaluated only at the winner row, so
    gradients flow through sphere center/radius (and quad q/u/v via
    quad_derived) by implicit selection: the argmin itself is treated as
    locally constant (correct a.e.; visibility-boundary terms are the
    diff.boundary module's job). Miss lanes keep t_nd (+inf) with all
    branch inputs masked finite (double-where) so no NaN*0 poisons the VJP.
    """
    ns = scene.num_spheres
    hit = jnp.isfinite(t_nd)
    primc = jnp.where(hit, prim, 0)
    is_quad = primc >= ns
    sidx = jnp.minimum(primc, ns - 1)
    qidx = jnp.clip(primc - ns, 0, scene.num_quads - 1)

    c = scene.sph_center[sidx]
    r = scene.sph_radius[sidx]
    oc = origin - c
    a = vm.length_sq(direction)
    half_b = vm.dot(direction, oc)
    cq = vm.length_sq(oc) - r * r
    disc = half_b * half_b - a * cq
    disc_ok = disc > 0.0
    sq = jnp.sqrt(jnp.where(disc_ok, disc, 1.0))
    sq = jnp.where(disc_ok, sq, 0.0)
    inv_a = 1.0 / a
    t0 = (-half_b - sq) * inv_a
    t1 = (-half_b + sq) * inv_a
    t_s = jnp.where(t0 > t_min, t0, t1)  # kernel's nearest-then-far choice

    n = qd.normal[qidx]
    d_n = vm.dot(direction, n)
    denom_ok = jnp.abs(d_n) >= QUAD_DENOM_EPS
    safe_dn = jnp.where(denom_ok, d_n, 1.0)
    t_q = (qd.d[qidx] - vm.dot(origin, n)) / safe_dn

    t = jnp.where(is_quad, t_q, t_s)
    return jnp.where(hit, t, t_nd)


def closest_hit_pallas(
    scene: Scene, origin, direction, t_min: float = DEFAULT_T_MIN,
    *, interpret: bool = False,
):
    """`closest_hit_t_prim` through the Pallas-Triton kernel: winning
    (t (N,), prim (N,) i32, -1 on miss). The kernel compiles T_MIN in as a
    constant, so a non-default t_min is rejected rather than silently
    ignored. `interpret=True` runs the kernel through the Pallas
    interpreter (CPU tests)."""
    from raytracer_tpu.ops import closest_hit as ch

    if t_min != ch.T_MIN:
        raise ValueError(
            f"the closest-hit kernel compiles t_min={ch.T_MIN}; got {t_min} "
            "(use closest_hit_t_prim for a custom t_min)"
        )
    return ch.closest_hit(
        ch.pack_sphere_table(scene.sph_center, scene.sph_radius),
        ch.pack_quad_table(quad_derived(scene)),
        origin,
        direction,
        interpret=interpret,
    )


def intersect_scene_pallas_diff(
    scene: Scene, origin, direction, t_min: float = DEFAULT_T_MIN,
    *, interpret: bool = False,
) -> HitRecord:
    """Differentiable closest hit with a Pallas-kernel search.

    The kernel finds the winner (t, prim) on stop-gradient inputs — no
    cotangent ever reaches the pallas_call, so it needs no VJP — and the
    winner's t is then RECOMPUTED differentiably from the scene arrays
    (_winner_t_diff), feeding the fully differentiable resolve_hits
    epilogue. Numerically the recomputed t matches the kernel's to fp
    rounding (same formulas, different association).
    """
    sg = jax.lax.stop_gradient
    t_nd, prim = closest_hit_pallas(
        jax.tree_util.tree_map(sg, scene), sg(origin), sg(direction), t_min,
        interpret=interpret,
    )
    qd = quad_derived(scene)
    t = _winner_t_diff(scene, qd, origin, direction, prim, t_nd, t_min)
    return resolve_hits(scene, qd, origin, direction, t, prim)

def closest_hit_t_prim(scene: Scene, origin, direction, t_min: float = DEFAULT_T_MIN):
    """Dense candidate search only: winning (t (N,), prim (N,) i32) without
    the epilogue (for the fused resolve+shade path)."""
    t_s = _sphere_candidate_t(scene, origin, direction, t_min)
    qd = quad_derived(scene)
    t_q, _, _ = _quad_candidate_t(scene, qd, origin, direction, t_min)
    t_all = jnp.concatenate([t_s, t_q], axis=1)
    prim = jnp.argmin(t_all, axis=1).astype(jnp.int32)
    return jnp.min(t_all, axis=1), prim


def intersect_scene(
    scene: Scene, origin, direction, t_min: float = DEFAULT_T_MIN
) -> HitRecord:
    """Closest hit over all primitives for a batch of rays.

    Args:
      scene: Scene tables.
      origin, direction: (N, 3) f32; direction unnormalized (reference keeps
        camera directions unnormalized, camera.go:283-286).
      t_min: open-interval lower bound (ray.go:38).

    Returns a HitRecord. Equivalent to World.Hit's shrinking linear scan
    (hittables.go:55-72) / BVH.Hit (bvh.go:220-249) — both return the same
    closest hit; here it is one masked min over the primitive axis.
    """
    t_s = _sphere_candidate_t(scene, origin, direction, t_min)  # (N, S)
    qd = quad_derived(scene)
    t_q, _, _ = _quad_candidate_t(scene, qd, origin, direction, t_min)

    t_all = jnp.concatenate([t_s, t_q], axis=1)  # (N, S+Q)
    prim = jnp.argmin(t_all, axis=1).astype(jnp.int32)  # (N,)
    t = jnp.min(t_all, axis=1)
    return resolve_hits(scene, qd, origin, direction, t, prim)
