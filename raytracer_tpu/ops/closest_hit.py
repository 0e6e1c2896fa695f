"""Pallas-Triton closest-hit kernel for NVIDIA GPUs.

The dense XLA form (geometry/intersect.py `closest_hit_t_prim`) builds
(N, S+Q) candidate arrays and reduces them with a separate min and argmin.
This kernel keeps the reduction in registers instead: one program owns a
power-of-two block of rays, loops over the packed sphere and quad tables
(small, read by every program, so L1/L2 serve them) and carries only the
running best (t, prim) per ray. Device memory traffic is the six ray
components in and (t, prim) out.

Math identical to geometry/intersect.py (and therefore to the reference
hittables.go:96-132, 167-194): half-b quadratic on oc = o - c and strict
open-interval root selection; quad plane/basis test via the precomputed
av/bv triple-product vectors.

Dummy/padded rows are encoded in the tables themselves: a padded sphere has
r^2 = -1e30 (drives the discriminant negative -> never hits) and a padded
quad has a zero normal (|n.d| < 1e-8 -> never hits), so the kernel needs no
validity masks.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

# Rays per program (a power of two, as Triton requires) and warps per
# program. 512 x 4 was within 3% of the fastest of blocks 64-512 x 1-8 warps
# on each of rand_spheres, rand_spheres_large and quad_field at 524,288
# rays on an H100 (PERF.md); the spread over all choices was about 15%.
BLOCK = 512
NUM_WARPS = 4
# Plain Python floats: jnp scalars here would be captured tracer constants,
# which pallas kernels reject.
INF = float("inf")
T_MIN = 1e-3
QUAD_DENOM_EPS = 1e-8


def pack_sphere_table(sph_center, sph_radius) -> jnp.ndarray:
    """(S, 4): cx, cy, cz, r^2; dummy rows (radius == 0) get r^2 = -1e30."""
    r2 = jnp.where(sph_radius == 0.0, -1e30, sph_radius * sph_radius)
    return jnp.concatenate([sph_center, r2[:, None]], axis=1)


def pack_quad_table(qd) -> jnp.ndarray:
    """(Q, 12) from geometry.intersect.QuadDerived (dummy rows have n = 0):
    nx, ny, nz, D, avx, avy, avz, bvx, bvy, bvz, Q·av, Q·bv."""
    return jnp.concatenate(
        [
            qd.normal,
            qd.d[:, None],
            qd.av,
            qd.bv,
            qd.q_av[:, None],
            qd.q_bv[:, None],
        ],
        axis=1,
    )


def _closest_hit_kernel(
    sph_ref,  # (S, 4) f32 — pack_sphere_table
    quad_ref,  # (Q, 12) f32 — pack_quad_table
    ox_ref, oy_ref, oz_ref, dx_ref, dy_ref, dz_ref,  # (N,) f32
    t_ref,  # (N,) f32 out, +inf on miss
    prim_ref,  # (N,) i32 out, -1 on miss
    *,
    n: int,
):
    start = pl.program_id(0) * BLOCK
    rows = pl.ds(start, BLOCK)
    mask = start + jnp.arange(BLOCK) < n

    def load(ref, fill):
        return plgpu.load(ref.at[rows], mask=mask, other=fill)

    # Tail lanes read a unit direction so their (discarded) math stays finite.
    ox, oy, oz = load(ox_ref, 0.0), load(oy_ref, 0.0), load(oz_ref, 0.0)
    dx, dy, dz = load(dx_ref, 1.0), load(dy_ref, 1.0), load(dz_ref, 1.0)

    a = dx * dx + dy * dy + dz * dz
    # Candidates compare in *scaled* t-space (t' = t*a, a > 0 per ray):
    # this skips two 1/a multiplies per sphere; the winner is rescaled once
    # after the loops. Quads scale their t by a to stay comparable.
    tmin_a = T_MIN * a

    def sphere_body(i, carry):
        t_best, p_best = carry
        ocx = ox - sph_ref[i, 0]
        ocy = oy - sph_ref[i, 1]
        ocz = oz - sph_ref[i, 2]
        half_b = dx * ocx + dy * ocy + dz * ocz
        c = ocx * ocx + ocy * ocy + ocz * ocz - sph_ref[i, 3]
        disc = half_b * half_b - a * c
        # sqrt(disc < 0) = NaN, and NaN fails every comparison below, so an
        # infeasible sphere falls through to INF without a mask.
        sq = jnp.sqrt(disc)
        t0 = -half_b - sq
        t1 = -half_b + sq
        t_cand = jnp.where(t0 > tmin_a, t0, jnp.where(t1 > tmin_a, t1, INF))
        better = t_cand < t_best
        return jnp.where(better, t_cand, t_best), jnp.where(better, i, p_best)

    ns = sph_ref.shape[0]
    carry = (jnp.full((BLOCK,), INF, jnp.float32), jnp.full((BLOCK,), -1, jnp.int32))
    carry = jax.lax.fori_loop(0, ns, sphere_body, carry)

    def quad_body(qi, carry):
        t_best, p_best = carry
        nx = quad_ref[qi, 0]
        ny = quad_ref[qi, 1]
        nz = quad_ref[qi, 2]
        d_n = dx * nx + dy * ny + dz * nz
        o_n = ox * nx + oy * ny + oz * nz
        denom_ok = jnp.abs(d_n) >= QUAD_DENOM_EPS
        t = (quad_ref[qi, 3] - o_n) / jnp.where(denom_ok, d_n, 1.0)
        avx = quad_ref[qi, 4]
        avy = quad_ref[qi, 5]
        avz = quad_ref[qi, 6]
        alpha = (
            (ox * avx + oy * avy + oz * avz)
            + t * (dx * avx + dy * avy + dz * avz)
            - quad_ref[qi, 10]
        )
        bvx = quad_ref[qi, 7]
        bvy = quad_ref[qi, 8]
        bvz = quad_ref[qi, 9]
        beta = (
            (ox * bvx + oy * bvy + oz * bvz)
            + t * (dx * bvx + dy * bvy + dz * bvz)
            - quad_ref[qi, 11]
        )
        ok = (
            denom_ok
            & (t > T_MIN)
            & (alpha >= 0.0)
            & (alpha <= 1.0)
            & (beta >= 0.0)
            & (beta <= 1.0)
        )
        t_cand = jnp.where(ok, t * a, INF)
        better = t_cand < t_best
        return (
            jnp.where(better, t_cand, t_best),
            jnp.where(better, ns + qi, p_best),
        )

    t_best, p_best = jax.lax.fori_loop(0, quad_ref.shape[0], quad_body, carry)
    plgpu.store(t_ref.at[rows], t_best / a, mask=mask)  # INF stays INF
    plgpu.store(prim_ref.at[rows], p_best, mask=mask)


@partial(jax.jit, static_argnames=("interpret",))
def closest_hit(sph_table, quad_table, origin, direction, *, interpret: bool = False):
    """Closest hit for a flat ray batch of any length N.

    Args:
      sph_table: (S, 4) from pack_sphere_table.
      quad_table: (Q, 12) from pack_quad_table.
      origin, direction: (N, 3) f32.

    Returns (t (N,) f32 with +inf miss, prim (N,) i32 with -1 miss; sphere
    ids first, then quads offset by S). `interpret=True` runs the kernel
    on the CPU through the Pallas interpreter (tests).
    """
    n = origin.shape[0]
    comps = [origin[:, i] for i in range(3)] + [direction[:, i] for i in range(3)]
    t, prim = pl.pallas_call(
        partial(_closest_hit_kernel, n=n),
        grid=(pl.cdiv(n, BLOCK),),
        out_shape=[
            jax.ShapeDtypeStruct((n,), jnp.float32),
            jax.ShapeDtypeStruct((n,), jnp.int32),
        ],
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=NUM_WARPS, num_stages=1),
        interpret=interpret,
        name="closest_hit",
    )(sph_table, quad_table, *comps)
    return t, prim
