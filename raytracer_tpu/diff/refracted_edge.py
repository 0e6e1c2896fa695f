"""Refracted-silhouette gradients through glass spheres: specular-manifold
edge sampling (round 5, closing the gap tests/test_glass_gap.py quantifies).

A blocker seen THROUGH a dielectric sphere contributes its gradient via the
edges of its REFRACTED image — a discontinuity curve in screen space that
interior AD, primary boundary sampling (diff/boundary.py), shadow edges
(diff/shadow_edge.py), and mirror edges (diff/mirror_edge.py) all miss: FD
measures the full gradient while every one of them reports exactly 0.000.

Unlike the flat-mirror case there is no virtual pinhole: the refracted
image position has no closed form. But for SPHERE glass the two-interface
refract-refract chain IS closed-form per screen point:

    P(s) = plane-hit( refract_out( travel( refract_in( camera_ray(s) ))))

so the curve can be found by a specular-manifold NEWTON solve (the walk of
Jakob & Marschner 2012, specialized to one glass sphere): for each sample
Y(tau) on a blocker quad edge, solve F(s) = plane_coords(P(s)) -
plane_coords(Y) = 0 for the screen position s in R^2 (2 equations, 2
unknowns; jax.jacfwd supplies the 2x2 Jacobian; damped fixed-iteration
Newton, vectorized over all samples; non-converged / TIR / miss lanes are
masked out).

Derivatives need no custom_root: after the solve, the IMPLICIT FUNCTION
THEOREM gives every velocity from the same 2x2 Jacobian J = dF/ds —

    s_lin(theta) = s* - J^{-1} F(sg(s*), theta)

equals s* at the current parameters (F(s*, theta0) ~ 0) and carries the
exact first-order ds/dtheta, so the standard Reynolds scalar-pullback of
boundary.py applies unchanged. Edge tangent and outward direction push
through the same solve (dF/dY is analytic: Y enters F linearly through the
plane coordinates).

One-sided radiance needs NO special path handling: tracing full camera
paths through pixels a hair inside/outside the curve (common random
numbers) takes the stochastic reflect/refract branches as usual — every
branch EXCEPT refract-refract is identical on the two sides and cancels in
L_in - L_out, exactly the mechanism that already cancels occluded segments
in boundary.py. The difference therefore automatically carries the
(1-p1)(1-p2) branch weight of the refract-refract family.

Scope: ONE dielectric sphere bounce (entry + exit), QUAD blockers, blocker
on the far side of the glass. Multiple refracted images of the same edge
point (caustic folds) are found only as far as the two Newton inits reach
(direct projection + center-inverted image); TIR curves and glass-in-glass
stay out of scope — documented, with the bias measurable against FD by
tests/test_refracted_edge.py.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from raytracer_tpu.core.camera import Camera, camera_frame
from raytracer_tpu.diff.boundary import (
    _trace_edge_radiance,
    project_to_pixels,
    quad_edge_points,
)
from raytracer_tpu.geometry.scene import DIELECTRIC


class RefractedEdgeConfig(NamedTuple):
    samples_per_quad_edge: int = 32  # per straight edge (x4 edges)
    spp_edge: int = 8
    eps_px: float = 0.15
    newton_iters: int = 16
    newton_tol: float = 1e-3  # |F| in blocker-plane units
    damping: float = 0.7


def _glass_spheres(scene):
    """(center (S,3), radius (S,), ior (S,), is_glass (S,)) — dielectric
    spheres with positive radius (hollow inner shells are skipped: their
    chain has four interfaces)."""
    is_glass = (scene.mat_type[scene.sph_mat] == DIELECTRIC) & (
        scene.sph_radius > 0.0
    )
    ior = scene.mat_ior[scene.sph_mat]
    return scene.sph_center, scene.sph_radius, ior, is_glass


def _refract_unit(d, n, eta):
    """Snell refraction of unit d about unit n (d.n < 0), ratio eta.
    Returns (dir, total_internal_reflection)."""
    cos_i = -jnp.sum(d * n, axis=-1, keepdims=True)
    sin2_t = eta**2 * jnp.maximum(0.0, 1.0 - cos_i**2)
    tir = sin2_t[..., 0] > 1.0
    cos_t = jnp.sqrt(jnp.maximum(1.0 - sin2_t, 1e-12))
    out = eta * d + (eta * cos_i - cos_t) * n
    return out, tir


def _chain_to_plane(s, frame, c, r, ior, plane_q, plane_av, plane_bv,
                    plane_qav, plane_qbv):
    """Screen point s (2,) -> in-plane (alpha, beta) of the refract-refract
    chain's hit on the blocker plane, plus a validity flag.

    The plane is parameterized exactly like geometry.intersect's quads:
    alpha = P.av - q.av, beta = P.bv - q.bv (av/bv the reciprocal basis),
    so F can be compared against edge points in the same coordinates."""
    target = frame.pixel00 + s[0] * frame.pixel_du + s[1] * frame.pixel_dv
    o = frame.center
    d = target - o
    d = d / jnp.maximum(jnp.linalg.norm(d), 1e-12)

    # entry: nearest sphere root
    oc = o - c
    b = jnp.sum(d * oc)
    disc = b * b - (jnp.sum(oc * oc) - r * r)
    ok = disc > 0.0
    sq = jnp.sqrt(jnp.maximum(disc, 1e-12))
    t1 = -b - sq
    ok = ok & (t1 > 1e-4)
    p1 = o + t1 * d
    n1 = (p1 - c) / r
    d1, tir1 = _refract_unit(d, n1, 1.0 / ior)
    ok = ok & ~tir1

    # exit: far root of the internal chord
    oc2 = p1 - c
    b2 = jnp.sum(d1 * oc2)
    disc2 = b2 * b2 - (jnp.sum(oc2 * oc2) - r * r)
    sq2 = jnp.sqrt(jnp.maximum(disc2, 1e-12))
    t2 = -b2 + sq2
    p2 = p1 + t2 * d1
    n2 = (c - p2) / r  # inward-facing at exit (d1 . n2 < 0)
    d2, tir2 = _refract_unit(d1, n2, ior)
    ok = ok & ~tir2

    # blocker plane hit (plane normal = cross(u, v) direction via av/bv is
    # implicit; use the geometric normal from q/av/bv's origin data)
    denom = jnp.sum(d2 * plane_q[3:6])
    t3 = (plane_q[6] - jnp.sum(p2 * plane_q[3:6])) / jnp.where(
        jnp.abs(denom) < 1e-9, 1e-9, denom
    )
    ok = ok & (t3 > 1e-4)
    hp = p2 + t3 * d2
    alpha = jnp.sum(hp * plane_av) - plane_qav
    beta = jnp.sum(hp * plane_bv) - plane_qbv
    return jnp.stack([alpha, beta]), ok


def make_refracted_boundary_fn(
    rebuild,
    *,
    width: int,
    height: int,
    max_depth: int,
    sky_gradient: bool = False,
    config: RefractedEdgeConfig = RefractedEdgeConfig(),
):
    """Build refracted_image(params, cam, key) -> (H, W, 3): zero forward,
    refracted-silhouette blocker gradients backward, for QUAD blockers seen
    through dielectric spheres. Composes additively like the other edge
    terms (and with the bucketed backend via edge_image_fns)."""
    cfg = config

    def _edge_cotangent(params, cam: Camera, key, ct):
        sg = jax.lax.stop_gradient
        params_sg = jax.tree_util.tree_map(sg, params)
        scene = rebuild(params_sg)
        cam_sg = jax.tree_util.tree_map(sg, cam)
        frame = camera_frame(cam_sg, width, height)

        zero = jax.tree_util.tree_map(jnp.zeros_like, params)
        zero_cam = jax.tree_util.tree_map(jnp.zeros_like, cam)
        if scene.num_quads == 0 or scene.num_spheres == 0 or not any(
            kq in params for kq in ("quad_q", "quad_u", "quad_v")
        ):
            return zero, zero_cam

        from raytracer_tpu.geometry.intersect import quad_derived

        c_all, r_all, ior_all, glass_all = _glass_spheres(scene)
        Sg = scene.num_spheres
        Q = scene.num_quads
        Me = cfg.samples_per_quad_edge
        M4 = 4 * Me
        tau = (jnp.arange(Me, dtype=jnp.float32) + 0.5) / Me

        qd = quad_derived(scene)
        # Packed plane rows used by _chain_to_plane: [q(3) | n_hat(3) | d].
        n_hat = qd.normal
        plane_pack = jnp.concatenate(
            [scene.quad_q, n_hat, qd.d[:, None]], axis=1
        )  # (Q, 7)

        q_sg = params_sg.get("quad_q", scene.quad_q)
        u_sg = params_sg.get("quad_u", scene.quad_u)
        v_sg = params_sg.get("quad_v", scene.quad_v)
        pts, dpts = quad_edge_points(q_sg, u_sg, v_sg, tau)  # (Q, M4, 3)
        # In-plane coordinates of the edge points and their tangents /
        # outward directions (same reciprocal basis the chain reports in).
        def plane_coords(qi, p3):
            a = jnp.sum(p3 * qd.av[qi], axis=-1) - qd.q_av[qi]
            b = jnp.sum(p3 * qd.bv[qi], axis=-1) - qd.q_bv[qi]
            return jnp.stack([a, b], axis=-1)

        # Outward in-plane directions per edge (interior toward +v/-u/-v/+u).
        out3d = jnp.concatenate(
            [
                jnp.broadcast_to(-v_sg[:, None, :], (Q, Me, 3)),
                jnp.broadcast_to(u_sg[:, None, :], (Q, Me, 3)),
                jnp.broadcast_to(v_sg[:, None, :], (Q, Me, 3)),
                jnp.broadcast_to(-u_sg[:, None, :], (Q, Me, 3)),
            ],
            axis=1,
        )

        # ---- the manifold solve, vectorized over (glass, quad, sample) --
        def solve_one(gi, qi, y3):
            """Newton for the screen point whose refract-refract chain
            through glass sphere gi hits blocker-plane point y3 (3,)."""
            c, r, ior = c_all[gi], r_all[gi], ior_all[gi]
            y2 = plane_coords(qi, y3)
            pq = plane_pack[qi]
            av, bv = qd.av[qi], qd.bv[qi]
            qav, qbv = qd.q_av[qi], qd.q_bv[qi]

            def F(s, y2_):
                p2d, ok = _chain_to_plane(
                    s, frame, c, r, ior, pq, av, bv, qav, qbv
                )
                return p2d - y2_, ok

            def newton(s0):
                def body(_, s):
                    f, _ok = F(s, y2)
                    J = jax.jacfwd(lambda ss: F(ss, y2)[0])(s)
                    det = J[0, 0] * J[1, 1] - J[0, 1] * J[1, 0]
                    inv = jnp.array(
                        [[J[1, 1], -J[0, 1]], [-J[1, 0], J[0, 0]]]
                    ) / jnp.where(jnp.abs(det) < 1e-12, 1e-12, det)
                    step = jnp.sum(inv * f[None, :], axis=-1)
                    # Damped, clipped step: the chain is wildly nonlinear
                    # near the sphere rim.
                    step = jnp.clip(step, -8.0, 8.0)
                    return s - cfg.damping * step

                s = jax.lax.fori_loop(0, cfg.newton_iters, body, s0)
                f, ok = F(s, y2)
                conv = ok & (jnp.linalg.norm(f) < cfg.newton_tol)
                return s, conv

            # Init 1: the direct projection of y3 (no refraction); init 2:
            # the point-inverted image through the sphere center (a thick
            # lens flips the image when the object is outside its focus).
            s_a, t_a, _ = project_to_pixels(frame, y3)
            y_inv = 2.0 * c - y3
            s_b, t_b, _ = project_to_pixels(frame, y_inv)
            s1, conv1 = newton(jnp.stack([s_a, t_a]))
            s2, conv2 = newton(jnp.stack([s_b, t_b]))
            # Keep both roots; dedup (same root found twice -> drop one).
            same = jnp.linalg.norm(s1 - s2) < 0.5  # px
            conv2 = conv2 & ~(conv1 & same)

            # Implicit-function velocities from the converged J: ds/dy2
            # = J^{-1} (F is p2d(s) - y2, so dF/dy2 = -I).
            def lin_x(s_star, conv):
                J = jax.jacfwd(lambda ss: F(ss, y2)[0])(sg(s_star))
                det = J[0, 0] * J[1, 1] - J[0, 1] * J[1, 0]
                bad = jnp.abs(det) < 1e-10
                inv = jnp.array(
                    [[J[1, 1], -J[0, 1]], [-J[1, 0], J[0, 0]]]
                ) / jnp.where(bad, 1e-10, det)
                return sg(inv), conv & ~bad

            inv1, conv1 = lin_x(s1, conv1)
            inv2, conv2 = lin_x(s2, conv2)
            return (
                jnp.stack([s1, s2]),        # (2, 2) screen roots
                jnp.stack([inv1, inv2]),    # (2, 2, 2) J^{-1}
                jnp.stack([conv1, conv2]),  # (2,)
            )

        gi_all = jnp.arange(Sg)
        sol = jax.vmap(
            lambda gi: jax.vmap(
                lambda qi: jax.vmap(
                    lambda m: solve_one(gi, qi, pts[qi, m])
                )(jnp.arange(M4))
            )(jnp.arange(Q))
        )(gi_all)
        s_roots, j_invs, convs = sol  # (Sg, Q, M4, 2, 2), (..., 2,2,2), (...,2)

        # flatten (glass, quad, sample, root) -> K
        K = Sg * Q * M4 * 2
        x_sg = s_roots.reshape(K, 2)
        j_inv = j_invs.reshape(K, 2, 2)
        valid = convs.reshape(K) & jnp.repeat(glass_all, Q * M4 * 2)

        # Per-sample blocker-plane data, broadcast to roots.
        def rep(a):  # (Q, M4, ...) -> (K, ...)
            tiled = jnp.broadcast_to(
                a[None], (Sg,) + a.shape
            ).reshape((Sg * Q * M4,) + a.shape[2:])
            return jnp.repeat(tiled, 2, axis=0)

        dtan2 = rep(
            jnp.stack(
                [
                    jnp.sum(dpts * qd.av[:, None, :], axis=-1),
                    jnp.sum(dpts * qd.bv[:, None, :], axis=-1),
                ],
                axis=-1,
            )
        )  # (K, 2) d(y2)/d(tau)
        dout2 = rep(
            jnp.stack(
                [
                    jnp.sum(out3d * qd.av[:, None, :], axis=-1),
                    jnp.sum(out3d * qd.bv[:, None, :], axis=-1),
                ],
                axis=-1,
            )
        )  # (K, 2) in-plane outward dir

        # Screen-space tangent / outward via ds/dy2 = J^{-1}.
        tangent = jnp.sum(j_inv * dtan2[:, None, :], axis=-1)
        out2d = jnp.sum(j_inv * dout2[:, None, :], axis=-1)

        tan_norm = jnp.linalg.norm(tangent, axis=-1)
        that = tangent / jnp.maximum(tan_norm, 1e-12)[:, None]
        n_hat2 = jnp.stack([that[:, 1], -that[:, 0]], axis=-1)
        out_dot = jnp.sum(n_hat2 * out2d, axis=-1)
        n_hat2 = jnp.where((out_dot < 0.0)[:, None], -n_hat2, n_hat2)
        in_img = (
            (x_sg[:, 0] > -0.5) & (x_sg[:, 0] < width - 0.5)
            & (x_sg[:, 1] > -0.5) & (x_sg[:, 1] < height - 0.5)
        )
        ok = (
            valid & in_img & jnp.isfinite(x_sg).all(axis=-1)
            & jnp.isfinite(tangent).all(axis=-1)
            & (jnp.abs(out_dot) > 1e-9) & (tan_norm < 1e4)
        )

        tr = partial(
            _trace_edge_radiance, scene, frame, key=key,
            background=cam_sg.background, max_depth=max_depth,
            sky_gradient=sky_gradient, spp_edge=cfg.spp_edge,
        )
        l_in1 = tr(x_px=x_sg - cfg.eps_px * n_hat2)
        l_in4 = tr(x_px=x_sg - 4.0 * cfg.eps_px * n_hat2)
        l_in = 2.0 * l_in1 - l_in4
        l_out = tr(x_px=x_sg + cfg.eps_px * n_hat2)

        ix = jnp.clip(jnp.round(x_sg[:, 0]).astype(jnp.int32), 0, width - 1)
        iy = jnp.clip(jnp.round(x_sg[:, 1]).astype(jnp.int32), 0, height - 1)
        ct_px = ct[iy, ix, :]
        dl = 1.0 / Me  # d tau; tangent carries |ds/dtau|
        w = (
            jnp.sum(ct_px * (l_in - l_out), axis=-1)
            * tan_norm * dl * ok.astype(jnp.float32)
        )
        w = sg(jnp.where(jnp.isfinite(w), w, 0.0))
        n_sg2 = sg(n_hat2)
        x_star = sg(x_sg)
        j_inv_sg = sg(j_inv)

        # Differentiable screen positions via the implicit linearization:
        # s(theta) = s* - J^{-1} (p2d_sg(s*) - y2(theta)) where only
        # y2(theta) (the edge point in CURRENT plane coords) varies. Note
        # the blocker's plane itself moving also shifts p2d — that part
        # enters through y2's basis too at first order for in-plane motion;
        # out-of-plane motion of the blocker is captured through y2's
        # dependence on (q, u, v) via the sg'd reciprocal basis. (Bias from
        # freezing the basis is second-order in the displacement.)
        def scalar(p, camera):
            q = p.get("quad_q", scene.quad_q)
            u = p.get("quad_u", scene.quad_u)
            v = p.get("quad_v", scene.quad_v)
            pts_t, _ = quad_edge_points(q, u, v, tau)  # (Q, M4, 3)
            y2_t = jnp.stack(
                [
                    jnp.sum(pts_t * sg(qd.av)[:, None, :], axis=-1) - sg(qd.q_av)[:, None],
                    jnp.sum(pts_t * sg(qd.bv)[:, None, :], axis=-1) - sg(qd.q_bv)[:, None],
                ],
                axis=-1,
            )  # (Q, M4, 2)
            y2_k = rep(y2_t)  # (K, 2)
            # F = p2d(s*) - y2: at theta0 this equals y2_sg - y2 = 0 shift.
            s_theta = x_star + jnp.sum(
                j_inv_sg * (y2_k - sg(y2_k))[:, None, :], axis=-1
            )
            return jnp.sum(w * jnp.sum(s_theta * n_sg2, axis=-1))

        grads, cam_grads = jax.grad(scalar, argnums=(0, 1))(params, cam)
        return grads, cam_grads

    @jax.custom_vjp
    def _refr_image(params, cam, key_bits_f32):
        return jnp.zeros((height, width, 3), jnp.float32)

    def fwd(params, cam, key_bits_f32):
        return (
            jnp.zeros((height, width, 3), jnp.float32),
            (params, cam, key_bits_f32),
        )

    def bwd(res, ct):
        params, cam, key_bits_f32 = res
        key = jax.random.wrap_key_data(
            jax.lax.bitcast_convert_type(key_bits_f32, jnp.uint32)
        )
        g, g_cam = _edge_cotangent(params, cam, key, ct)
        return g, g_cam, jnp.zeros_like(key_bits_f32)

    _refr_image.defvjp(fwd, bwd)

    def refracted_image(params, cam: Camera, key):
        bits = jax.lax.bitcast_convert_type(
            jax.random.key_data(key), jnp.float32
        )
        return _refr_image(params, cam, bits)

    return refracted_image
