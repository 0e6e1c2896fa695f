"""Silhouette-aware geometry gradients via primary-visibility edge sampling.

A path-traced pixel is only piecewise-smooth in geometry parameters: moving a
sphere moves its projected silhouette, and the radiance jump across that curve
contributes a *boundary* term that interior autodiff (diff/grad.py) cannot see.
The reference has no autodiff at all (SURVEY.md §2.2); this module implements
the boundary term for the north-star "gradient parity" requirement
(BASELINE.md) using edge sampling in the style of Li et al. 2018
("Differentiable Monte Carlo Ray Tracing through Edge Sampling"),
specialized to this framework's analytic primitives:

* **Spheres** — the visible contour from a pinhole camera is a closed-form
  circle in 3D: for center c, |c|-distance d from the eye o, radius r, the
  contour lies in the plane ``(p - c)·ẑ = -r²/d`` (ẑ = (c-o)/d) with radius
  ``ρ = r·sqrt(d² - r²)/d``. It is smooth in (c, r), so its image-space
  projection differentiates with plain JAX autodiff — no mesh edge detection
  needed.
* **Quads** — the boundary is the 4 straight edges of the parallelogram
  (hittables.go:138-198), linear in (Q, u, v).

For each silhouette sample x(φ; θ) in continuous pixel coordinates, the pixel
integral I (unit box filter, matching camera_rays' jitter) obeys

    dI/dθ = ∫ interior + Σ_samples (L_in - L_out) · (∂x/∂θ · n̂) · |∂x/∂φ| · Δφ

where n̂ is the image-space edge normal pointing *out* of the primitive's
projected region, and L_in / L_out are full path-traced radiances a hair
inside/outside the edge (traced with **common random numbers** so occluded
edge segments cancel to ~0 automatically and the difference has low
variance). The whole term is packaged as a `custom_vjp` function that renders
a zero image forward and injects the edge-sampled parameter cotangent
backward, so it composes with any downstream loss.

Scope (documented limits): primary visibility only — secondary
discontinuities (shadow edges cast on other objects, silhouettes seen in
mirror reflections) are not sampled; pinhole cameras (defocus blur already
smooths primary edges at the lens-integral level).

The secondary gap is QUANTIFIED
(tests/test_boundary_grad.py::test_shadow_edge_bias_quantified): for an
out-of-frame blocker quad sweeping an area-light shadow across in-frame
ground, FD measures dLoss/dx = -0.124 while interior AD and
interior+primary-boundary AD both report 0.000 — the missing shadow-edge
term is ~100% of that gradient axis. The FIRST-BOUNCE case is CLOSED by
diff/shadow_edge.py (path-space edge sampling from receiver points: quad
edges and sphere contours as seen from every first-hit point), which
recovers that axis to within a few percent of FD; deeper-bounce shadow
edges and glossy receivers remain out of scope there (see its docstring).
"""

from __future__ import annotations

import math
from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from raytracer_tpu.core import vecmath as vm
from raytracer_tpu.core.camera import Camera, CameraFrame, camera_frame


class EdgeSamplingConfig(NamedTuple):
    """Static edge-sampling knobs."""

    samples_per_sphere: int = 256  # φ samples around each contour circle
    samples_per_quad_edge: int = 64  # per straight edge (×4 edges)
    spp_edge: int = 8  # radiance samples per edge point per side
    eps_px: float = 0.15  # in/out offset from the edge, pixel units


def project_to_pixels(frame: CameraFrame, p):
    """World point(s) -> continuous pixel coordinates (s, t).

    Inverse of camera_rays' pixel mapping: the ray through image coordinate
    (s, t) points at ``pixel00 + s·du + t·dv``; pixel (i, j) spans
    s ∈ [i-½, i+½). Returns (s, t, in_front) where in_front masks points on
    the camera side of the viewport plane.
    """
    rel = p - frame.center
    q0 = frame.pixel00 - frame.center
    n = jnp.cross(frame.pixel_du, frame.pixel_dv)
    # Elementwise multiply-sums, not `@`: a float32 contraction may run at
    # reduced precision (TF32) on the GPU unless it asks for HIGHEST.
    denom = vm.dot(rel, n)
    lam = vm.dot(q0, n) / jnp.where(jnp.abs(denom) < 1e-12, 1e-12, denom)
    r = lam[..., None] * rel - q0
    s = vm.dot(r, frame.pixel_du) / vm.length_sq(frame.pixel_du)
    t = vm.dot(r, frame.pixel_dv) / vm.length_sq(frame.pixel_dv)
    return s, t, lam > 0.0


def _perp_basis(zh):
    """Orthonormal (e1, e2) ⊥ zh (..., 3), branchless axis pick."""
    up = jnp.where(
        (jnp.abs(zh[..., 1:2]) < 0.9),
        jnp.broadcast_to(jnp.array([0.0, 1.0, 0.0], zh.dtype), zh.shape),
        jnp.broadcast_to(jnp.array([1.0, 0.0, 0.0], zh.dtype), zh.shape),
    )
    e1 = jnp.cross(zh, up)
    e1 = e1 / jnp.linalg.norm(e1, axis=-1, keepdims=True)
    e2 = jnp.cross(zh, e1)
    return e1, e2


def sphere_contour_points(center, radius, eye, phi):
    """Visible-contour circle points of sphere(s) from a pinhole eye.

    center (S,3), radius (S,), phi (M,) -> (p (S,M,3), valid (S,))
    valid = the eye is strictly outside the sphere (else no silhouette).
    Smooth in (center, radius) wherever valid.
    """
    r = jnp.abs(radius)  # negative radius = hollow-glass inner shell, same surface
    z = center - eye
    d = jnp.linalg.norm(z, axis=-1)
    # Eye-outside margin: RELATIVE 1e-4, not 1e-3 — a camera standing 0.5
    # above a radius-1000 ground sphere has d/r ~ 1.0005, and its horizon is
    # a perfectly good silhouette (f32 keeps d^2 - r^2 to ~0.1 absolute at
    # r=1000, plenty for rho).
    margin = r * (1.0 + 1e-4) + 1e-6
    valid = d > margin
    d_safe = jnp.maximum(d, margin)
    zh = z / d_safe[..., None]
    a = r * r / d_safe
    rho = r * jnp.sqrt(jnp.maximum(d_safe * d_safe - r * r, 1e-12)) / d_safe
    e1, e2 = _perp_basis(zh)
    circ = (
        jnp.cos(phi)[None, :, None] * e1[:, None, :]
        + jnp.sin(phi)[None, :, None] * e2[:, None, :]
    )
    p = center[:, None, :] - (a[:, None, None] * zh[:, None, :]) + rho[:, None, None] * circ
    return p, valid


def quad_edge_points(q, u, v, tau):
    """Boundary points of parallelogram quads.

    q/u/v (Q,3), tau (Me,) in [0,1) -> (p (Q, 4*Me, 3), dp/dtau (Q, 4*Me, 3)).
    Edges: q+τu, q+u+τv, q+u+v-τu, q+v-τv (counter-clockwise in (u,v));
    linear in the parameters, so autodiff through this is exact.
    """
    t = tau[None, :, None]
    e0 = q[:, None, :] + t * u[:, None, :]
    e1 = (q + u)[:, None, :] + t * v[:, None, :]
    e2 = (q + u + v)[:, None, :] - t * u[:, None, :]
    e3 = (q + v)[:, None, :] - t * v[:, None, :]
    p = jnp.concatenate([e0, e1, e2, e3], axis=1)
    dp = jnp.concatenate(
        [
            jnp.broadcast_to(u[:, None, :], e0.shape),
            jnp.broadcast_to(v[:, None, :], e1.shape),
            jnp.broadcast_to(-u[:, None, :], e2.shape),
            jnp.broadcast_to(-v[:, None, :], e3.shape),
        ],
        axis=1,
    )
    return p, dp


def _trace_edge_radiance(scene, frame, x_px, key, *, background, max_depth,
                         sky_gradient, spp_edge):
    """Path-traced radiance through continuous pixel coords x_px (K,2).

    Averages spp_edge stochastic paths per point; the SAME key is used for
    matching lane indices across calls (common random numbers for the in/out
    pair). These traces are pure forward evaluations (the edge weights are
    stop-gradient), so the closest hit is the platform's fast search
    (geometry.backend) rather than the differentiable dense one."""
    from raytracer_tpu.geometry.backend import intersectors
    from raytracer_tpu.integrator.wavefront import trace

    intersect_fn = intersectors().hit_record

    k_rep = jnp.tile(x_px, (spp_edge, 1))  # (spp*K, 2)
    target = (
        frame.pixel00
        + k_rep[:, 0:1] * frame.pixel_du
        + k_rep[:, 1:2] * frame.pixel_dv
    )
    origin = jnp.broadcast_to(frame.center, target.shape)
    rad = trace(
        scene,
        origin,
        target - origin,
        key,
        background,
        max_depth=max_depth,
        sky_gradient=sky_gradient,
        intersect_fn=intersect_fn,
        # Unbiased RR with a tight cap: one deep glass path must not hold
        # the whole edge batch at the depth budget (round-5 note in
        # wavefront._bounce_step).
        russian_roulette=True,
        rr_max_q=0.75,
    )
    return rad.reshape(spp_edge, x_px.shape[0], 3).mean(axis=0)


def make_boundary_image_fn(
    rebuild,
    *,
    width: int,
    height: int,
    max_depth: int,
    sky_gradient: bool = False,
    config: EdgeSamplingConfig = EdgeSamplingConfig(),
):
    """Build boundary_image(params, cam, key) -> (H, W, 3).

    Forward: exact zeros (the boundary term has zero *value*, it is pure
    gradient). Backward: edge-sampled silhouette gradients for the geometry
    leaves present in `params` (sph_center, sph_radius, quad_q/u/v) AND for
    the camera pytree — moving the camera moves the projected silhouettes,
    so look_from/look_at/fov get their boundary terms through the same
    x(θ)·n̂ machinery; all other leaves receive zero cotangent. Add its
    output to the interior render (diff/grad.render_linear_diff) before the
    loss.
    """

    cfg = config

    def _edge_cotangent(params, cam: Camera, key, ct):
        sg = jax.lax.stop_gradient
        params_sg = jax.tree_util.tree_map(sg, params)
        scene = rebuild(params_sg)
        cam_sg = jax.tree_util.tree_map(sg, cam)
        frame = camera_frame(cam_sg, width, height)
        eye = frame.center

        # Each piece: (x_fn(params, cam) -> (K,2), x_sg (K,2), tangent_sg
        # (K,2), out2d_sg (K,2) image-space outward direction, valid (K,),
        # dl line-measure per sample).
        pieces = []

        if "sph_center" in params or "sph_radius" in params:
            M = cfg.samples_per_sphere
            phi = (jnp.arange(M, dtype=jnp.float32) + 0.5) * (2.0 * math.pi / M)

            def sphere_x(p, camera):
                c = p.get("sph_center", scene.sph_center)
                r = p.get("sph_radius", scene.sph_radius)
                fr = camera_frame(camera, width, height)
                pts, _ = sphere_contour_points(c, r, fr.center, phi)
                s, t, _ = project_to_pixels(fr, pts)
                return jnp.stack([s, t], axis=-1).reshape(-1, 2)

            c_sg = params_sg.get("sph_center", scene.sph_center)
            r_sg = params_sg.get("sph_radius", scene.sph_radius)
            pts, valid_s = sphere_contour_points(c_sg, r_sg, eye, phi)
            # dp/dφ analytically: derivative of the circle parameterization.
            dphi = jnp.stack([-jnp.sin(phi), jnp.cos(phi)], axis=-1)
            zh = (c_sg - eye)
            d = jnp.linalg.norm(zh, axis=-1, keepdims=True)
            zh = zh / jnp.maximum(d, 1e-6)
            e1, e2 = _perp_basis(zh)
            r_abs = jnp.abs(r_sg)
            rho = r_abs * jnp.sqrt(
                jnp.maximum(d[:, 0] ** 2 - r_abs**2, 1e-12)
            ) / jnp.maximum(d[:, 0], 1e-6)
            dpts = rho[:, None, None] * (
                dphi[None, :, 0:1] * e1[:, None, :] + dphi[None, :, 1:2] * e2[:, None, :]
            )

            def proj2(pp):
                s, t, _ = project_to_pixels(frame, pp)
                return jnp.stack([s, t], axis=-1)

            x_sg, tangent = jax.jvp(proj2, (pts,), (dpts,))
            _, _, front = project_to_pixels(frame, pts)
            # Outward orientation from 3D: the surface normal (p - c)/|p - c|
            # points out of the sphere; its image-space pushforward points out
            # of the projected region. (A projected-center anchor is WRONG
            # when the center lies behind the eye plane — e.g. a giant ground
            # sphere whose horizon is in view — because project_to_pixels
            # point-mirrors behind-eye points.)
            n3d = pts - c_sg[:, None, :]
            n3d = n3d / jnp.maximum(
                jnp.linalg.norm(n3d, axis=-1, keepdims=True), 1e-12
            )
            _, out2d = jax.jvp(proj2, (pts,), (n3d,))
            valid = (valid_s[:, None] & front).reshape(-1)
            dl = (2.0 * math.pi / M)  # Δφ
            pieces.append((sphere_x, x_sg.reshape(-1, 2), tangent.reshape(-1, 2),
                           out2d.reshape(-1, 2), valid, dl))

        if any(k in params for k in ("quad_q", "quad_u", "quad_v")) and scene.num_quads:
            Me = cfg.samples_per_quad_edge
            tau = (jnp.arange(Me, dtype=jnp.float32) + 0.5) / Me

            def quad_x(p, camera):
                q = p.get("quad_q", scene.quad_q)
                u = p.get("quad_u", scene.quad_u)
                v = p.get("quad_v", scene.quad_v)
                fr = camera_frame(camera, width, height)
                pts, _ = quad_edge_points(q, u, v, tau)
                s, t, _ = project_to_pixels(fr, pts)
                return jnp.stack([s, t], axis=-1).reshape(-1, 2)

            q_sg = params_sg.get("quad_q", scene.quad_q)
            u_sg = params_sg.get("quad_u", scene.quad_u)
            v_sg = params_sg.get("quad_v", scene.quad_v)
            pts, dpts = quad_edge_points(q_sg, u_sg, v_sg, tau)

            def proj3(pp):
                s, t, _ = project_to_pixels(frame, pp)
                return jnp.stack([s, t], axis=-1)

            x_sg, tangent = jax.jvp(proj3, (pts,), (dpts,))
            _, _, front = project_to_pixels(frame, pts)
            # In-plane outward directions per edge (interior of the
            # parallelogram lies toward +v/-u/-v/+u respectively); their
            # image pushforward orients the 2D normal without any anchor.
            out3d = jnp.concatenate(
                [
                    jnp.broadcast_to(-v_sg[:, None, :], (v_sg.shape[0], Me, 3)),
                    jnp.broadcast_to(u_sg[:, None, :], (u_sg.shape[0], Me, 3)),
                    jnp.broadcast_to(v_sg[:, None, :], (v_sg.shape[0], Me, 3)),
                    jnp.broadcast_to(-u_sg[:, None, :], (u_sg.shape[0], Me, 3)),
                ],
                axis=1,
            )
            _, out2d = jax.jvp(proj3, (pts,), (out3d,))
            valid = front.reshape(-1)
            dl = 1.0 / Me  # Δτ; tangent already carries |dx/dτ|
            pieces.append((quad_x, x_sg.reshape(-1, 2), tangent.reshape(-1, 2),
                           out2d.reshape(-1, 2), valid, dl))

        zero_cam = jax.tree_util.tree_map(jnp.zeros_like, cam)
        if not pieces:
            return jax.tree_util.tree_map(jnp.zeros_like, params), zero_cam

        grads = jax.tree_util.tree_map(jnp.zeros_like, params)
        cam_grads = zero_cam
        for x_fn, x_sg, tangent, out2d, valid, dl in pieces:
            tan_norm = jnp.linalg.norm(tangent, axis=-1)
            that = tangent / jnp.maximum(tan_norm, 1e-12)[:, None]
            # 2D normal of the edge, oriented along the projected outward
            # direction (away from the primitive's image region).
            n_hat = jnp.stack([that[:, 1], -that[:, 0]], axis=-1)
            out_dot = jnp.sum(n_hat * out2d, axis=-1)
            n_hat = jnp.where((out_dot < 0.0)[:, None], -n_hat, n_hat)

            in_img = (
                (x_sg[:, 0] > -0.5) & (x_sg[:, 0] < width - 0.5)
                & (x_sg[:, 1] > -0.5) & (x_sg[:, 1] < height - 0.5)
            )
            ok = (
                valid & in_img & jnp.isfinite(x_sg).all(axis=-1)
                # Edge-on views: the outward pushforward vanishes and the
                # orientation is undefined (the contribution is, too).
                & (jnp.abs(out_dot) > 1e-9)
            )

            # Common-random-number radiance a hair inside/outside the edge.
            # Inside a curved silhouette the hit normal rotates like O(√ε), so
            # L_in(ε) = L_in(0) + c·√ε: extrapolate to the edge limit with a
            # second evaluation at 4ε (√(4ε)=2√ε ⇒ L(0) ≈ 2L(ε) − L(4ε)).
            tr = partial(
                _trace_edge_radiance, scene, frame, key=key,
                background=cam_sg.background, max_depth=max_depth,
                sky_gradient=sky_gradient, spp_edge=cfg.spp_edge,
            )
            l_in1 = tr(x_px=x_sg - cfg.eps_px * n_hat)
            l_in4 = tr(x_px=x_sg - 4.0 * cfg.eps_px * n_hat)
            l_in = 2.0 * l_in1 - l_in4
            l_out = tr(x_px=x_sg + cfg.eps_px * n_hat)

            ix = jnp.clip(jnp.round(x_sg[:, 0]).astype(jnp.int32), 0, width - 1)
            iy = jnp.clip(jnp.round(x_sg[:, 1]).astype(jnp.int32), 0, height - 1)
            ct_px = ct[iy, ix, :]  # (K, 3)

            w = (
                jnp.sum(ct_px * (l_in - l_out), axis=-1)
                * tan_norm
                * dl
                * ok.astype(jnp.float32)
            )
            w = sg(jnp.where(jnp.isfinite(w), w, 0.0))
            n_sg = sg(n_hat)

            def scalar(p, camera):
                x = x_fn(p, camera)
                return jnp.sum(w * jnp.sum(x * n_sg, axis=-1))

            piece_grads, piece_cam = jax.grad(scalar, argnums=(0, 1))(params, cam)
            grads = jax.tree_util.tree_map(jnp.add, grads, piece_grads)
            cam_grads = jax.tree_util.tree_map(jnp.add, cam_grads, piece_cam)
        return grads, cam_grads

    # The PRNG key rides through custom_vjp as float32-bitcast raw bits —
    # integer/key-typed args would need float0 cotangents; a float arg just
    # gets zeros.
    @jax.custom_vjp
    def _boundary_image(params, cam, key_bits_f32):
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

    _boundary_image.defvjp(fwd, bwd)

    def boundary_image(params, cam: Camera, key):
        bits = jax.lax.bitcast_convert_type(jax.random.key_data(key), jnp.float32)
        return _boundary_image(params, cam, bits)

    return boundary_image
