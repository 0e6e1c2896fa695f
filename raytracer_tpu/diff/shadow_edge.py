"""Secondary-discontinuity (shadow-edge) gradients via path-space edge
sampling from receiver points.

diff/boundary.py handles PRIMARY visibility: silhouettes as seen from the
camera. This module adds the next order — silhouettes as seen from the
FIRST-BOUNCE receiver point: when an occluder (or an area light's own rim)
sweeps its projected edge across the hemisphere of scatter directions above
a diffuse receiver, the one-bounce radiance integrand jumps, and interior
autodiff misses the moving-boundary term entirely (quantified in
tests/test_boundary_grad.py::test_shadow_edge_bias_quantified: FD -0.124 vs
interior/primary-boundary AD 0.000 on a blocker-position axis).

Derivation. The expected one-bounce contribution at a receiver y with
normal n_y and Lambertian albedo rho is

    E(theta) = rho * INT_hemisphere L(omega; theta) p(omega) d(omega),

with p = cos/pi (the reference's `normal + unit sphere` scatter is exactly
cosine-distributed, vec3.go:182-190 + materials.go:33-42). An occluder B
projects a region Omega(theta) on the direction sphere; L jumps across its
boundary curve omega(phi; theta). Reynolds transport gives the boundary
term

    d E/d theta |_boundary =
      rho * SUM_samples (L_in - L_out)(omega) * p(omega)
            * (d omega/d theta . n_hat) * ||d omega/d phi|| * d phi,

with n_hat the outward (unoccluded-side) unit normal of the curve in the
tangent plane at omega — the direction-sphere analog of the image-space
formula in diff/boundary.py, and the same estimator shape: common-random-
number radiance pairs a hair to each side of the edge (so already-occluded
edge segments cancel), weights stop-gradiented, and the parameter velocity
injected by differentiating omega(z(theta), y) = (z - y)/||z - y|| through
a scalar surrogate SUM sg(w) * (omega(theta) . sg(n_hat)).

Edge sources per receiver: every quad's 4 edges (this covers BOTH shadow
blockers and the area light's own rim — the latter carries emitted-vs-
background jumps, i.e. light-geometry gradients) and every sphere's visible
contour from y (closed form, boundary.sphere_contour_points with eye = y).

Scope (documented): first-bounce Lambertian receivers (deeper-bounce shadow
edges and glossy/dielectric receivers are not sampled — their BSDF is not
the cosine density this derivation folds in); receiver motion is frozen
(gradients flow to the EDGE-CASTING geometry z(theta), not through y —
receiver-silhouette motion is the primary term, handled by diff/boundary).

Reference: the estimator family is Li et al. 2018 ("Differentiable Monte
Carlo Ray Tracing through Edge Sampling") secondary edges, specialized to
this framework's analytic primitives; the reference renderer
(/root/reference) has no autodiff at all — this is north-star capability
(BASELINE.md gradient axis).
"""

from __future__ import annotations

import math
from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from raytracer_tpu.core.camera import Camera, camera_frame, camera_rays
from raytracer_tpu.diff.boundary import _perp_basis, quad_edge_points, sphere_contour_points
from raytracer_tpu.geometry.intersect import intersect_scene
from raytracer_tpu.geometry.scene import LAMBERTIAN
from raytracer_tpu.materials.textures import eval_texture


class ShadowEdgeConfig(NamedTuple):
    """Static shadow-edge sampling knobs. Trace cost scales as
    R x (4 * Kq * samples_per_quad_edge + Ks * samples_per_sphere)
    x 3 traces x spp_edge, where R = receivers (or every pixel when 0) and
    Kq/Ks = sources_per_receiver (or every quad/sphere when 0).

    Round-4 scaling knobs (VERDICT #7 — the exhaustive estimator was
    unusable past toy scenes):

    * `receivers` > 0: instead of one edge estimate per PIXEL, sample R
      receivers with probability proportional to the pixel's loss
      cotangent magnitude (pixels the loss does not touch carry zero
      gradient and are never sampled) and reweight by 1/(R p_i) — an
      unbiased self-normalized importance scheme over receivers.
    * `sources_per_receiver` > 0: per receiver, sample K edge SOURCES
      (whole quads / whole spheres) with probability proportional to
      their projected solid angle from that receiver (area/d^2, r^2/d^2)
      and reweight by 1/(K p_j); a far or tiny blocker is rarely sampled
      but keeps its exact expectation. Sampling whole sources keeps the
      per-source line measure intact.

    Both default 0 = exhaustive (the toy-scale behavior, used by the
    bias-quantification tests)."""

    samples_per_quad_edge: int = 8  # per straight edge (x4 edges)
    samples_per_sphere: int = 32  # phi samples around each contour circle
    spp_edge: int = 2  # radiance samples per edge point per side
    eps_dir: float = 2e-3  # in/out angular offset from the edge (radians)
    receivers: int = 0  # 0 = every pixel; else importance-sampled count
    sources_per_receiver: int = 0  # 0 = every source of each kind


def _trace_dirs(scene, origin, direction, key, *, background, max_depth,
                sky_gradient, spp_edge):
    """Path-traced radiance from explicit (origin, direction) lanes,
    averaged over spp_edge CRN repeats (same key for matching lanes across
    calls — the in/out difference cancels on already-occluded segments)."""
    from raytracer_tpu.geometry.backend import intersectors
    from raytracer_tpu.integrator.wavefront import trace

    # Pure forward evaluations (edge weights are stop-gradient): the
    # platform's fast closest hit, as in boundary._trace_edge_radiance.
    intersect_fn = intersectors().hit_record

    o = jnp.tile(origin, (spp_edge, 1))
    d = jnp.tile(direction, (spp_edge, 1))
    rad = trace(
        scene, o, d, key, background,
        max_depth=max_depth, sky_gradient=sky_gradient,
        intersect_fn=intersect_fn,
        russian_roulette=True, rr_max_q=0.75,
    )
    return rad.reshape(spp_edge, origin.shape[0], 3).mean(axis=0)


def make_shadow_boundary_fn(
    rebuild,
    *,
    width: int,
    height: int,
    max_depth: int,
    sky_gradient: bool = False,
    config: ShadowEdgeConfig = ShadowEdgeConfig(),
):
    """Build shadow_image(params, cam, key) -> (H, W, 3).

    Forward: exact zeros (pure-gradient term, like boundary.py). Backward:
    shadow-edge cotangents for the geometry leaves present in `params`
    (sph_center, sph_radius, quad_q/u/v); every other leaf (and the camera)
    receives zeros. Compose additively with render_linear_diff and
    boundary_image before the loss.
    """
    cfg = config

    def _shadow_cotangent(params, cam: Camera, key, ct):
        sg = jax.lax.stop_gradient
        params_sg = jax.tree_util.tree_map(sg, params)
        scene = rebuild(params_sg)
        cam_sg = jax.tree_util.tree_map(sg, cam)
        frame = camera_frame(cam_sg, width, height)

        # ---- receivers: one jittered camera ray per pixel ----------------
        n_pix = width * height
        pix = jnp.arange(n_pix, dtype=jnp.int32)
        k_cam, k_recv, k_src, k_tr = jax.random.split(key, 4)
        cam_uni = jax.random.uniform(k_cam, (n_pix, 4), jnp.float32)
        o, d = camera_rays(frame, pix % width, pix // width, cam_uni)
        hit = intersect_scene(scene, o, d)
        mat_type = scene.mat_type[hit.mat_id]
        recv_ok = hit.hit & (mat_type == LAMBERTIAN)
        y = hit.point  # (P, 3)
        n_y = hit.normal
        rho = eval_texture(scene, scene.mat_tex[hit.mat_id], hit.u, hit.v, y)
        ct_px = ct.reshape(n_pix, 3)  # receiver i estimates pixel i

        # ---- receiver subsampling (cfg.receivers > 0) --------------------
        # Sample R receivers ∝ loss-cotangent magnitude and reweight by
        # 1/(R p): unbiased, and pixels the loss does not touch (zero
        # cotangent) are never traced. With an all-zero cotangent the
        # weights vanish regardless of which indices get drawn, so the
        # uniform fallback inside the probabilities is harmless.
        n_recv = n_pix
        if cfg.receivers and cfg.receivers < n_pix:
            n_recv = cfg.receivers
            s_imp = jnp.sum(jnp.abs(ct_px), axis=-1) * recv_ok + 1e-30
            p_r = s_imp / jnp.sum(s_imp)
            idx_r = jax.random.choice(
                k_recv, n_pix, (n_recv,), replace=True, p=p_r
            )
            y = y[idx_r]
            n_y = n_y[idx_r]
            rho = rho[idx_r]
            recv_ok = recv_ok[idx_r]
            ct_px = ct_px[idx_r] / (
                jnp.float32(n_recv) * p_r[idx_r]
            )[:, None]

        zeros = jax.tree_util.tree_map(jnp.zeros_like, params)
        pieces = []  # (omega_fn(params) -> (P*M, 3), w (P*M,), n_hat (P*M, 3))

        def finish(z_sg, dz_sg, out3d, valid_edge, dl, omega_fn):
            """Shared weight computation for one edge family.

            z_sg (P, M, 3) edge points (stop-grad), dz_sg dz/dparam_of_curve,
            out3d (P, M, 3) a 3D direction pointing out of the occluded
            region at z, valid_edge (P, M), dl the per-sample line measure,
            omega_fn(params) -> (P, M, 3) the differentiable directions."""
            rel = z_sg - y[:, None, :]
            dist = jnp.linalg.norm(rel, axis=-1, keepdims=True)
            omega = rel / jnp.maximum(dist, 1e-9)
            # d omega / d phi: pushforward of the curve velocity through
            # normalize(z - y) (y fixed).
            dom = (dz_sg - jnp.sum(dz_sg * omega, axis=-1, keepdims=True) * omega) / (
                jnp.maximum(dist, 1e-9)
            )
            tan_norm = jnp.linalg.norm(dom, axis=-1)
            that = dom / jnp.maximum(tan_norm, 1e-12)[..., None]
            n_hat = jnp.cross(that, omega)
            n_hat = n_hat / jnp.maximum(
                jnp.linalg.norm(n_hat, axis=-1, keepdims=True), 1e-12
            )
            # Orient outward: along the tangent-plane projection of out3d.
            out_t = out3d - jnp.sum(out3d * omega, axis=-1, keepdims=True) * omega
            sgn = jnp.sum(n_hat * out_t, axis=-1)
            n_hat = jnp.where((sgn < 0.0)[..., None], -n_hat, n_hat)

            cosw = jnp.sum(omega * n_y[:, None, :], axis=-1)
            p_dir = jnp.maximum(cosw, 0.0) * (1.0 / math.pi)
            ok = (
                valid_edge
                & recv_ok[:, None]
                & (p_dir > 0.0)
                & (tan_norm > 1e-9)
                & (jnp.abs(sgn) > 1e-9)
                & jnp.isfinite(omega).all(axis=-1)
            )

            P, M = omega.shape[0], omega.shape[1]
            flat = lambda a: a.reshape(P * M, *a.shape[2:])
            om_f, nh_f = flat(omega), flat(n_hat)
            # CRN radiance just inside/outside the edge; origins at the
            # receiver, lifted off the surface like the integrator does
            # (t_min plays that role in trace's closest hit).
            origin = jnp.broadcast_to(y[:, None, :], omega.shape).reshape(P * M, 3)
            tr = partial(
                _trace_dirs, scene, origin, key=k_tr,
                background=cam_sg.background, max_depth=max_depth - 1,
                sky_gradient=sky_gradient, spp_edge=cfg.spp_edge,
            )
            e = cfg.eps_dir
            # Curvature extrapolation (see boundary.py): inside a curved
            # silhouette L varies like sqrt(eps) — L(0) ~ 2 L(e) - L(4e).
            l_in = 2.0 * tr(direction=om_f - e * nh_f) - tr(
                direction=om_f - 4.0 * e * nh_f
            )
            l_out = tr(direction=om_f + e * nh_f)
            jump = (l_in - l_out).reshape(P, M, 3)

            w = (
                jnp.sum(ct_px[:, None, :] * rho[:, None, :] * jump, axis=-1)
                * p_dir
                * tan_norm
                * dl
                * ok.astype(jnp.float32)
            )
            w = sg(jnp.where(jnp.isfinite(w), w, 0.0)).reshape(P * M)
            pieces.append((omega_fn, w, sg(nh_f)))

        y_sg = sg(y)

        # ---- quad edges (blockers AND area-light rims) --------------------
        if any(k in params for k in ("quad_q", "quad_u", "quad_v")) and scene.num_quads:
            Me = cfg.samples_per_quad_edge
            tau = (jnp.arange(Me, dtype=jnp.float32) + 0.5) / Me
            q_sg = params_sg.get("quad_q", scene.quad_q)
            u_sg = params_sg.get("quad_u", scene.quad_u)
            v_sg = params_sg.get("quad_v", scene.quad_v)
            pts, dpts = quad_edge_points(q_sg, u_sg, v_sg, tau)  # (Q, 4Me, 3)
            Q, M4 = pts.shape[0], pts.shape[1]
            # Out-of-region 3D hints per edge (interior lies toward
            # +v/-u/-v/+u; same table as boundary.py).
            out3d = jnp.concatenate(
                [
                    jnp.broadcast_to(-v_sg[:, None, :], (Q, Me, 3)),
                    jnp.broadcast_to(u_sg[:, None, :], (Q, Me, 3)),
                    jnp.broadcast_to(v_sg[:, None, :], (Q, Me, 3)),
                    jnp.broadcast_to(-u_sg[:, None, :], (Q, Me, 3)),
                ],
                axis=1,
            )
            sel_q = None
            if cfg.sources_per_receiver and Q > cfg.sources_per_receiver:
                # Per-receiver source selection ∝ projected solid angle
                # (area / d^2), reweighted by 1/(K p): the far/tiny quads
                # keep their expectation but stop costing traces.
                Kq = cfg.sources_per_receiver
                area = jnp.linalg.norm(jnp.cross(u_sg, v_sg), axis=-1)
                qc = q_sg + 0.5 * (u_sg + v_sg)
                d2 = jnp.sum(
                    (qc[None, :, :] - y_sg[:, None, :]) ** 2, axis=-1
                )
                imp = area[None, :] / jnp.maximum(d2, 1e-6) + 1e-20
                p_src = imp / jnp.sum(imp, axis=-1, keepdims=True)
                sel_q = jax.vmap(
                    lambda k_, lg: jax.random.categorical(k_, lg, shape=(Kq,))
                )(
                    jax.random.split(jax.random.fold_in(k_src, 0), n_recv),
                    jnp.log(p_src),
                )  # (P, Kq)
                w_src = 1.0 / (
                    jnp.float32(Kq)
                    * jnp.take_along_axis(p_src, sel_q, axis=-1)
                )  # (P, Kq)
                z_sg = pts[sel_q].reshape(n_recv, Kq * M4, 3)
                dz_sg = dpts[sel_q].reshape(n_recv, Kq * M4, 3)
                o3 = out3d[sel_q].reshape(n_recv, Kq * M4, 3)
                valid = jnp.ones((n_recv, Kq * M4), bool)
                dl = jnp.broadcast_to(
                    (w_src / Me)[:, :, None], (n_recv, Kq, M4)
                ).reshape(n_recv, Kq * M4)
                n_qsel = Kq
            else:
                z_sg = jnp.broadcast_to(
                    pts.reshape(1, Q * M4, 3), (n_recv, Q * M4, 3)
                )
                dz_sg = jnp.broadcast_to(
                    dpts.reshape(1, Q * M4, 3), (n_recv, Q * M4, 3)
                )
                o3 = jnp.broadcast_to(
                    out3d.reshape(1, Q * M4, 3), (n_recv, Q * M4, 3)
                )
                # Degenerate (dummy) quads have zero edge velocity -> masked
                # by the tan_norm guard in finish().
                valid = jnp.ones((n_recv, Q * M4), bool)
                dl = 1.0 / Me
                n_qsel = Q

            def quad_omega(p, sel_q=sel_q, n_qsel=n_qsel):
                q = p.get("quad_q", scene.quad_q)
                u = p.get("quad_u", scene.quad_u)
                v = p.get("quad_v", scene.quad_v)
                z, _ = quad_edge_points(q, u, v, tau)
                if sel_q is not None:
                    zsel = z[sel_q]  # (P, Kq, 4Me, 3); indices stop-grad
                    rel = zsel.reshape(n_recv, n_qsel * M4, 3) - y_sg[:, None, :]
                else:
                    rel = z.reshape(1, Q * M4, 3) - y_sg[:, None, :]
                n = jnp.linalg.norm(rel, axis=-1, keepdims=True)
                return (rel / jnp.maximum(n, 1e-9)).reshape(
                    n_recv * n_qsel * M4, 3
                )

            finish(z_sg, dz_sg, o3, valid, dl, quad_omega)

        # ---- sphere contours seen from each receiver ----------------------
        if ("sph_center" in params or "sph_radius" in params) and scene.num_spheres:
            Mp = cfg.samples_per_sphere
            phi = (jnp.arange(Mp, dtype=jnp.float32) + 0.5) * (2.0 * math.pi / Mp)
            c_sg = params_sg.get("sph_center", scene.sph_center)
            r_sg = params_sg.get("sph_radius", scene.sph_radius)

            def contours(eye):
                pts, valid_s = sphere_contour_points(c_sg, r_sg, eye, phi)
                return pts, valid_s  # (S, Mp, 3), (S,)

            pts, valid_s = jax.vmap(contours)(y_sg)  # (P, S, Mp, 3), (P, S)
            S = c_sg.shape[0]
            # d pts / d phi analytically (same circle algebra as boundary.py),
            # per receiver eye.
            zc = c_sg[None, :, :] - y_sg[:, None, :]
            dd = jnp.linalg.norm(zc, axis=-1)
            zh = zc / jnp.maximum(dd, 1e-6)[..., None]
            e1, e2 = _perp_basis(zh)
            r_abs = jnp.abs(r_sg)[None, :]
            rho_c = r_abs * jnp.sqrt(
                jnp.maximum(dd * dd - r_abs * r_abs, 1e-12)
            ) / jnp.maximum(dd, 1e-6)
            dphi = jnp.stack([-jnp.sin(phi), jnp.cos(phi)], axis=-1)  # (Mp, 2)
            dpts = rho_c[..., None, None] * (
                dphi[None, None, :, 0:1] * e1[:, :, None, :]
                + dphi[None, None, :, 1:2] * e2[:, :, None, :]
            )  # (P, S, Mp, 3)
            # Outward hint: the sphere surface normal at the contour point.
            n3d = pts - c_sg[None, :, None, :]
            # Dummy spheres (radius 0) are invalid via sphere_contour_points.

            sel_s = None
            if cfg.sources_per_receiver and S > cfg.sources_per_receiver:
                # Per-receiver selection ∝ projected solid angle (r/d)^2;
                # invalid contours (receiver inside the sphere, dummies)
                # get ~zero probability.
                Ks = cfg.sources_per_receiver
                imp = (r_abs / jnp.maximum(dd, 1e-6)) ** 2 * valid_s + 1e-20
                p_src = imp / jnp.sum(imp, axis=-1, keepdims=True)
                sel_s = jax.vmap(
                    lambda k_, lg: jax.random.categorical(k_, lg, shape=(Ks,))
                )(
                    jax.random.split(jax.random.fold_in(k_src, 1), n_recv),
                    jnp.log(p_src),
                )  # (P, Ks)
                w_src = 1.0 / (
                    jnp.float32(Ks)
                    * jnp.take_along_axis(p_src, sel_s, axis=-1)
                )
                gat = lambda a: jnp.take_along_axis(
                    a, sel_s[:, :, None, None], axis=1
                )
                pts_g = gat(pts)  # (P, Ks, Mp, 3)
                dpts_g = gat(dpts)
                n3d_g = gat(n3d)
                valid_g = jnp.take_along_axis(valid_s, sel_s, axis=1)
                valid = jnp.broadcast_to(
                    valid_g[:, :, None], (n_recv, Ks, Mp)
                )
                dl = jnp.broadcast_to(
                    (w_src * (2.0 * math.pi / Mp))[:, :, None],
                    (n_recv, Ks, Mp),
                ).reshape(n_recv, Ks * Mp)
                z_sg2 = pts_g.reshape(n_recv, Ks * Mp, 3)
                dz_sg2 = dpts_g.reshape(n_recv, Ks * Mp, 3)
                o32 = n3d_g.reshape(n_recv, Ks * Mp, 3)
                n_ssel = Ks
            else:
                valid = jnp.broadcast_to(valid_s[:, :, None], (n_recv, S, Mp))
                dl = 2.0 * math.pi / Mp
                z_sg2 = pts.reshape(n_recv, S * Mp, 3)
                dz_sg2 = dpts.reshape(n_recv, S * Mp, 3)
                o32 = n3d.reshape(n_recv, S * Mp, 3)
                n_ssel = S

            def sphere_omega(p, sel_s=sel_s, n_ssel=n_ssel):
                c = p.get("sph_center", scene.sph_center)
                r = p.get("sph_radius", scene.sph_radius)

                def one(eye):
                    z, _ = sphere_contour_points(c, r, eye, phi)
                    return z  # (S, Mp, 3)

                z = jax.vmap(one)(y_sg)  # (P, S, Mp, 3)
                if sel_s is not None:
                    z = jnp.take_along_axis(
                        z, sel_s[:, :, None, None], axis=1
                    )  # (P, Ks, Mp, 3)
                rel = z.reshape(n_recv, n_ssel * Mp, 3) - y_sg[:, None, :]
                n = jnp.linalg.norm(rel, axis=-1, keepdims=True)
                return (rel / jnp.maximum(n, 1e-9)).reshape(
                    n_recv * n_ssel * Mp, 3
                )

            finish(
                z_sg2, dz_sg2, o32, valid.reshape(n_recv, n_ssel * Mp),
                dl, sphere_omega,
            )

        if not pieces:
            return zeros

        grads = zeros
        for omega_fn, w, n_sg in pieces:
            def scalar(p):
                om = omega_fn(p)
                return jnp.sum(w * jnp.sum(om * n_sg, axis=-1))

            grads = jax.tree_util.tree_map(
                jnp.add, grads, jax.grad(scalar)(params)
            )
        return grads

    @jax.custom_vjp
    def _shadow_image(params, cam, key_bits_f32):
        return jnp.zeros((height, width, 3), jnp.float32)

    def fwd(params, cam, key_bits_f32):
        return jnp.zeros((height, width, 3), jnp.float32), (params, cam, key_bits_f32)

    def bwd(res, ct):
        params, cam, key_bits_f32 = res
        key = jax.random.wrap_key_data(
            jax.lax.bitcast_convert_type(key_bits_f32, jnp.uint32)
        )
        grads = _shadow_cotangent(params, cam, key, ct)
        zero_cam = jax.tree_util.tree_map(jnp.zeros_like, cam)
        return grads, zero_cam, jnp.zeros_like(key_bits_f32)

    _shadow_image.defvjp(fwd, bwd)

    def shadow_image(params, cam: Camera, key):
        bits = jax.lax.bitcast_convert_type(
            jax.random.key_data(key), jnp.float32
        )
        return _shadow_image(params, cam, bits)

    return shadow_image
