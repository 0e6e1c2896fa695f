"""Differentiable rendering + inverse-rendering optimization.

The reference has no autodiff at all (SURVEY.md §2.2 "Gradient parallel:
absent") — this is a north-star capability (BASELINE.json): pixel gradients
w.r.t. scene parameters (sphere centers/radii, albedos, fuzz, IOR, quad
corners, camera) flow through the whole wavefront via:

* reparameterized sampling (core/sampling.py — samples are smooth in their
  uniforms, and the uniforms are parameter-independent);
* the checkpointed `lax.scan` bounce loop (integrator/wavefront.py);
* straight-through discrete events: hit-selection (argmin), the dielectric
  reflect/refract coin and the metal absorb test keep their sampled branch,
  and gradients flow through the selected branch's smooth math; the coin
  additionally carries a likelihood-ratio factor P/sg(P) (== 1.0 forward)
  so d/d_ior includes the branch-probability term (materials.py);
* silhouette (visibility) discontinuities: the boundary term that interior
  autodiff cannot see is added by edge sampling (diff/boundary.py) when
  `boundary=True` — analytic sphere contours + quad edges, primary
  visibility.

Known limits: FIRST-BOUNCE secondary discontinuities (shadow edges cast by
quads/spheres onto diffuse receivers, and area-light rims seen from
receivers) are handled by diff/shadow_edge.py, silhouettes seen in FLAT
METAL MIRRORS by diff/mirror_edge.py, and quad blockers seen THROUGH
dielectric spheres by diff/refracted_edge.py (specular-manifold Newton
solve; recovers the FD gradient that every other estimator misses at
exactly 0.000 — tests/test_glass_gap.py quantifies the gap,
tests/test_refracted_edge.py closes it to ~3%). All opt-in, composing
additively like boundary_image. Still unhandled: deeper-bounce shadow
edges, multi-mirror and mirror-glass mixed paths, sphere blockers behind
glass, TIR-cone crossings, and caustic folds beyond the two Newton
inits.

For LARGE scenes, diff/tape.py offers a tape-replay backend that removes
backward re-intersection entirely (records the per-bounce winner with the
fast forward, differentiates an O(1)-per-segment replay); this module's
scan backend is the default. Which one wins at which primitive count has
not been measured on the GPU.

For multi-device runs the loss is computed under sharding constraints: rays
sharded, scene parameters replicated — XLA inserts the `psum` that all-reduces
parameter gradients across the mesh (SURVEY.md §2.2 "gradient parallel").
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import optax

from raytracer_tpu.core.camera import Camera, camera_frame, camera_rays
from raytracer_tpu.geometry.scene import Scene
from raytracer_tpu.integrator.wavefront import trace

# Scene leaves commonly optimized in inverse rendering.
DEFAULT_TRAINABLE = ("sph_center", "sph_radius", "mat_albedo", "mat_fuzz", "tex_c0")


def split_scene(scene: Scene, trainable=DEFAULT_TRAINABLE):
    """Partition the scene into (params dict, rebuild fn)."""
    params = {name: getattr(scene, name) for name in trainable}

    def rebuild(p):
        return scene.replace(**p)

    return params, rebuild


@partial(
    jax.jit,
    static_argnames=("width", "height", "samples_per_pass", "max_depth", "sky_gradient"),
)
def render_linear_diff(
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
    """Differentiable single-pass render: per-pixel *mean* linear radiance.

    Same sampling as render/driver.render_pass but through the checkpointed
    scan integrator. The closest hit is the platform's (geometry.backend):
    on the GPU the Pallas kernel on stop-gradient inputs with the winner t
    recomputed differentiably, instead of the dense (N, S) candidate arrays.
    """
    n = width * height
    k = samples_per_pass
    frame = camera_frame(cam, width, height)
    pix = jax.lax.broadcasted_iota(jnp.int32, (k * n, 1), 0)[:, 0] % n
    key_cam, key_trace = jax.random.split(key)
    uniforms = jax.random.uniform(key_cam, (k * n, 4), jnp.float32)
    o, d = camera_rays(frame, pix % width, pix // width, uniforms)
    from raytracer_tpu.geometry.backend import intersectors

    radiance = trace(
        scene,
        o,
        d,
        key_trace,
        cam.background,
        max_depth=max_depth,
        sky_gradient=sky_gradient,
        differentiable=True,
        intersect_fn=intersectors().hit_record,
        intersect_fn_differentiable=True,
    )
    return radiance.reshape(k, n, 3).mean(axis=0).reshape(height, width, 3)


def render_loss(
    params: dict,
    rebuild,
    cam: Camera,
    key,
    target,
    *,
    width: int,
    height: int,
    samples_per_pass: int,
    max_depth: int,
    sky_gradient: bool = False,
    boundary_fn=None,
):
    """MSE between a fresh stochastic render and a target image (linear RGB).

    `boundary_fn` (from diff.boundary.make_boundary_image_fn, built with the
    same rebuild/size/depth): adds the zero-valued silhouette-gradient image
    so geometry gradients include the visibility boundary term.
    """
    key_img, key_edge = jax.random.split(key)
    img = render_linear_diff(
        rebuild(params),
        cam,
        key_img,
        width=width,
        height=height,
        samples_per_pass=samples_per_pass,
        max_depth=max_depth,
        sky_gradient=sky_gradient,
    )
    if boundary_fn is not None:
        img = img + boundary_fn(params, cam, key_edge)
    return jnp.mean((img - target) ** 2)


def make_inverse_renderer(
    scene: Scene,
    cam: Camera,
    target,
    *,
    trainable=DEFAULT_TRAINABLE,
    width: int,
    height: int,
    samples_per_pass: int = 4,
    max_depth: int = 8,
    sky_gradient: bool = False,
    learning_rate: float = 1e-2,
    optimizer=None,
    boundary: bool = False,
    shadow_edges: bool = False,
    mirror_edges: bool = False,
    refracted_edges: bool = False,
    trainable_camera: tuple = (),
    backend: str = "scan",
):
    """Build (init_params, opt_state, step_fn) for gradient-descent scene
    recovery (BASELINE.json config 5). `step_fn(params, opt_state, key)`
    returns (params, opt_state, loss). `boundary=True` adds edge-sampled
    silhouette gradients (diff/boundary.py) — needed when the trainables move
    geometry whose silhouettes are in view; `shadow_edges=True` additionally
    adds the first-bounce shadow-edge term (diff/shadow_edge.py).

    backend="bucketed" swaps the checkpointed-scan loss gradient for the
    depth-bucketed tape-replay backend (diff/bucketed.py). Since round 5 it
    composes with boundary/shadow_edges (edge VJPs against the forward
    cotangent) and with `trainable_camera` (camera leaf names, e.g.
    ("look_from", "fov_radians") — leaves live under params["camera"] and
    gradients flow through the replay's camera_rays), so speed and
    silhouettes/camera no longer trade off (round-4 VERDICT #3).
    `trainable_camera` requires the bucketed backend."""
    params, rebuild = split_scene(scene, trainable)
    opt = optimizer or optax.adam(learning_rate)

    def _edge_fns():
        fns = []
        n_src = scene.num_spheres + scene.num_quads
        if boundary:
            from raytracer_tpu.diff.boundary import (
                EdgeSamplingConfig,
                make_boundary_image_fn,
            )

            # Many-primitive scenes scale the per-sphere contour budget
            # down: at 489 spheres the default 256 phi x 8 spp_edge traces
            # ~3M edge paths per step; 64 x 4 keeps the estimator unbiased
            # with ~10x fewer paths — edge noise just adds to the
            # stochastic-gradient noise the optimizer already averages.
            if n_src > 64:
                bcfg = EdgeSamplingConfig(
                    samples_per_sphere=64, samples_per_quad_edge=32,
                    spp_edge=4,
                )
            else:
                bcfg = EdgeSamplingConfig()
            fns.append(make_boundary_image_fn(
                rebuild, width=width, height=height, max_depth=max_depth,
                sky_gradient=sky_gradient, config=bcfg,
            ))
        if shadow_edges:
            from raytracer_tpu.diff.shadow_edge import (
                ShadowEdgeConfig,
                make_shadow_boundary_fn,
            )

            # Production sizes get the importance-subsampled estimator
            # automatically: the exhaustive default (every pixel x every
            # source) is for toy scenes/tests — at 400x225 over a
            # 489-primitive scene it builds multi-GB edge-trace operands.
            n_pix = width * height
            if n_pix > (1 << 14) or n_src > 64:
                # 1024 x 4 x 16-contour traces/step — the demo recovers a
                # blocker from its shadow at a quarter of this budget;
                # estimator noise just adds to the stochastic-gradient noise.
                cfg = ShadowEdgeConfig(
                    receivers=1024, sources_per_receiver=4,
                    samples_per_sphere=16, samples_per_quad_edge=8,
                )
            else:
                cfg = ShadowEdgeConfig()
            fns.append(make_shadow_boundary_fn(
                rebuild, width=width, height=height, max_depth=max_depth,
                sky_gradient=sky_gradient, config=cfg,
            ))
        if mirror_edges:
            from raytracer_tpu.diff.mirror_edge import make_mirror_boundary_fn

            fns.append(make_mirror_boundary_fn(
                rebuild, width=width, height=height, max_depth=max_depth,
                sky_gradient=sky_gradient,
            ))
        if refracted_edges:
            from raytracer_tpu.diff.refracted_edge import (
                make_refracted_boundary_fn,
            )

            fns.append(make_refracted_boundary_fn(
                rebuild, width=width, height=height, max_depth=max_depth,
                sky_gradient=sky_gradient,
            ))
        return tuple(fns)

    if backend == "bucketed":
        from raytracer_tpu.diff.bucketed import (
            CAMERA_PARAM_KEY,
            make_bucketed_grad_fn,
            split_camera,
        )
        rebuild_camera = None
        if trainable_camera:
            cam_params, rebuild_camera = split_camera(cam, trainable_camera)
            params = dict(params)
            params[CAMERA_PARAM_KEY] = cam_params
        opt_state = opt.init(params)

        grad_fn = make_bucketed_grad_fn(
            rebuild, cam, target, width=width, height=height,
            samples_per_pass=samples_per_pass, max_depth=max_depth,
            sky_gradient=sky_gradient,
            edge_image_fns=_edge_fns(),
            rebuild_camera=rebuild_camera,
        )

        def step_bucketed(params, opt_state, key):
            loss, grads = grad_fn(params, key)
            updates, opt_state = opt.update(grads, opt_state, params)
            params = optax.apply_updates(params, updates)
            return params, opt_state, loss

        return params, opt_state, step_bucketed
    assert backend == "scan", backend
    assert not trainable_camera, (
        "trainable_camera requires backend='bucketed'"
    )
    opt_state = opt.init(params)
    edge_fns = _edge_fns()
    boundary_fn = None
    if edge_fns:
        def boundary_fn(p, c, k):
            parts = [
                fn(p, c, kk)
                for fn, kk in zip(edge_fns, jax.random.split(k, len(edge_fns)))
            ]
            return sum(parts[1:], parts[0])
    loss_kw = dict(
        width=width,
        height=height,
        samples_per_pass=samples_per_pass,
        max_depth=max_depth,
        sky_gradient=sky_gradient,
        boundary_fn=boundary_fn,
    )

    @jax.jit
    def step(params, opt_state, key):
        loss, grads = jax.value_and_grad(render_loss)(
            params, rebuild, cam, key, target, **loss_kw
        )
        updates, opt_state = opt.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        return params, opt_state, loss

    return params, opt_state, step
