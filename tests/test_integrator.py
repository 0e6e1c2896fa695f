"""Wavefront integrator semantics vs Ray.GetColor (ray.go:32-54)."""

import numpy as np
import jax
import jax.numpy as jnp

from raytracer_tpu.geometry.scene import SceneBuilder
from raytracer_tpu.integrator.wavefront import sky_color, trace


def _trace(scene, o, d, background=(0.7, 0.8, 1.0), **kw):
    return np.asarray(
        trace(
            scene,
            jnp.asarray(o, jnp.float32),
            jnp.asarray(d, jnp.float32),
            jax.random.PRNGKey(0),
            jnp.asarray(background, jnp.float32),
            **kw,
        )
    )


def test_miss_returns_background():
    b = SceneBuilder(0)
    b.add_sphere((0, 0, -5), 1.0, b.lambertian((0.5, 0.5, 0.5)))
    scene = b.build()
    rad = _trace(scene, [[0, 0, 0]], [[0, 1, 0]], background=(0.25, 0.5, 0.75))
    np.testing.assert_allclose(rad[0], [0.25, 0.5, 0.75], rtol=1e-6)


def test_depth_zero_is_black():
    b = SceneBuilder(0)
    b.add_sphere((0, 0, -5), 1.0, b.lambertian((0.5, 0.5, 0.5)))
    scene = b.build()
    rad = _trace(scene, [[0, 0, 0]], [[0, 0, -1]], max_depth=0)
    np.testing.assert_allclose(rad, 0.0)


def test_light_hit_returns_emission_exactly():
    b = SceneBuilder(0)
    b.add_sphere((0, 0, -5), 1.0, b.diffuse_light((4, 5, 6)))
    scene = b.build()
    rad = _trace(scene, [[0, 0, 0]], [[0, 0, -1]], background=(0, 0, 0))
    np.testing.assert_allclose(rad[0], [4, 5, 6], rtol=1e-6)


def test_single_bounce_lambertian_energy():
    """One lambertian bounce then background: radiance = albedo * bg when
    every scattered ray escapes (sphere floating in sky)."""
    b = SceneBuilder(0)
    b.add_sphere((0, 0, -5), 1.0, b.lambertian((0.5, 0.5, 0.5)))
    scene = b.build()
    n = 4096
    o = np.zeros((n, 3), np.float32)
    d = np.tile(np.array([[0, 0, -1.0]], np.float32), (n, 1))
    rad = _trace(scene, o, d, background=(1.0, 1.0, 1.0))
    # All paths: hit, attenuate 0.5, scatter up/out, hit sphere again sometimes...
    # With a convex sphere, a scattered ray can re-hit once more; bound loosely.
    assert 0.3 < rad.mean() < 0.55
    # Exact check with max_depth=1: hit -> scatter -> loop ends -> black tail,
    # so radiance is 0 (emission only) for every lane.
    rad1 = _trace(scene, o, d, background=(1, 1, 1), max_depth=1)
    np.testing.assert_allclose(rad1, 0.0, atol=1e-7)


def test_mirror_chain_multiplies_albedo():
    """Two parallel perfect mirrors facing each other with a gap: a ray
    bouncing N times then escaping carries albedo^N * background."""
    b = SceneBuilder(0)
    m = b.metal((0.8, 0.8, 0.8), 0.0)
    # One mirror quad at z=-2, ray hits it and reflects straight back out.
    b.add_quad((-1, -1, -2), (2, 0, 0), (0, 2, 0), m)
    scene = b.build()
    rad = _trace(scene, [[0, 0, 0]], [[0, 0, -1]], background=(1, 1, 1))
    np.testing.assert_allclose(rad[0], 0.8, rtol=1e-5)


def test_sky_gradient():
    col = np.asarray(sky_color(jnp.array([[0.0, 1.0, 0.0], [0.0, -1.0, 0.0]])))
    np.testing.assert_allclose(col[0], [0.5, 0.7, 1.0], rtol=1e-6)  # straight up
    np.testing.assert_allclose(col[1], [1.0, 1.0, 1.0], rtol=1e-6)  # straight down


def test_differentiable_path_matches_while_loop():
    b = SceneBuilder(0)
    b.add_sphere((0, 0, -5), 1.0, b.lambertian((0.6, 0.3, 0.2)))
    b.add_sphere((0, -101, 0), 100.0, b.metal((0.9, 0.9, 0.9), 0.0))
    scene = b.build()
    n = 512
    o = np.zeros((n, 3), np.float32)
    d = np.tile(np.array([[0, 0, -1.0]], np.float32), (n, 1))
    kw = dict(background=(0.7, 0.8, 1.0), max_depth=8)
    r_fast = _trace(scene, o, d, **kw)
    r_diff = _trace(scene, o, d, differentiable=True, **kw)
    # Same keys, same sequence of ops -> identical results.
    np.testing.assert_allclose(r_fast, r_diff, rtol=1e-5, atol=1e-6)


def test_hollow_glass_sphere_renders():
    """The book's hollow-glass trick: an inner sphere with negative radius
    inside a dielectric shell (hittables.go:119-120 normal flip). The scene
    must render finite, plausible radiance."""
    b = SceneBuilder(0)
    b.add_sphere((0, 0, -3), 1.0, b.dielectric(1.5))
    b.add_sphere((0, 0, -3), -0.8, b.dielectric(1.5))
    b.add_sphere((0, -101, -3), 100.0, b.lambertian((0.5, 0.5, 0.5)))
    scene = b.build()
    n = 2048
    o = np.zeros((n, 3), np.float32)
    d = np.tile(np.array([[0, 0, -1.0]], np.float32), (n, 1))
    rad = _trace(scene, o, d, background=(0.7, 0.8, 1.0), max_depth=16)
    assert np.isfinite(rad).all()
    assert 0.2 < rad.mean() < 1.2  # glass mostly transmits the sky/ground


def test_fixed_trip_count_matches_while_loop():
    """trace(fixed_trip_count=True) is the SAME estimator as the default
    while_loop — identical radiance for identical keys (dead lanes don't
    change state, so removing the early exit must not change results), with
    the default and an explicit intersector override. Guards the
    segment-count contract (one segment per live lane-bounce either way)."""
    from raytracer_tpu.geometry.intersect import intersect_scene

    b = SceneBuilder(0)
    b.add_sphere((0, -100.5, 0), 100.0, b.lambertian((0.5, 0.5, 0.5)))
    b.add_sphere((0, 0.5, 0), 0.5, b.metal((0.9, 0.8, 0.7), 0.2))
    b.add_sphere((-1.2, 0.4, 0.2), 0.4, b.dielectric(1.5))
    scene = b.build()
    rng = np.random.default_rng(5)
    n = 256
    o = jnp.asarray(rng.uniform(-2, 2, (n, 3)).astype(np.float32) + [0, 1, 3])
    d = jnp.asarray(rng.uniform(-1, 1, (n, 3)).astype(np.float32) - [0, 0.3, 1])
    key = jax.random.PRNGKey(4)
    bg = jnp.asarray((0.7, 0.8, 1.0), jnp.float32)
    for ifn in (None, intersect_scene):
        r_while, s_while = trace(
            scene, o, d, key, bg, max_depth=6, return_stats=True,
            intersect_fn=ifn,
        )
        r_fixed, s_fixed = trace(
            scene, o, d, key, bg, max_depth=6, return_stats=True,
            intersect_fn=ifn, fixed_trip_count=True,
        )
        np.testing.assert_array_equal(np.asarray(r_while), np.asarray(r_fixed))
        assert int(s_while) == int(s_fixed), (ifn, int(s_while), int(s_fixed))


def test_regen_jump_nonzero_and_exact_at_pow2_resolution():
    """When the pixel count divides the wavefront (e.g. 128x128 into 64K
    lanes), the natural jump n%n_pixels is zero, which would statically bind lanes to
    pixels (measured 2.7x iteration cost). regen_jump must pick a nonzero
    advance there, and the schedule/fold pair must stay EXACT: a miss-only
    render retires exactly spp * background per pixel."""
    from raytracer_tpu.core.camera import camera_frame, make_camera
    from raytracer_tpu.integrator.wavefront import (
        regen_jump,
        render_wavefront_regen,
        strided_schedule,
    )

    w = h = 128
    n, _, jump = strided_schedule(w * h, 8, 65536)
    assert n % (w * h) == 0  # the pathological regime this test pins
    assert jump != 0
    assert regen_jump(81920, 16384) != 0

    b = SceneBuilder(0)  # empty scene: every ray misses
    scene = b.build()
    cam, settings = make_camera(1.0, w, samples_per_pixel=8, max_depth=4,
                                background=(0.2, 0.5, 0.8))
    frame = camera_frame(cam, w, h)
    fb, segs, _ = render_wavefront_regen(
        scene, frame, cam.background, width=w, height=h, spp=8,
        wavefront_size=65536, key=jax.random.PRNGKey(0), max_depth=4,
        return_stats=True,
    )
    assert int(segs) == w * h * 8
    expect = np.tile(np.array([0.2, 0.5, 0.8], np.float32) * 8, (w * h, 1))
    np.testing.assert_allclose(np.asarray(fb), expect, rtol=1e-5, atol=1e-5)


def test_fold_log_small_wavefront_exact_counts():
    """_fold_log at 600x600 with a wavefront smaller than the pixel count
    (the regime where a miscompiled fusion of the chunk-sum with the K-way
    roll once double-counted samples): a schedule-shaped unit log must fold
    to exactly spp samples per pixel. chip_smoke.py repeats this check on
    the GPU."""
    import jax
    import jax.numpy as jnp

    from raytracer_tpu.integrator.wavefront import (
        _fold_log,
        schedule_arrays,
        strided_schedule,
    )

    n_pixels, spp, wf, w = 360000, 16, 294912, 600
    n, K, jump = strided_schedule(n_pixels, spp, wf)
    assert n < n_pixels  # the regression regime
    rem0, _, _ = schedule_arrays(n, n_pixels, spp, w)
    rem0 = np.asarray(rem0)
    log = np.zeros((3, K, n), np.float32)
    for k in range(K):
        log[:, k, :] = (rem0 > k).astype(np.float32)
    fold = jax.jit(lambda lg: _fold_log(lg, K, n, n_pixels, jump, 0, 0, False))
    fb = np.asarray(fold(jnp.asarray(log)))
    np.testing.assert_array_equal(fb, np.full((n_pixels, 3), float(spp), np.float32))


def test_trace_russian_roulette_unbiased():
    """trace(russian_roulette=True) — the round-5 opt-in used by the edge
    tracers — must keep the estimator's expectation: mean radiance over a
    large batch matches the no-RR trace on a glass-heavy scene (RR only
    reweights survivors by 1/q)."""
    from raytracer_tpu.core.camera import camera_frame, camera_rays, make_camera
    from raytracer_tpu.geometry.scene import SceneBuilder

    b = SceneBuilder(0)
    b.add_sphere((0, -100.5, -1), 100, b.lambertian((0.5, 0.5, 0.5)))
    b.add_sphere((0, 0, -1), 0.5, b.dielectric(1.5))
    b.add_sphere((1.1, 0, -1), 0.5, b.metal((0.8, 0.7, 0.6), 0.05))
    scene = b.build()
    cam, _ = make_camera(1.0, 32, look_from=(0, 0.3, 1.5), look_at=(0, 0, -1),
                         background=(0.7, 0.8, 1.0))
    w = h = 32
    n = w * h
    spp = 24
    frame = camera_frame(cam, w, h)
    pix = jnp.arange(spp * n, dtype=jnp.int32) % n
    key = jax.random.PRNGKey(2)
    uni = jax.random.uniform(key, (spp * n, 4), jnp.float32)
    o, d = camera_rays(frame, pix % w, pix // w, uni)

    means = []
    for rr in (False, True):
        rad = trace(
            scene, o, d, jax.random.fold_in(key, int(rr)), cam.background,
            max_depth=24, russian_roulette=rr, rr_start_depth=3,
            rr_max_q=0.75,
        )
        means.append(np.asarray(rad).mean(axis=0))
    np.testing.assert_allclose(means[0], means[1], atol=0.01)
