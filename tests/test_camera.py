"""Camera ray-gen vs the NumPy oracle port of camera.go:128-178, 265-299."""

import numpy as np
import jax.numpy as jnp

from raytracer_tpu.core.camera import camera_frame, camera_rays, make_camera
from oracle import OracleCamera


def _compare(aspect, width, **kw):
    cam, settings = make_camera(aspect, width, **kw)
    ocam = OracleCamera(
        aspect,
        width,
        fov_degrees=kw.get("fov_degrees", 90.0),
        look_from=kw.get("look_from", (0, 0, -1)),
        look_at=kw.get("look_at", (0, 0, 0)),
        defocus_angle_degrees=kw.get("defocus_angle_degrees", 0.0),
        focus_dist=kw.get("focus_dist", 10.0),
    )
    frame = camera_frame(cam, settings.width, settings.height)
    np.testing.assert_allclose(frame.pixel00, ocam.pixel00, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(frame.pixel_du, ocam.pixel_du, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(frame.pixel_dv, ocam.pixel_dv, rtol=1e-5, atol=1e-6)

    # Center rays (jitter 0 => uniforms [0.5, 0.5]; disk sample (0,0) => u=0).
    px = jnp.arange(settings.width, dtype=jnp.int32)
    py = jnp.full_like(px, 7)
    uni = jnp.tile(jnp.array([[0.5, 0.5, 0.0, 0.0]], jnp.float32), (px.shape[0], 1))
    o, d = camera_rays(frame, px, py, uni)
    for i in (0, settings.width // 2, settings.width - 1):
        oo, od = ocam.ray(i, 7)
        np.testing.assert_allclose(o[i], oo, rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(d[i], od, rtol=1e-4, atol=1e-5)


def test_default_camera():
    _compare(16.0 / 9.0, 64)


def test_reference_scene_cameras():
    # rand_spheres camera (main.go:228-239).
    _compare(
        16.0 / 9.0,
        400,
        fov_degrees=20,
        look_from=(13, 2, 3),
        look_at=(0, 0, 0),
        focus_dist=10,
    )
    # cornell camera (main.go:195-204).
    _compare(
        1.0,
        600,
        fov_degrees=40,
        look_from=(278, 278, -800),
        look_at=(278, 278, 0),
    )


def test_defocus_disk_origin():
    kw = dict(
        fov_degrees=20,
        look_from=(13, 2, 3),
        look_at=(0, 0, 0),
        defocus_angle_degrees=0.6,
        focus_dist=10,
    )
    cam, settings = make_camera(16 / 9, 400, **kw)
    frame = camera_frame(cam, settings.width, settings.height)
    ocam = OracleCamera(16 / 9, 400, **kw)
    # Disk sample at angle 0, radius r: closed-form map u=(r^2, 0) -> (r, 0).
    r = 0.5
    uni = jnp.array([[0.5, 0.5, r * r, 0.0]], jnp.float32)
    o, d = camera_rays(frame, jnp.array([10]), jnp.array([20]), uni)
    oo, od = ocam.ray(10, 20, disk_xy=(r, 0.0))
    np.testing.assert_allclose(o[0], oo, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(d[0], od, rtol=1e-4, atol=1e-5)


def test_image_height_truncation():
    _, s = make_camera(16 / 9, 400)
    assert (s.width, s.height) == (400, 225)
    _, s = make_camera(1.0, 600)
    assert (s.width, s.height) == (600, 600)
    _, s = make_camera(16 / 9, 10)  # 10 / (16/9) = 5.625 -> 5
    assert s.height == 5
    _, s = make_camera(100.0, 10)  # would be < 1 -> clamp to 1 (camera.go:138-140)
    assert s.height == 1


def test_non_dividing_aspect_matches_reference_float_height():
    """The reference sizes the viewport/pixel pitch from the FLOAT image
    height floor(W)/aspect while rendering int(height) rows
    (camera.go:137-153). aspect=3, W=100 -> 33 rows at a 33.33-row pitch:
    ~1% ray-direction error if the int height is used for the pitch (the
    pre-fix behavior). The oracle keeps the float height, so this pins the
    parity."""
    _compare(3.0, 100, fov_degrees=45, look_from=(1, 2, 3), look_at=(0, 0, -1))
    _compare(2.4, 97)
