"""Exact invariants of the regenerative wavefront (integrator/wavefront.py
`render_wavefront_regen`), run with each closest-hit implementation: the
dense XLA search and the Pallas-Triton kernel in interpret mode.

They hold for any random numbers:

* miss-only scene: every sample retires background radiance exactly once,
  so the folded framebuffer is exactly spp * background per pixel — this
  pins the whole regeneration / strided-queue / retirement / fold pipeline;
* emitters: a camera ray that hits a light terminates with the light's
  emission, so with spp = 1 and one lane per pixel the framebuffer equals
  the emission (or texture) at each camera ray's first hit. Those camera
  rays are re-derived here from the loop's first PRNG split.
"""

from functools import partial

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from raytracer_tpu.core.camera import camera_frame, camera_rays, make_camera
from raytracer_tpu.geometry.intersect import (
    closest_hit_pallas,
    closest_hit_t_prim,
    quad_derived,
    resolve_hits,
)
from raytracer_tpu.geometry.scene import SceneBuilder
from raytracer_tpu.integrator.wavefront import render_wavefront_regen
from raytracer_tpu.materials.textures import eval_texture, perlin_turbulence

KEY = jax.random.PRNGKey(3)
INTERSECTORS = {
    "xla": None,
    "kernel": partial(closest_hit_pallas, interpret=True),
}
pytestmark = pytest.mark.parametrize("ix", sorted(INTERSECTORS))


def _render(ix, scene, cam, settings, spp, wavefront):
    frame = camera_frame(cam, settings.width, settings.height)
    out = render_wavefront_regen(
        scene,
        frame,
        cam.background,
        width=settings.width,
        height=settings.height,
        spp=spp,
        wavefront_size=wavefront,
        key=KEY,
        max_depth=settings.max_depth,
        intersect=INTERSECTORS[ix],
        return_stats=True,
    )
    return jax.tree_util.tree_map(np.asarray, out)


def _first_hits(ix, scene, cam, w, h):
    """Hit records of the first camera rays under the render's own
    intersector (its t, to the last bit, places the emitter's texture
    lookup)."""
    o, d = _first_camera_rays(cam, w, h)
    t, prim = (INTERSECTORS[ix] or closest_hit_t_prim)(scene, o, d)
    return resolve_hits(scene, quad_derived(scene), o, d, t, prim)


def _first_camera_rays(cam, w, h):
    """The camera rays of an spp=1 render whose wavefront holds one lane
    per pixel: every lane is granted in the loop's first iteration, with
    uniforms from the second key of its first 4-way split."""
    _, k_regen, _, _ = jax.random.split(KEY, 4)
    uni = jax.random.uniform(k_regen, (w * h, 4), jnp.float32)
    pix = jnp.arange(w * h, dtype=jnp.int32)
    return camera_rays(camera_frame(cam, w, h), pix % w, pix // w, uni)


def _miss_only(bg, w, spp):
    b = SceneBuilder(0)
    b.lambertian((0.5, 0.5, 0.5))  # unused material so tables are non-empty
    cam, settings = make_camera(
        1.0, w, samples_per_pixel=spp, max_depth=8, background=bg,
        look_from=(0, 0, 2), look_at=(0, 0, 0),
    )
    return b.build(), cam, settings


def test_miss_only_exact_accounting(ix):
    """No geometry: every sample = background, retired exactly once."""
    scene, cam, settings = _miss_only((0.2, 0.4, 0.6), 16, 5)
    fb, segs, iters = _render(ix, scene, cam, settings, 5, 1024)
    n_pix = 16 * 16
    assert int(segs) == n_pix * 5  # one segment per sample
    expect = np.tile(np.array([0.2, 0.4, 0.6], np.float32) * 5, (n_pix, 1))
    np.testing.assert_allclose(fb, expect, rtol=1e-5, atol=1e-5)
    assert int(iters) > 0


def test_multi_slot_schedule(ix):
    """spp large enough that lanes own several strided samples (num_slots
    > 1) and the wavefront is smaller than the sample budget."""
    scene, cam, settings = _miss_only((1.0, 0.5, 0.25), 32, 7)
    fb, segs, _ = _render(ix, scene, cam, settings, 7, 2048)
    n_pix = 32 * 32
    assert int(segs) == n_pix * 7
    expect = np.tile(np.array([1.0, 0.5, 0.25], np.float32) * 7, (n_pix, 1))
    np.testing.assert_allclose(fb, expect, rtol=1e-5, atol=1e-4)


def test_wavefront_smaller_than_image(ix):
    """wavefront < n_pixels: with a white background and no geometry the
    framebuffer is an exact per-pixel sample counter, so any slot/pixel
    misrouting or double count shows as a pixel != spp."""
    scene, cam, settings = _miss_only((1.0, 1.0, 1.0), 48, 5)
    fb, segs, _ = _render(ix, scene, cam, settings, 5, 2048)
    n_pix = 48 * 48
    assert 2048 < n_pix
    assert int(segs) == n_pix * 5
    np.testing.assert_allclose(
        fb, np.full((n_pix, 3), 5.0, np.float32), rtol=0, atol=1e-5
    )


def test_emitter_exact(ix):
    """A huge emissive sphere around the camera: every ray hits, emits,
    terminates. Framebuffer == spp * emit exactly."""
    b = SceneBuilder(0)
    b.add_sphere((0, 0, 0), 100.0, b.diffuse_light((3.0, 2.0, 1.0)))
    scene = b.build()
    cam, settings = make_camera(
        1.0, 8, samples_per_pixel=3, max_depth=8, background=(9, 9, 9),
        look_from=(0, 0, 0), look_at=(0, 0, -1),
    )
    fb, segs, _ = _render(ix, scene, cam, settings, 3, 1024)
    assert int(segs) == 64 * 3
    expect = np.tile(np.array([3.0, 2.0, 1.0], np.float32) * 3, (64, 1))
    np.testing.assert_allclose(fb, expect, rtol=1e-5, atol=1e-5)


def test_matches_intersection_oracle(ix):
    """Random emitter spheres and quads: a one-sample render equals
    emitted-where-hit + background-where-miss for the dense intersector's
    verdict on the same camera rays (sphere AND quad hits, front faces)."""
    rng = np.random.default_rng(7)
    b = SceneBuilder(0)
    light = b.diffuse_light((1.0, 0.5, 0.25))
    for _ in range(12):
        b.add_sphere(rng.uniform(-4, 4, 3), rng.uniform(0.4, 1.2), light)
    for _ in range(5):
        b.add_quad(
            rng.uniform(-4, 4, 3), rng.uniform(-2, 2, 3), rng.uniform(-2, 2, 3), light
        )
    scene = b.build()
    w = 16
    cam, settings = make_camera(
        1.0, w, samples_per_pixel=1, max_depth=4, background=(0.1, 0.2, 0.3),
        look_from=(0, 0, 10), look_at=(0, 0, 0), fov_degrees=45,
    )
    fb, _, _ = _render(ix, scene, cam, settings, 1, 1024)
    hit = np.asarray(_first_hits(ix, scene, cam, w, w).hit)
    assert 0.1 < hit.mean() < 0.9
    expect = np.where(
        hit[:, None],
        np.array([1.0, 0.5, 0.25], np.float32),
        np.array([0.1, 0.2, 0.3], np.float32),
    )
    np.testing.assert_allclose(fb, expect, rtol=1e-4, atol=1e-5)


def test_noise_emitter_exact(ix):
    """A huge NOISE-textured emitter around the camera: each camera ray
    terminates with radiance = marble(hit point)."""
    b = SceneBuilder(0)
    # Radius 10, not 100: the marble's slope times a float32 hit point's
    # last-bit error must stay under the tolerance (the fused loop may
    # round the point differently from the eager reference).
    b.add_sphere((0, 0, 0), 10.0, b.diffuse_light(b.noise(0.7)))
    scene = b.build()
    assert scene.has_noise
    w = 16
    cam, settings = make_camera(
        1.0, w, samples_per_pixel=1, max_depth=4, background=(9, 9, 9),
        look_from=(0, 0, 0), look_at=(0, 0, -1),
    )
    fb, segs, _ = _render(ix, scene, cam, settings, 1, 1024)
    assert int(segs) == w * w
    sp = _first_hits(ix, scene, cam, w, w).point * 0.7
    val = np.asarray(
        0.5 * (1.0 + jnp.sin(sp[:, 2] + 10.0 * perlin_turbulence(scene, sp, 7)))
    )
    np.testing.assert_allclose(fb, np.tile(val[:, None], (1, 3)), rtol=2e-4, atol=2e-5)


def _image_emitter_fb(ix, scene, look_at, w=16, fov=None):
    kw = {} if fov is None else dict(fov_degrees=fov)
    cam, settings = make_camera(
        1.0, w, samples_per_pixel=1, max_depth=4, background=(9, 9, 9),
        look_from=(0, 0, 0), look_at=look_at, **kw,
    )
    fb, segs, _ = _render(ix, scene, cam, settings, 1, 1024)
    return fb, int(segs), _first_hits(ix, scene, cam, w, w)


def _texture_at(scene, tex_ids, ref):
    return np.asarray(
        eval_texture(scene, jnp.asarray(tex_ids, jnp.int32), ref.u, ref.v, ref.point)
    )


def test_image_emitter_exact(ix):
    """A huge IMAGE-textured emitter around the camera: radiance =
    texture(UV of hit point) through the packed-table image path."""
    rng = np.random.default_rng(5)
    img = rng.uniform(0.0, 1.0, (16, 48, 3)).astype(np.float32)
    b = SceneBuilder(0)
    tex = b.image(img)
    b.add_sphere((0, 0, 0), 100.0, b.diffuse_light(tex))
    scene = b.build()
    fb, segs, ref = _image_emitter_fb(ix, scene, (0.3, -0.2, -1))
    assert segs == 16 * 16
    want = _texture_at(scene, np.full((256,), tex), ref)
    np.testing.assert_allclose(fb, want, rtol=2e-5, atol=2e-5)


def test_image_on_quad_and_multi_image_exact(ix):
    """An image texture on a QUAD plus a second, differently sized image on
    a sphere, both emitters: quad UVs and per-image dims/padding."""
    rng = np.random.default_rng(9)
    img_a = rng.uniform(0.0, 1.0, (12, 20, 3)).astype(np.float32)
    img_b = rng.uniform(0.0, 1.0, (24, 10, 3)).astype(np.float32)
    b = SceneBuilder(0)
    tex_a = b.image(img_a)
    tex_b = b.image(img_b)
    # Quad fills the left of the frame, sphere the right; camera at origin.
    b.add_quad((-4.0, -2.0, -3.0), (3.5, 0, 0), (0, 4, 0), b.diffuse_light(tex_a))
    b.add_sphere((2.0, 0.0, -3.0), 1.4, b.diffuse_light(tex_b))
    scene = b.build()
    assert scene.images.shape[0] == 2
    fb, _, ref = _image_emitter_fb(ix, scene, (0, 0, -1), fov=90)
    prim = np.asarray(ref.prim_id)
    hit = np.asarray(ref.hit)
    want = _texture_at(scene, np.where(prim == 1, tex_a, tex_b), ref)  # sphere=0
    want = np.where(hit[:, None], want, [9.0, 9.0, 9.0])
    assert (hit & (prim >= 1)).sum() > 10 and (hit & (prim == 0)).sum() > 10
    np.testing.assert_allclose(fb, want, rtol=2e-5, atol=2e-5)


def _bilinear_scene(img, img2):
    b = SceneBuilder(0)
    tex = b.image(img)
    tex2 = b.image(img2)
    b.add_sphere((0, 0, 0), 100.0, b.diffuse_light(tex))
    # A quad in front of the camera: some pixels resolve the quad UV path.
    b.add_quad((-0.8, -0.8, -2.0), (1.6, 0, 0), (0, 1.6, 0), b.diffuse_light(tex2))
    return b.build(bilinear_textures=True), tex, tex2


def test_image_bilinear_exact(ix):
    """Deterministic 4-tap bilinear image fetch on a sphere AND a quad,
    against the XLA bilinear texture path."""
    rng = np.random.default_rng(9)
    scene, tex, tex2 = _bilinear_scene(
        rng.uniform(0.0, 1.0, (16, 48, 3)).astype(np.float32),
        rng.uniform(0.0, 1.0, (11, 13, 3)).astype(np.float32),
    )
    assert scene.bilinear_textures
    fb, segs, ref = _image_emitter_fb(ix, scene, (0.1, -0.1, -1))
    assert segs == 256
    on_quad = np.asarray(ref.prim_id) >= scene.num_spheres
    assert 0.1 < on_quad.mean() < 0.9  # both UV paths exercised
    want = _texture_at(scene, np.where(on_quad, tex2, tex), ref)
    np.testing.assert_allclose(fb, want, rtol=2e-5, atol=2e-5)


def test_image_bilinear_wide_exact(ix):
    """Wide images (padded width >= 256) under the bilinear filter, on a
    sphere AND a quad."""
    rng = np.random.default_rng(13)
    scene, tex, tex2 = _bilinear_scene(
        rng.uniform(0.0, 1.0, (12, 320, 3)).astype(np.float32),
        rng.uniform(0.0, 1.0, (9, 260, 3)).astype(np.float32),
    )
    assert scene.images.shape[2] >= 256
    fb, segs, ref = _image_emitter_fb(ix, scene, (0.1, -0.1, -1))
    assert segs == 256
    on_quad = np.asarray(ref.prim_id) >= scene.num_spheres
    assert 0.1 < on_quad.mean() < 0.9
    want = _texture_at(scene, np.where(on_quad, tex2, tex), ref)
    # At 320-texel widths the UV -> texel map amplifies last-bit rounding
    # of the hit point into the blend weights (far below one texel step).
    np.testing.assert_allclose(fb, want, rtol=1e-4, atol=1e-4)
