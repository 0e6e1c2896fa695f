"""Material scatter/emission semantics vs the reference (materials.go)."""

import numpy as np
import jax
import jax.numpy as jnp

from raytracer_tpu.geometry.intersect import intersect_scene
from raytracer_tpu.geometry.scene import SceneBuilder
from raytracer_tpu.materials.materials import UNIFORMS_PER_BOUNCE, shade
import oracle


def _hit_sphere(builder_setup, origin, direction, n=1):
    b = SceneBuilder(0)
    builder_setup(b)
    scene = b.build()
    o = jnp.tile(jnp.asarray(origin, jnp.float32)[None], (n, 1))
    d = jnp.tile(jnp.asarray(direction, jnp.float32)[None], (n, 1))
    hit = intersect_scene(scene, o, d)
    assert bool(np.asarray(hit.hit).all())
    return scene, hit, d


def _uniforms(n, seed=0):
    return jax.random.uniform(
        jax.random.PRNGKey(seed), (n, UNIFORMS_PER_BOUNCE), jnp.float32
    )


def test_lambertian_scatter_distribution():
    n = 20_000
    scene, hit, d = _hit_sphere(
        lambda b: b.add_sphere((0, 0, -3), 1.0, b.lambertian((0.8, 0.4, 0.2))),
        (0, 0, 0),
        (0, 0, -1),
        n,
    )
    res = shade(scene, hit, d, _uniforms(n))
    assert bool(np.asarray(res.scattered).all())
    np.testing.assert_allclose(np.asarray(res.attenuation[0]), [0.8, 0.4, 0.2], rtol=1e-6)
    np.testing.assert_allclose(np.asarray(res.emitted), 0.0, atol=1e-7)
    # dir = normal + unit_sphere sample: mean over samples = normal (here +z).
    dirs = np.asarray(res.direction)
    np.testing.assert_allclose(dirs.mean(0), [0, 0, 1], atol=0.02)
    # |dir - normal| == 1 exactly (sample lies on the unit sphere).
    np.testing.assert_allclose(
        np.linalg.norm(dirs - np.array([0, 0, 1.0]), axis=-1), 1.0, atol=1e-5
    )


def test_metal_perfect_mirror():
    scene, hit, d = _hit_sphere(
        lambda b: b.add_sphere((0, 0, -3), 1.0, b.metal((0.7, 0.6, 0.5), 0.0)),
        (0, -1, 0),
        (0, 0.5, -2),  # oblique incoming
        4,
    )
    res = shade(scene, hit, d, _uniforms(4))
    # fuzz=0: exact mirror of the *unit* incoming dir (materials.go:60-67).
    unit_d = np.asarray(d[0]) / np.linalg.norm(np.asarray(d[0]))
    want = oracle.reflect(unit_d, np.asarray(hit.normal[0]))
    np.testing.assert_allclose(np.asarray(res.direction[0]), want, rtol=1e-5, atol=1e-6)
    assert bool(np.asarray(res.scattered).all())
    np.testing.assert_allclose(np.asarray(res.attenuation[0]), [0.7, 0.6, 0.5], rtol=1e-6)


def test_metal_absorbs_below_horizon():
    """High fuzz can push the scattered ray below the surface -> absorbed
    (materials.go:68-74)."""
    n = 4000
    scene, hit, d = _hit_sphere(
        lambda b: b.add_sphere((0, 0, -3), 1.0, b.metal((1, 1, 1), 0.9)),
        (0, 0, 0),
        (0, 0.35, -1),
        n,
    )
    res = shade(scene, hit, d, _uniforms(n))
    scattered = np.asarray(res.scattered)
    dirs = np.asarray(res.direction)
    normals = np.asarray(hit.normal)
    dots = np.sum(dirs * normals, -1)
    assert ((dots > 0) == scattered).all()
    assert 0.0 < scattered.mean() < 1.0  # some absorbed, some not


def test_dielectric_tir_and_refraction():
    n = 5000
    # Front-face hit on glass: eta = 1/1.5, moderate angle -> mix of
    # reflect (Schlick coin) and refract.
    scene, hit, d = _hit_sphere(
        lambda b: b.add_sphere((0, 0, -3), 1.0, b.dielectric(1.5)),
        (0, 0, 0),
        (0, 0.3, -1),
        n,
    )
    res = shade(scene, hit, d, _uniforms(n))
    assert bool(np.asarray(res.scattered).all())
    np.testing.assert_allclose(np.asarray(res.attenuation), 1.0, atol=1e-7)
    unit_d = np.asarray(d[0]) / np.linalg.norm(np.asarray(d[0]))
    nrm = np.asarray(hit.normal[0])
    cos = min(float(-unit_d @ nrm), 1.0)
    want_reflect = oracle.reflect(unit_d, nrm)
    want_refract = oracle.refract(unit_d, nrm, 1 / 1.5)
    dirs = np.asarray(res.direction)
    is_refl = np.linalg.norm(dirs - want_reflect, axis=-1) < 1e-4
    is_refr = np.linalg.norm(dirs - want_refract, axis=-1) < 1e-4
    assert (is_refl | is_refr).all()
    # Reflect fraction ~ Schlick reflectance (materials.go:103).
    np.testing.assert_allclose(
        is_refl.mean(), oracle.schlick(cos, 1 / 1.5), atol=0.02
    )


def test_dielectric_total_internal_reflection():
    # Back-face exit at a grazing angle: sin(theta) * eta > 1 -> always reflect.
    n = 64
    scene, hit, d = _hit_sphere(
        lambda b: b.add_sphere((0, 0, 0), 1.0, b.dielectric(1.5)),
        (0.95, 0, 0),  # inside the sphere, near the surface
        (0, 1, 0),  # chord ray -> grazing exit angle
        n,
    )
    assert not bool(np.asarray(hit.front_face).any())
    res = shade(scene, hit, d, _uniforms(n))
    unit_d = np.asarray(d[0]) / np.linalg.norm(np.asarray(d[0]))
    nrm = np.asarray(hit.normal[0])
    sin_theta = float(np.sqrt(1 - min(float(-unit_d @ nrm), 1.0) ** 2))
    assert sin_theta * 1.5 > 1.0  # setup really is TIR
    want = oracle.reflect(unit_d, nrm)
    np.testing.assert_allclose(
        np.asarray(res.direction), np.tile(want, (n, 1)), rtol=1e-4, atol=1e-5
    )


def test_diffuse_light_emits_and_terminates():
    scene, hit, d = _hit_sphere(
        lambda b: b.add_sphere((0, 0, -3), 1.0, b.diffuse_light((4, 4, 4))),
        (0, 0, 0),
        (0, 0, -1),
        8,
    )
    res = shade(scene, hit, d, _uniforms(8))
    assert not bool(np.asarray(res.scattered).any())
    np.testing.assert_allclose(np.asarray(res.emitted), 4.0, rtol=1e-6)
