"""Closest-hit case table: the dense XLA search against the NumPy oracle
(tests/oracle.py, the reference's World.Hit scan) with the FULL hit record,
and the Pallas-Triton kernel (interpret mode on the CPU) against the XLA
search. Plus the platform decision (geometry/backend.py) and the kernel's
lowering to Triton IR for CUDA."""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from raytracer_tpu.geometry.backend import intersectors
from raytracer_tpu.geometry.intersect import (
    closest_hit_pallas,
    closest_hit_t_prim,
    intersect_scene,
    intersect_scene_pallas_diff,
)
from raytracer_tpu.geometry.scene import SceneBuilder
from oracle import OracleScene, make_fast_hit


def _aimed_rays(rng, n, lo=-8, hi=8, spread=4):
    o = rng.uniform(lo, hi, (n, 3)).astype(np.float32)
    target = rng.uniform(-spread, spread, (n, 3)).astype(np.float32)
    return o, (target - o).astype(np.float32)


def _random_prims(b, rng, n_spheres, n_quads):
    m = b.lambertian((0.5, 0.5, 0.5))
    for _ in range(n_spheres):
        b.add_sphere(rng.uniform(-5, 5, 3), rng.uniform(0.3, 1.5), m)
    for _ in range(n_quads):
        b.add_quad(
            rng.uniform(-5, 5, 3), rng.uniform(-2, 2, 3), rng.uniform(-2, 2, 3), m
        )


def case_spheres_only(rng):
    b = SceneBuilder(0)
    _random_prims(b, rng, 16, 0)
    return b.build(), *_aimed_rays(rng, 192)


def case_quads_only(rng):
    b = SceneBuilder(0)
    _random_prims(b, rng, 0, 8)
    return b.build(), *_aimed_rays(rng, 192)


def case_mixed(rng):
    b = SceneBuilder(0)
    _random_prims(b, rng, 12, 6)
    return b.build(), *_aimed_rays(rng, 192)


def case_hollow_glass(rng):
    """The book's hollow bubble: an outer sphere and a negative-radius inner
    one at the same center (normals of the inner one point inward)."""
    b = SceneBuilder(0)
    glass = b.dielectric(1.5)
    b.add_sphere((0, 0, -4), 1.0, glass)
    b.add_sphere((0, 0, -4), -0.8, glass)
    b.add_sphere((1.5, 0, -4), 0.4, b.lambertian((0.2, 0.3, 0.4)))
    o = np.zeros((128, 3), np.float32)
    d = np.concatenate(
        [rng.uniform(-0.4, 0.4, (128, 2)), -np.ones((128, 1))], 1
    ).astype(np.float32)
    return b.build(), o, d


def case_inside_sphere(rng):
    """Origins inside a sphere: the near root is behind the ray, so the far
    root wins (hittables.go:110-116)."""
    b = SceneBuilder(0)
    b.add_sphere((0, 0, 0), 3.0, b.lambertian((0.5, 0.5, 0.5)))
    o = rng.uniform(-1, 1, (128, 3)).astype(np.float32)
    d = rng.normal(size=(128, 3)).astype(np.float32)
    return b.build(), o, d


def case_t_min_self_hit(rng):
    """Rays leaving a sphere's surface: the t~0 root is inside the open
    interval's excluded band (t <= 1e-3), so outward rays escape and inward
    rays hit the far side."""
    b = SceneBuilder(0)
    b.add_sphere((0, 0, 0), 2.0, b.lambertian((0.5, 0.5, 0.5)))
    nrm = rng.normal(size=(128, 3))
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
    o = (2.0 * nrm).astype(np.float32)
    sign = np.where(np.arange(128) % 2 == 0, 1.0, -1.0)[:, None]
    d = (sign * nrm + 0.3 * rng.normal(size=(128, 3))).astype(np.float32)
    return b.build(), o, d


def case_quad_edges(rng):
    """Rays at a grid of plane coordinates just inside and just outside each
    edge of a unit-square quad (alpha/beta near 0 and 1, never on them)."""
    b = SceneBuilder(0)
    b.add_quad((-1, -1, -5), (2, 0, 0), (0, 2, 0), b.lambertian((0.5, 0.5, 0.5)))
    coords = np.array([-1.05, -0.98, -0.5, 0.0, 0.5, 0.98, 1.05], np.float32)
    xs, ys = np.meshgrid(coords, coords)
    tgt = np.stack([xs.ravel(), ys.ravel(), np.full(xs.size, -5.0)], 1)
    o = np.zeros_like(tgt, np.float32)
    return b.build(), o, tgt.astype(np.float32)


def case_parallel_to_quad(rng):
    """Rays exactly parallel to a quad's plane miss (|n.d| < 1e-8); slightly
    tilted ones hit it."""
    b = SceneBuilder(0)
    b.add_quad((-2, -2, -3), (4, 0, 0), (0, 4, 0), b.lambertian((0.5, 0.5, 0.5)))
    n = 96
    o = np.stack(
        [rng.uniform(-1, 1, n), rng.uniform(-1, 1, n), np.full(n, -3.0)], 1
    ).astype(np.float32)
    o[n // 2 :, 2] = -2.0  # second half: 1 unit in front of the plane
    d = np.stack([rng.uniform(-1, 1, n), rng.uniform(-1, 1, n), np.zeros(n)], 1)
    d[n // 2 :, 2] = -0.5
    return b.build(), o, d.astype(np.float32)


def case_overlapping(rng):
    """Interpenetrating spheres, a quad slicing a sphere, and an exact
    duplicate sphere (ties keep the first primitive in table order)."""
    b = SceneBuilder(0)
    m = b.lambertian((0.5, 0.5, 0.5))
    b.add_sphere((0, 0, -5), 1.0, m)
    b.add_sphere((0.6, 0, -5), 1.0, m)
    b.add_sphere((-1.5, 0.5, -6), 0.7, m)
    b.add_sphere((-1.5, 0.5, -6), 0.7, m)  # exact duplicate
    b.add_quad((-3, -3, -5), (6, 0, 0), (0, 6, 0), m)  # through the middle
    o = np.zeros((160, 3), np.float32)
    d = np.concatenate(
        [rng.uniform(-0.5, 0.5, (160, 2)), -np.ones((160, 1))], 1
    ).astype(np.float32)
    return b.build(), o, d


def case_dummy_rows(rng):
    """Padded tables: dummy spheres (radius 0) and dummy quads (zero normal)
    never hit and never shift primitive ids."""
    b = SceneBuilder(0)
    _random_prims(b, rng, 5, 3)
    return b.build(pad_spheres=16, pad_quads=8), *_aimed_rays(rng, 192)


def case_ragged_ray_count(rng):
    """A ray count that is not a multiple of the kernel's block: the last
    program's tail lanes are masked."""
    b = SceneBuilder(0)
    _random_prims(b, rng, 10, 4)
    return b.build(), *_aimed_rays(rng, 1000)


def case_ten_k_spheres(rng):
    """The 10K-sphere field (rand_spheres_large) seen by its own camera."""
    from raytracer_tpu.core.camera import camera_frame, camera_rays
    from raytracer_tpu.scenes.registry import get_scene

    scene, cam, settings = get_scene("rand_spheres_large", width=64, spp=1)
    assert scene.num_spheres >= 10000
    w, h = settings.width, settings.height
    pix = rng.integers(0, w * h, 160)
    o, d = camera_rays(
        camera_frame(cam, w, h), jnp.asarray(pix % w), jnp.asarray(pix // w),
        jnp.asarray(rng.uniform(size=(160, 4)).astype(np.float32)),
    )
    return scene, np.asarray(o), np.asarray(d)


CASES = {
    f.__name__[len("case_"):]: f
    for f in (
        case_spheres_only,
        case_quads_only,
        case_mixed,
        case_hollow_glass,
        case_inside_sphere,
        case_t_min_self_hit,
        case_quad_edges,
        case_parallel_to_quad,
        case_overlapping,
        case_dummy_rows,
        case_ragged_ray_count,
        case_ten_k_spheres,
    )
}


def _build(name):
    return CASES[name](np.random.default_rng(sorted(CASES).index(name) + 100))


@pytest.mark.parametrize("name", sorted(CASES))
def test_xla_matches_oracle(name):
    """Every field of the dense XLA hit record equals the oracle's."""
    scene, o, d = _build(name)
    rec = intersect_scene(scene, jnp.asarray(o), jnp.asarray(d))
    rec = {k: np.asarray(v) for k, v in rec._asdict().items()}
    oracle = OracleScene(scene)
    fast_hit = make_fast_hit(oracle)
    n_real_sph = len(oracle.spheres)
    n_hits = 0
    for i in range(o.shape[0]):
        want = fast_hit(o[i], d[i])
        if want is None:
            assert not rec["hit"][i], (i, rec["t"][i])
            continue
        t, point, normal, u, v, front, mat_id, prim = want
        # Oracle ids skip dummy rows; quads follow the PADDED sphere table.
        if prim >= n_real_sph:
            prim = scene.num_spheres + (prim - n_real_sph)
        assert rec["hit"][i], (i, t)
        assert rec["prim_id"][i] == prim, (i, rec["prim_id"][i], prim)
        np.testing.assert_allclose(rec["t"][i], t, rtol=2e-4, atol=1e-5)
        # In float32, c = |o - c|^2 - r^2 loses ~log10(|o - c|^2 / r^2)
        # digits (the oracle runs in float64); for small spheres far from
        # the ray origin (the 10K grid) the hit point's error then shows in
        # the normal and UV, so those are compared only where the sphere is
        # within 20 radii of the ray origin.
        if prim < scene.num_spheres:
            dist = np.linalg.norm(o[i] - np.asarray(scene.sph_center[prim]))
            if dist > 20 * abs(float(scene.sph_radius[prim])):
                n_hits += 1
                continue
        np.testing.assert_allclose(rec["point"][i], point, rtol=1e-3, atol=1e-4)
        np.testing.assert_allclose(rec["normal"][i], normal, rtol=1e-3, atol=2e-3)
        np.testing.assert_allclose(rec["u"][i], u, rtol=1e-3, atol=2e-3)
        np.testing.assert_allclose(rec["v"][i], v, rtol=1e-3, atol=2e-3)
        assert rec["front_face"][i] == front, i
        assert rec["mat_id"][i] == mat_id, i
        n_hits += 1
    assert n_hits > 0


@pytest.mark.parametrize("name", sorted(CASES))
def test_kernel_matches_xla(name):
    """The Pallas-Triton kernel (interpret mode) finds the same winners as
    the dense XLA search: identical hit masks and primitive ids, t within
    the kernel tolerance (scaled-t comparison, different association)."""
    scene, o, d = _build(name)
    o, d = jnp.asarray(o), jnp.asarray(d)
    t_k, p_k = map(np.asarray, closest_hit_pallas(scene, o, d, interpret=True))
    t_x, p_x = map(np.asarray, closest_hit_t_prim(scene, o, d))
    hit_k, hit_x = np.isfinite(t_k), np.isfinite(t_x)
    np.testing.assert_array_equal(hit_k, hit_x)
    np.testing.assert_array_equal(p_k[hit_k], p_x[hit_x])
    assert (p_k[~hit_k] == -1).all()
    np.testing.assert_allclose(t_k[hit_k], t_x[hit_x], rtol=1e-4, atol=1e-5)


def test_kernel_diff_wrapper_matches_dense_record():
    """intersect_scene_pallas_diff (kernel search + differentiable winner
    recompute) returns the dense path's full hit record."""
    scene, o, d = _build("mixed")
    o, d = jnp.asarray(o), jnp.asarray(d)
    got = intersect_scene_pallas_diff(scene, o, d, interpret=True)
    want = intersect_scene(scene, o, d)
    np.testing.assert_array_equal(np.asarray(got.hit), np.asarray(want.hit))
    np.testing.assert_array_equal(np.asarray(got.prim_id), np.asarray(want.prim_id))
    h = np.asarray(want.hit)
    for field in ("t", "point", "normal", "u", "v"):
        np.testing.assert_allclose(
            np.asarray(getattr(got, field))[h],
            np.asarray(getattr(want, field))[h],
            rtol=1e-4, atol=1e-5, err_msg=field,
        )


def test_kernel_rejects_custom_t_min():
    scene, o, d = _build("mixed")
    with pytest.raises(ValueError, match="t_min"):
        closest_hit_pallas(scene, jnp.asarray(o), jnp.asarray(d), t_min=1e-2)


def test_kernel_lowers_to_triton_for_cuda():
    """The kernel lowers to Triton IR for the CUDA platform on a machine
    without a GPU (compiling that IR to the card happens on the card)."""
    from raytracer_tpu.ops import closest_hit as ch

    scene, o, d = _build("mixed")
    from raytracer_tpu.geometry.intersect import quad_derived

    args = (
        ch.pack_sphere_table(scene.sph_center, scene.sph_radius),
        ch.pack_quad_table(quad_derived(scene)),
        jnp.asarray(o),
        jnp.asarray(d),
    )
    exp = jax.export.export(
        jax.jit(ch.closest_hit),
        platforms=["cuda"],
        disabled_checks=[
            jax.export.DisabledSafetyCheck.custom_call("__gpu$xla.gpu.triton")
        ],
    )(*args)
    assert "__gpu$xla.gpu.triton" in exp.mlir_module()


def test_platform_cpu_takes_dense_xla():
    got = intersectors("cpu")
    assert got.closest_hit is closest_hit_t_prim
    assert got.hit_record is intersect_scene


def test_platform_gpu_takes_kernel():
    got = intersectors("gpu")
    assert got.closest_hit is closest_hit_pallas
    assert got.hit_record is intersect_scene_pallas_diff


@pytest.mark.parametrize("platform", ["rocm", "METAL", "sycl"])
def test_platform_other_raises(platform):
    with pytest.raises(ValueError, match="no closest-hit implementation"):
        intersectors(platform)


@pytest.mark.gpu
def test_kernel_on_card_matches_xla(gpu):
    """Compiled for the card (no interpreter): kernel vs dense XLA on the
    mixed scene at a ragged ray count."""
    scene, o, d = _build("ragged_ray_count")
    o, d = jnp.asarray(o), jnp.asarray(d)
    with jax.default_matmul_precision("highest"):
        t_k, p_k = map(np.asarray, closest_hit_pallas(scene, o, d))
        t_x, p_x = map(np.asarray, closest_hit_t_prim(scene, o, d))
    hit = np.isfinite(t_k)
    np.testing.assert_array_equal(hit, np.isfinite(t_x))
    np.testing.assert_array_equal(p_k[hit], p_x[hit])
    np.testing.assert_allclose(t_k[hit], t_x[hit], rtol=1e-4, atol=1e-5)
