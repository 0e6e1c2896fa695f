"""Closest-hit intersection vs the NumPy oracle (hittables.go + the World.Hit
shrinking scan). Random scenes, random rays — t/normal/uv/mat must agree."""

import numpy as np
import jax.numpy as jnp

from raytracer_tpu.geometry.intersect import intersect_scene
from raytracer_tpu.geometry.scene import SceneBuilder
from oracle import closest_hit


def _random_scene(rng, n_spheres=12, n_quads=6):
    b = SceneBuilder(0)
    mat = b.lambertian((0.5, 0.5, 0.5))
    spheres, quads = [], []
    for _ in range(n_spheres):
        c = rng.uniform(-5, 5, 3)
        r = rng.uniform(0.3, 1.5)
        b.add_sphere(c, r, mat)
        spheres.append((c, r, mat))
    for _ in range(n_quads):
        q = rng.uniform(-5, 5, 3)
        u = rng.uniform(-2, 2, 3)
        v = rng.uniform(-2, 2, 3)
        b.add_quad(q, u, v, mat)
        quads.append((q, u, v, mat))
    return b.build(), spheres, quads


def _ray_is_stable(origin, direction, spheres, quads, rel=1e-3):
    """True if the closest-hit decision for this ray is robust to f32 vs f64
    rounding: no near-tangent sphere, no near-parallel/near-edge quad, and no
    two candidate hits with nearly equal t. Only stable rays are asserted
    bit-close; unstable ones are legitimately undecidable across precisions."""
    o = origin.astype(np.float64)
    d = direction.astype(np.float64)
    ts = []
    for c, r, _ in spheres:
        oc = o - np.asarray(c, np.float64)
        a = d @ d
        half_b = d @ oc
        cc = oc @ oc - r * r
        disc = half_b * half_b - a * cc
        scale = half_b * half_b + abs(a * cc) + 1e-30
        if abs(disc) / scale < 1e-4:
            return False  # near-tangent
        if disc > 0:
            for t in ((-half_b - np.sqrt(disc)) / a, (-half_b + np.sqrt(disc)) / a):
                if t > 1e-3:
                    ts.append(t)
    for q, uv, vv, _ in quads:
        nrm = np.cross(np.asarray(uv, np.float64), np.asarray(vv, np.float64))
        nlen = np.linalg.norm(nrm)
        denom = d @ (nrm / nlen)
        if abs(denom) / np.linalg.norm(d) < 1e-4:
            return False  # near-parallel
        t = ((nrm / nlen) @ (np.asarray(q) - o)) / denom
        if t > 1e-3:
            w = nrm / (nrm @ nrm)
            p = o + t * d - np.asarray(q, np.float64)
            alpha = w @ np.cross(p, vv)
            beta = w @ np.cross(uv, p)
            if min(abs(alpha), abs(alpha - 1), abs(beta), abs(beta - 1)) < rel:
                return False  # near-edge
            if 0 <= alpha <= 1 and 0 <= beta <= 1:
                ts.append(t)
    ts.sort()
    # Only the winner vs runner-up ordering affects the result.
    if len(ts) >= 2 and (ts[1] - ts[0]) / max(ts[0], 1e-6) < rel:
        return False
    return True


def test_matches_oracle_random_scene(rng):
    scene, spheres, quads = _random_scene(rng)
    n = 256
    origin = rng.uniform(-8, 8, (n, 3)).astype(np.float32)
    # Aim at random points inside the scene volume so most rays hit something.
    target = rng.uniform(-4, 4, (n, 3)).astype(np.float32)
    direction = (target - origin).astype(np.float32)

    rec = intersect_scene(scene, jnp.asarray(origin), jnp.asarray(direction))
    rec = {k: np.asarray(v) for k, v in rec._asdict().items()}

    n_checked_hits = 0
    n_stable = 0
    for i in range(n):
        if not _ray_is_stable(origin[i], direction[i], spheres, quads):
            continue
        n_stable += 1
        want = closest_hit(origin[i], direction[i], spheres, quads)
        if want is None:
            assert not rec["hit"][i], f"ray {i}: false hit t={rec['t'][i]}"
            continue
        t, point, normal, u, v, front, mat_id, prim = want
        assert rec["hit"][i], f"ray {i}: missed, oracle t={t}"
        np.testing.assert_allclose(rec["t"][i], t, rtol=2e-4, atol=1e-5)
        np.testing.assert_allclose(rec["point"][i], point, rtol=1e-3, atol=1e-4)
        np.testing.assert_allclose(rec["normal"][i], normal, rtol=1e-3, atol=2e-3)
        np.testing.assert_allclose(rec["u"][i], u, rtol=1e-3, atol=2e-3)
        np.testing.assert_allclose(rec["v"][i], v, rtol=1e-3, atol=2e-3)
        assert rec["front_face"][i] == front
        assert rec["mat_id"][i] == mat_id
        assert rec["prim_id"][i] == prim
        n_checked_hits += 1
    assert n_stable > 150  # most rays must be stable
    assert n_checked_hits > 50  # scene dense enough to be a meaningful test


def test_sphere_from_inside_picks_far_root():
    """Root selection (hittables.go:110-116): from inside a sphere the near
    root is negative, the far root must be chosen, normal flipped."""
    b = SceneBuilder(0)
    m = b.lambertian((1, 1, 1))
    b.add_sphere((0, 0, 0), 2.0, m)
    scene = b.build()
    rec = intersect_scene(
        scene, jnp.array([[0.0, 0.0, 0.0]]), jnp.array([[1.0, 0.0, 0.0]])
    )
    assert bool(rec.hit[0])
    np.testing.assert_allclose(float(rec.t[0]), 2.0, rtol=1e-6)
    assert not bool(rec.front_face[0])
    np.testing.assert_allclose(np.asarray(rec.normal[0]), [-1, 0, 0], atol=1e-6)


def test_negative_radius_flips_normal():
    """Hollow-glass trick (hittables.go:119-120): negative radius flips the
    outward normal, so a ray from outside sees back_face."""
    b = SceneBuilder(0)
    m = b.dielectric(1.5)
    b.add_sphere((0, 0, 0), -2.0, m)
    scene = b.build()
    rec = intersect_scene(
        scene, jnp.array([[5.0, 0.0, 0.0]]), jnp.array([[-1.0, 0.0, 0.0]])
    )
    assert bool(rec.hit[0])
    np.testing.assert_allclose(float(rec.t[0]), 3.0, rtol=1e-6)
    assert not bool(rec.front_face[0])  # outward normal points inward


def test_t_min_excludes_self_intersection():
    b = SceneBuilder(0)
    m = b.lambertian((1, 1, 1))
    b.add_sphere((0, 0, -5), 1.0, m)
    scene = b.build()
    # Origin on the surface, pointing away: no hit (t=0 excluded, far side behind).
    rec = intersect_scene(
        scene, jnp.array([[0.0, 0.0, -4.0]]), jnp.array([[0.0, 0.0, 1.0]])
    )
    assert not bool(rec.hit[0])
    # Pointing into the sphere: hits the far side at t=2 (t=0 excluded by t_min).
    rec = intersect_scene(
        scene, jnp.array([[0.0, 0.0, -4.0]]), jnp.array([[0.0, 0.0, -1.0]])
    )
    assert bool(rec.hit[0])
    np.testing.assert_allclose(float(rec.t[0]), 2.0, rtol=1e-5)


def test_quad_bounds_and_parallel_rays():
    b = SceneBuilder(0)
    m = b.lambertian((1, 1, 1))
    b.add_quad((0, 0, 0), (1, 0, 0), (0, 1, 0), m)  # unit quad in z=0 plane
    scene = b.build()
    o = jnp.array(
        [
            [0.5, 0.5, 1.0],  # inside -> hit
            [1.5, 0.5, 1.0],  # alpha > 1 -> miss
            [0.5, -0.1, 1.0],  # beta < 0 -> miss
            [0.5, 0.5, 1.0],  # parallel ray -> miss
        ]
    )
    d = jnp.array(
        [[0.0, 0.0, -1.0], [0.0, 0.0, -1.0], [0.0, 0.0, -1.0], [1.0, 0.0, 0.0]]
    )
    rec = intersect_scene(scene, o, d)
    assert list(np.asarray(rec.hit)) == [True, False, False, False]
    np.testing.assert_allclose(float(rec.t[0]), 1.0, rtol=1e-6)
    np.testing.assert_allclose(np.asarray(rec.u[0]), 0.5, atol=1e-6)
    np.testing.assert_allclose(np.asarray(rec.v[0]), 0.5, atol=1e-6)
    assert bool(rec.front_face[0])


def test_closest_of_overlapping():
    b = SceneBuilder(0)
    m = b.lambertian((1, 1, 1))
    b.add_sphere((0, 0, -3), 1.0, m)
    b.add_sphere((0, 0, -6), 1.0, m)
    b.add_quad((-1, -1, -4.5), (2, 0, 0), (0, 2, 0), m)
    scene = b.build()
    rec = intersect_scene(
        scene, jnp.array([[0.0, 0.0, 0.0]]), jnp.array([[0.0, 0.0, -1.0]])
    )
    np.testing.assert_allclose(float(rec.t[0]), 2.0, rtol=1e-6)
    assert int(rec.prim_id[0]) == 0


def test_pallas_diff_intersector_value_and_grad_parity():
    """intersect_scene_pallas_diff == intersect_scene in value AND in
    gradient (w.r.t. sphere center/radius and ray origin/direction): the
    kernel runs on stop-gradient inputs, the winner's t is recomputed
    differentiably, so d(sum t)/d(params) must match the dense path's."""
    import jax

    from raytracer_tpu.geometry.intersect import (
        intersect_scene,
        intersect_scene_pallas_diff,
    )
    from raytracer_tpu.geometry.scene import SceneBuilder

    rng = np.random.default_rng(21)
    b = SceneBuilder(0)
    m = b.lambertian((0.5, 0.5, 0.5))
    for _ in range(9):
        b.add_sphere(rng.uniform(-4, 4, 3), rng.uniform(0.5, 1.3), m)
    b.add_quad((-6, -2, -6), (12, 0, 0), (0, 0, 12), m)
    scene = b.build()
    n = 256
    o = jnp.asarray(rng.uniform(-6, 6, (n, 3)).astype(np.float32))
    d = jnp.asarray(rng.uniform(-3, 3, (n, 3)).astype(np.float32)) - o * 0.3

    def loss(fn, center, radius, o_, d_):
        sc = scene.replace(sph_center=center, sph_radius=radius)
        rec = fn(sc, o_, d_)
        t = jnp.where(rec.hit, rec.t, 0.0)
        return jnp.sum(t * t), rec

    def kernel_fn(sc, o_, d_):
        return intersect_scene_pallas_diff(sc, o_, d_, interpret=True)

    (v_p, rec_p), g_p = jax.value_and_grad(
        lambda *a: loss(kernel_fn, *a),
        argnums=(0, 1, 2, 3),
        has_aux=True,
    )(scene.sph_center, scene.sph_radius, o, d)
    (v_d, rec_d), g_d = jax.value_and_grad(
        lambda *a: loss(intersect_scene, *a), argnums=(0, 1, 2, 3), has_aux=True
    )(scene.sph_center, scene.sph_radius, o, d)

    np.testing.assert_array_equal(np.asarray(rec_p.hit), np.asarray(rec_d.hit))
    np.testing.assert_array_equal(
        np.asarray(rec_p.prim_id), np.asarray(rec_d.prim_id)
    )
    np.testing.assert_allclose(float(v_p), float(v_d), rtol=1e-5)
    for gp, gd, name in zip(g_p, g_d, ("center", "radius", "origin", "dir")):
        np.testing.assert_allclose(
            np.asarray(gp), np.asarray(gd), rtol=2e-4, atol=2e-5, err_msg=name
        )
