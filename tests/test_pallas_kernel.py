"""Pallas-Triton closest-hit kernel vs the jnp dense reference (oracle test,
SURVEY.md §4.2). Runs in interpreter mode on CPU."""

import numpy as np
import jax.numpy as jnp
import pytest

from raytracer_tpu.geometry.intersect import intersect_scene, quad_derived
from raytracer_tpu.geometry.scene import SceneBuilder
from raytracer_tpu.ops import closest_hit as ch


def _scene(rng):
    b = SceneBuilder(0)
    m = b.lambertian((0.5, 0.5, 0.5))
    for _ in range(20):
        b.add_sphere(rng.uniform(-5, 5, 3), rng.uniform(0.3, 1.5), m)
    for _ in range(6):
        b.add_quad(rng.uniform(-5, 5, 3), rng.uniform(-2, 2, 3), rng.uniform(-2, 2, 3), m)
    return b.build()


@pytest.mark.parametrize(
    "n",
    [
        ch.BLOCK // 2 + 77,  # one program, mostly masked
        2 * ch.BLOCK,  # whole blocks, no tail
        8 * 128 + 77,  # several blocks plus a masked tail
    ],
)
def test_kernel_matches_dense(rng, n):
    scene = _scene(rng)
    sph_t = ch.pack_sphere_table(scene.sph_center, scene.sph_radius)
    quad_t = ch.pack_quad_table(quad_derived(scene))
    o = jnp.asarray(rng.uniform(-8, 8, (n, 3)).astype(np.float32))
    target = jnp.asarray(rng.uniform(-4, 4, (n, 3)).astype(np.float32))
    d = target - o

    t_k, p_k = ch.closest_hit(sph_t, quad_t, o, d, interpret=True)
    ref = intersect_scene(scene, o, d)

    t_k = np.asarray(t_k)
    p_k = np.asarray(p_k)
    hit_r = np.asarray(ref.hit)
    assert ((np.isfinite(t_k)) == hit_r).mean() > 0.999
    both = np.isfinite(t_k) & hit_r
    assert both.sum() > n // 5
    np.testing.assert_allclose(
        t_k[both], np.asarray(ref.t)[both], rtol=1e-4, atol=1e-5
    )
    agree = (p_k[both] == np.asarray(ref.prim_id)[both]).mean()
    assert agree > 0.999, agree

