"""Texture evaluation vs reference semantics (materials.go:121-295)."""

import numpy as np
import jax.numpy as jnp

from raytracer_tpu.geometry.scene import SceneBuilder
from raytracer_tpu.materials.textures import (
    eval_texture,
    perlin_noise,
    perlin_turbulence,
)
import oracle


def test_solid_color():
    b = SceneBuilder(0)
    t = b.solid_color(0.3, 0.6, 0.9)
    b.lambertian(t)
    scene = b.build()
    col = eval_texture(
        scene,
        jnp.full((4,), t, jnp.int32),
        jnp.zeros(4),
        jnp.zeros(4),
        jnp.zeros((4, 3)),
    )
    np.testing.assert_allclose(np.asarray(col), [[0.3, 0.6, 0.9]] * 4, rtol=1e-6)


def test_checker_parity(rng):
    b = SceneBuilder(0)
    scale = 0.32
    t = b.checker(scale, (0.2, 0.3, 0.1), (0.9, 0.9, 0.9))
    b.lambertian(t)
    scene = b.build()
    pts = rng.uniform(-10, 10, (256, 3)).astype(np.float32)
    col = np.asarray(
        eval_texture(
            scene,
            jnp.full((256,), t, jnp.int32),
            jnp.zeros(256),
            jnp.zeros(256),
            jnp.asarray(pts),
        )
    )
    inv = 1.0 / scale
    for p, c in zip(pts, col):
        # materials.go:127-137: Go's int() truncates toward zero, but for the
        # checker the reference floors first (math.Floor), so parity uses floor.
        parity = int(sum(np.floor(inv * p).astype(np.int64))) % 2
        want = (0.2, 0.3, 0.1) if parity == 0 else (0.9, 0.9, 0.9)
        np.testing.assert_allclose(c, want, rtol=1e-6)


def test_image_texture_nearest():
    img = np.zeros((2, 4, 3), np.float32)
    img[0, 0] = (1, 0, 0)
    img[0, 3] = (0, 1, 0)
    img[1, 0] = (0, 0, 1)
    b = SceneBuilder(0)
    t = b.image(img)
    b.lambertian(t)
    scene = b.build()

    def lookup(u, v):
        return np.asarray(
            eval_texture(
                scene,
                jnp.array([t], jnp.int32),
                jnp.array([u], jnp.float32),
                jnp.array([v], jnp.float32),
                jnp.zeros((1, 3)),
            )
        )[0]

    # v is flipped (materials.go:181-182): v=1 -> row 0.
    np.testing.assert_allclose(lookup(0.0, 1.0), (1, 0, 0))
    np.testing.assert_allclose(lookup(0.9, 0.9), (0, 1, 0))
    np.testing.assert_allclose(lookup(0.1, 0.1), (0, 0, 1))
    # u out of range clamps (materials.go:181).
    np.testing.assert_allclose(lookup(-0.5, 1.0), (1, 0, 0))


def test_perlin_noise_matches_oracle(rng):
    b = SceneBuilder(7)
    t = b.noise(4)
    b.lambertian(t)
    scene = b.build()
    vec = np.asarray(scene.perlin_vec)
    px = np.asarray(scene.perlin_px)
    py = np.asarray(scene.perlin_py)
    pz = np.asarray(scene.perlin_pz)
    pts = rng.uniform(-20, 20, (64, 3)).astype(np.float32)
    got = np.asarray(perlin_noise(scene, jnp.asarray(pts)))
    for p, g in zip(pts, got):
        want = oracle.perlin_noise(vec, px, py, pz, p)
        np.testing.assert_allclose(g, want, rtol=1e-3, atol=1e-4)


def test_perlin_turb_matches_oracle(rng):
    b = SceneBuilder(3)
    t = b.noise(4)
    b.lambertian(t)
    scene = b.build()
    vec = np.asarray(scene.perlin_vec)
    px, py, pz = (
        np.asarray(scene.perlin_px),
        np.asarray(scene.perlin_py),
        np.asarray(scene.perlin_pz),
    )
    pts = rng.uniform(-5, 5, (16, 3)).astype(np.float32)
    got = np.asarray(perlin_turbulence(scene, jnp.asarray(pts)))
    assert (got >= 0).all()
    for p, g in zip(pts, got):
        want = oracle.perlin_turb(vec, px, py, pz, p)
        np.testing.assert_allclose(g, want, rtol=1e-2, atol=1e-3)


def test_perlin_procedural_matches_gather_bitexact(rng):
    """The hash-recomputed (gather-free) noise path must equal the
    table-gather path BIT-EXACTLY: the tables are built by the same hash
    functions (materials/perlin_hash.py), so the only difference is
    lookup-vs-recompute. This also pins NumPy/XLA integer-hash agreement."""
    b = SceneBuilder(5)
    t = b.noise(4)
    b.lambertian(t)
    scene = b.build()  # procedural_perlin=True default
    assert scene.perlin_procedural
    scene_gather = scene.replace(perlin_procedural=False)
    pts = jnp.asarray(rng.uniform(-30, 30, (4096, 3)).astype(np.float32))
    got_fast = np.asarray(perlin_noise(scene, pts))
    got_table = np.asarray(perlin_noise(scene_gather, pts))
    np.testing.assert_array_equal(got_fast, got_table)
    turb_fast = np.asarray(perlin_turbulence(scene, pts))
    turb_table = np.asarray(perlin_turbulence(scene_gather, pts))
    np.testing.assert_array_equal(turb_fast, turb_table)


def test_perlin_hash_tables_well_distributed():
    """Hash-built tables keep the reference construction's invariants
    (materials.go:202-216): each axis table is a true permutation of 0..255,
    gradient components lie in [-1,1) and are not degenerate."""
    from raytracer_tpu.materials.perlin_hash import build_tables

    vec, px, py, pz = build_tables()
    for perm in (px, py, pz):
        assert sorted(perm.tolist()) == list(range(256))
    assert not np.array_equal(px, py) and not np.array_equal(py, pz)
    assert (vec >= -1).all() and (vec < 1).all()
    assert abs(vec.mean()) < 0.1
    assert vec.std() > 0.4  # ~uniform[-1,1) std is 0.577
    # XOR-combined index actually spreads over the whole table.
    ids = set()
    for x in range(16):
        for y in range(16):
            for z in range(4):
                ids.add(int(px[x] ^ py[y] ^ pz[z]))
    assert len(ids) > 200


def test_marble_value_range(rng):
    """NoiseTexture value = 0.5*(1+sin(...)) in [0,1] (materials.go:285-288)."""
    b = SceneBuilder(0)
    t = b.noise(4)
    b.lambertian(t)
    scene = b.build()
    pts = rng.uniform(-3, 3, (128, 3)).astype(np.float32)
    col = np.asarray(
        eval_texture(
            scene,
            jnp.full((128,), t, jnp.int32),
            jnp.zeros(128),
            jnp.zeros(128),
            jnp.asarray(pts),
        )
    )
    assert (col >= 0).all() and (col <= 1).all()
    assert col.std() > 0.05  # actually varies
    np.testing.assert_allclose(col[:, 0], col[:, 1])  # gray


def test_multiple_images_padded_stack():
    """Two image textures of different sizes share a padded stack; lookups
    must respect each image's true dims (scene.image_dims)."""
    img_a = np.zeros((2, 2, 3), np.float32)
    img_a[0, 0] = (1, 0, 0)
    img_a[1, 1] = (0, 1, 0)
    img_b = np.zeros((4, 8, 3), np.float32)
    img_b[3, 7] = (0, 0, 1)
    b = SceneBuilder(0)
    ta = b.image(img_a)
    tb = b.image(img_b)
    b.lambertian(ta)
    b.lambertian(tb)
    scene = b.build()
    assert scene.images.shape == (2, 4, 8, 3)  # padded to max dims

    def lookup(t, u, v):
        return np.asarray(
            eval_texture(
                scene,
                jnp.array([t], jnp.int32),
                jnp.array([u], jnp.float32),
                jnp.array([v], jnp.float32),
                jnp.zeros((1, 3)),
            )
        )[0]

    np.testing.assert_allclose(lookup(ta, 0.1, 0.9), (1, 0, 0))  # a[0,0]
    np.testing.assert_allclose(lookup(ta, 0.9, 0.1), (0, 1, 0))  # a[1,1]
    np.testing.assert_allclose(lookup(tb, 0.99, 0.01), (0, 0, 1))  # b[3,7]
    np.testing.assert_allclose(lookup(tb, 0.1, 0.9), (0, 0, 0))


def test_bilinear_image_lookup():
    """Bilinear filtering (scene flag) interpolates between texels."""
    img = np.zeros((2, 2, 3), np.float32)
    img[0, 0] = (1, 1, 1)
    b = SceneBuilder(0)
    t = b.image(img)
    b.lambertian(t)
    scene = b.build(bilinear_textures=True)
    # Sample at the center of the texture: average of 4 texels = 0.25.
    col = np.asarray(
        eval_texture(
            scene,
            jnp.array([t], jnp.int32),
            jnp.array([0.5], jnp.float32),
            jnp.array([0.5], jnp.float32),
            jnp.zeros((1, 3)),
        )
    )[0]
    np.testing.assert_allclose(col, (0.25, 0.25, 0.25), atol=1e-6)
