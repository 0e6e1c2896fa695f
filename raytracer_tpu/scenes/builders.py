"""The six reference scenes, reproduced with fixed seeds.

Reference: main.go:80-289. The reference seeds scene generation from
wall-clock (main.go:246-252), so its random-sphere scene differs run to run;
here every scene is a pure function of an integer seed (SURVEY.md §4,
"the rebuild must use fixed seeds").

Each builder returns (Scene, Camera, RenderSettings).
"""

from __future__ import annotations

import numpy as np

from raytracer_tpu.core.camera import make_camera
from raytracer_tpu.geometry.scene import SceneBuilder
from raytracer_tpu.imgio.image import load_jpeg, synthetic_earth_texture

SKY_BLUE = (0.7, 0.8, 1.0)


def rand_spheres(
    seed: int = 0,
    *,
    width: int = 400,
    spp: int = 500,
    max_depth: int = 50,
    aspect: float = 16.0 / 9.0,
    bucket: bool = False,
):
    """~500-sphere random scene (main.go:227-289): checkered ground, 22×22
    grid of random lambertian/metal/glass spheres, three hero spheres,
    thin-lens camera with 0.6° defocus."""
    cam, settings = make_camera(
        aspect,
        width,
        samples_per_pixel=spp,
        max_depth=max_depth,
        look_from=(13, 2, 3),
        look_at=(0, 0, 0),
        fov_degrees=20,
        defocus_angle_degrees=0.6,
        focus_dist=10,
        background=SKY_BLUE,
    )
    b = SceneBuilder(seed)
    rng = np.random.default_rng(seed)

    checker = b.checker(0.32, (0.2, 0.3, 0.1), (0.9, 0.9, 0.9))
    ground = b.lambertian(checker)
    b.add_sphere((0, -1000, 0), 1000, ground)

    hero = np.array([4.0, 0.2, 0.0])
    for i in range(-11, 11):
        for j in range(-11, 11):
            mat_per = rng.random()
            center = np.array(
                [i + 0.9 * rng.random(), 0.2, j + 0.9 * rng.random()], np.float32
            )
            if np.linalg.norm(center - hero) <= 0.9:  # main.go:256-258
                continue
            if mat_per < 0.8:
                albedo = rng.random(3) * rng.random(3)  # main.go:260-263
                mat = b.lambertian(tuple(albedo))
            elif mat_per < 0.95:
                albedo = rng.uniform(0.5, 1.0, 3)  # main.go:265-268
                fuzz = rng.uniform(0.0, 0.5)
                mat = b.metal(tuple(albedo), fuzz)
            else:
                mat = b.dielectric(1.5)  # main.go:270
            b.add_sphere(tuple(center), 0.2, mat)

    b.add_sphere((0, 1, 0), 1, b.dielectric(1.5))  # main.go:278-279
    b.add_sphere((-4, 1, 0), 1, b.lambertian((0.4, 0.2, 0.1)))  # main.go:281-282
    b.add_sphere((4, 1, 0), 1, b.metal((0.7, 0.6, 0.5), 0.0))  # main.go:284-285
    return b.build(bucket_shapes=bucket), cam, settings


def earth(
    seed: int = 0,
    *,
    width: int = 400,
    spp: int = 100,
    max_depth: int = 50,
    texture_path: str | None = None,
    bilinear: bool = False,
    bucket: bool = False,
    tex_height: int = 256,
    tex_width: int = 512,
):
    """Image-textured globe (main.go:80-104). The reference's earthmap.jpg is
    a missing blob in this mount, so by default a deterministic synthetic
    earth-like texture stands in; pass `texture_path` to use a real JPEG.
    tex_height/tex_width size the synthetic stand-in — (512, 1024) matches
    the real earthmap.jpg's resolution."""
    cam, settings = make_camera(
        16.0 / 9.0,
        width,
        samples_per_pixel=spp,
        max_depth=max_depth,
        look_from=(0, 0, 12),
        look_at=(0, 0, 0),
        fov_degrees=20,
        background=SKY_BLUE,
    )
    b = SceneBuilder(seed)
    img = (
        load_jpeg(texture_path)
        if texture_path
        else synthetic_earth_texture(tex_height, tex_width)
    )
    tex = b.image(img)
    b.add_sphere((0, 0, 0), 2, b.lambertian(tex))
    return b.build(bilinear_textures=bilinear, bucket_shapes=bucket), cam, settings


def perlin_demo(
    seed: int = 0, *, width: int = 400, spp: int = 100, max_depth: int = 50,
    bucket: bool = False,
):
    """Marble-noise spheres (main.go:106-130)."""
    cam, settings = make_camera(
        16.0 / 9.0,
        width,
        samples_per_pixel=spp,
        max_depth=max_depth,
        look_from=(13, 2, 3),
        look_at=(0, 0, 0),
        fov_degrees=20,
        background=SKY_BLUE,
    )
    b = SceneBuilder(seed)
    noise = b.noise(4)
    mat = b.lambertian(noise)
    b.add_sphere((0, -1000, 0), 1000, mat)
    b.add_sphere((0, 2, 0), 2, mat)
    return b.build(bucket_shapes=bucket), cam, settings


def quad_demo(
    seed: int = 0, *, width: int = 400, spp: int = 100, max_depth: int = 50,
    bucket: bool = False,
):
    """Five colored quads (main.go:132-160)."""
    cam, settings = make_camera(
        16.0 / 9.0,
        width,
        samples_per_pixel=spp,
        max_depth=max_depth,
        look_from=(0, 0, 9),
        look_at=(0, 0, 0),
        fov_degrees=80,
        background=SKY_BLUE,
    )
    b = SceneBuilder(seed)
    left_red = b.lambertian((1, 0.2, 0.2))
    back_green = b.lambertian((0.2, 1, 0.2))
    right_blue = b.lambertian((0.2, 0.2, 1))
    upper_orange = b.lambertian((1, 0.5, 0))
    lower_teal = b.lambertian((0.2, 0.8, 0.8))
    b.add_quad((-3, -2, 5), (0, 0, -4), (0, 4, 0), left_red)
    b.add_quad((-2, -2, 0), (4, 0, 0), (0, 4, 0), back_green)
    b.add_quad((3, -2, 1), (0, 0, 4), (0, 4, 0), right_blue)
    b.add_quad((-2, 3, 1), (4, 0, 0), (0, 0, 4), upper_orange)
    b.add_quad((-2, -3, 5), (4, 0, 0), (0, 0, -4), lower_teal)
    return b.build(bucket_shapes=bucket), cam, settings


def simple_light(
    seed: int = 0, *, width: int = 400, spp: int = 500, max_depth: int = 50,
    bucket: bool = False,
):
    """Emissive sphere over marble ground, black background (main.go:162-192)."""
    cam, settings = make_camera(
        16.0 / 9.0,
        width,
        samples_per_pixel=spp,
        max_depth=max_depth,
        look_from=(26, 3, 6),
        look_at=(0, 2, 0),
        fov_degrees=20,
        background=(0, 0, 0),
    )
    b = SceneBuilder(seed)
    noise = b.noise(4)
    marble = b.lambertian(noise)
    b.add_sphere((0, -1000, 0), 1000, marble)
    b.add_sphere((0, 2, 0), 2, marble)
    b.add_sphere((-4, 2, 4), 2, b.lambertian((1, 0, 0)))
    b.add_sphere((0, 7, 0), 2, b.diffuse_light((4, 4, 4)))
    return b.build(bucket_shapes=bucket), cam, settings


def cornell_box(
    seed: int = 0, *, width: int = 600, spp: int = 200, max_depth: int = 50,
    bucket: bool = False,
):
    """Standard Cornell box with two axis-aligned boxes (main.go:194-225)."""
    cam, settings = make_camera(
        1.0,
        width,
        samples_per_pixel=spp,
        max_depth=max_depth,
        look_from=(278, 278, -800),
        look_at=(278, 278, 0),
        fov_degrees=40,
        background=(0, 0, 0),
    )
    b = SceneBuilder(seed)
    red = b.lambertian((0.65, 0.05, 0.05))
    white = b.lambertian((0.73, 0.73, 0.73))
    green = b.lambertian((0.12, 0.45, 0.15))
    light = b.diffuse_light((15, 15, 15))

    b.add_quad((555, 0, 0), (0, 555, 0), (0, 0, 555), green)
    b.add_quad((0, 0, 0), (0, 555, 0), (0, 0, 555), red)
    b.add_quad((343, 554, 332), (-130, 0, 0), (0, 0, -105), light)
    b.add_quad((0, 0, 0), (555, 0, 0), (0, 0, 555), white)
    b.add_quad((555, 555, 555), (-555, 0, 0), (0, 0, -555), white)
    b.add_quad((0, 0, 555), (555, 0, 0), (0, 555, 0), white)
    b.add_box((130, 0, 65), (295, 165, 230), white)
    b.add_box((265, 0, 295), (430, 330, 460), white)
    return b.build(bucket_shapes=bucket), cam, settings


def one_weekend_final(
    seed: int = 0, *, width: int = 1200, spp: int = 500, max_depth: int = 50,
    bucket: bool = False,
):
    """Book-canonical random-sphere config (1200×800 @ 500 spp, 3:2 aspect,
    gradient sky) from BASELINE.md — same geometry as rand_spheres but the
    classic lerp sky instead of the reference's flat background color."""
    scene, cam, settings = rand_spheres(
        seed, width=width, spp=spp, max_depth=max_depth, aspect=1.5, bucket=bucket
    )
    return scene, cam, settings._replace(sky_gradient=True)


def quad_field(
    seed: int = 0,
    *,
    width: int = 400,
    spp: int = 32,
    max_depth: int = 8,
    n_spheres: int = 8000,  # named for CLI/bench symmetry; counts QUADS here
    aspect: float = 16.0 / 9.0,
    bucket: bool = False,
):
    """Large field of small tilted quads (default 8K) — the quad analog of
    rand_spheres_large (the reference BVH accepts any Hittable including
    quads via their padded AABBs, bvh.go:132-141, hittables.go:161). Not a
    reference scene."""
    n_quads = n_spheres
    cam, settings = make_camera(
        aspect,
        width,
        samples_per_pixel=spp,
        max_depth=max_depth,
        look_from=(13, 6, 3),
        look_at=(0, 0, 0),
        fov_degrees=40,
        background=SKY_BLUE,
    )
    settings = settings._replace(sky_gradient=True)
    b = SceneBuilder(seed)
    rng = np.random.default_rng(seed + 2)
    b.add_quad((-1000, 0, -1000), (2000, 0, 0), (0, 0, 2000),
               b.lambertian((0.5, 0.5, 0.5)))
    side = int(np.ceil(np.sqrt(n_quads)))
    added = 0
    for i in range(side):
        for j in range(side):
            if added == n_quads:
                break
            q = np.array(
                [
                    i - side / 2 + 0.9 * rng.random(),
                    0.05 + 0.5 * rng.random(),
                    j - side / 2 + 0.9 * rng.random(),
                ],
                np.float64,
            )
            # Small tilted quad: random in-plane basis of ~0.4 units.
            u = rng.normal(size=3)
            u /= np.linalg.norm(u)
            v = rng.normal(size=3)
            v -= u * (u @ v)
            v /= np.linalg.norm(v)
            b.add_quad(
                tuple(q), tuple(0.4 * u), tuple(0.4 * v),
                b.lambertian(tuple(rng.random(3) * rng.random(3))),
            )
            added += 1
    return b.build(bucket_shapes=bucket), cam, settings


def rand_spheres_large(
    seed: int = 0,
    *,
    width: int = 400,
    spp: int = 32,
    max_depth: int = 8,
    n_spheres: int = 10000,
    aspect: float = 16.0 / 9.0,
    bucket: bool = False,
):
    """Scaled-up random-sphere field (n_spheres on a grid, default 10K) —
    the scale workload the reference's BVH acceleration exists for
    (bvh.go:220-249). Not a reference scene; defaults are sized for a
    practical render, override with --spp/--max-depth."""
    cam, settings = make_camera(
        aspect,
        width,
        samples_per_pixel=spp,
        max_depth=max_depth,
        look_from=(13, 6, 3),
        look_at=(0, 0, 0),
        fov_degrees=40,
        background=SKY_BLUE,
    )
    settings = settings._replace(sky_gradient=True)
    b = SceneBuilder(seed)
    rng = np.random.default_rng(seed + 1)
    b.add_sphere((0, -1000, 0), 1000, b.lambertian((0.5, 0.5, 0.5)))
    # Exactly n_spheres grid spheres (int(sqrt) silently under-delivered by
    # up to ~2*side for non-square counts).
    side = int(np.ceil(np.sqrt(n_spheres)))
    added = 0
    for i in range(side):
        for j in range(side):
            if added == n_spheres:
                break
            c = (
                i - side / 2 + 0.9 * rng.random(),
                0.2,
                j - side / 2 + 0.9 * rng.random(),
            )
            b.add_sphere(c, 0.2, b.lambertian(tuple(rng.random(3) * rng.random(3))))
            added += 1
    return b.build(bucket_shapes=bucket), cam, settings
