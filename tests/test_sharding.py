"""Multi-device sharding on the 8-virtual-CPU-device mesh (SURVEY.md §4.5)."""

import numpy as np
import jax
import pytest

from raytracer_tpu.core.camera import make_camera
from raytracer_tpu.geometry.scene import SceneBuilder
from raytracer_tpu.parallel.mesh import make_mesh, SAMPLE_AXIS, TILE_AXIS
from raytracer_tpu.parallel.shard import render_image_sharded, sharded_samples_per_pass
from raytracer_tpu.render.driver import render_image


def _tiny():
    b = SceneBuilder(0)
    b.add_sphere((0, 0, -3), 1.0, b.lambertian((0.5, 0.5, 0.5)))
    b.add_sphere((0, -101, -3), 100.0, b.metal((0.8, 0.8, 0.8), 0.1))
    b.add_quad((-0.5, 1.5, -3), (1, 0, 0), (0, 0, -1), b.diffuse_light((3, 3, 3)))
    cam, settings = make_camera(
        16 / 9, 40, samples_per_pixel=8, max_depth=5, background=(0.7, 0.8, 1.0)
    )
    return b.build(), cam, settings


def test_mesh_shapes():
    assert len(jax.devices()) == 8, "conftest must provide 8 virtual devices"
    mesh = make_mesh(8, sample_parallel=2)
    assert mesh.shape[TILE_AXIS] == 4 and mesh.shape[SAMPLE_AXIS] == 2
    with pytest.raises(ValueError):
        make_mesh(8, sample_parallel=3)


def test_sharded_samples_per_pass():
    mesh = make_mesh(8, sample_parallel=4)
    k = sharded_samples_per_pass(16, 1000, mesh, 1 << 20)
    assert k % 4 == 0 and 16 % k == 0


@pytest.mark.parametrize("sample_parallel", [1, 2, 8])
def test_sharded_render_statistically_matches_single(sample_parallel):
    """The sharded render uses different per-device key folds, so images agree
    statistically (same estimator, same spp), not bitwise."""
    scene, cam, settings = _tiny()
    mesh = make_mesh(8, sample_parallel=sample_parallel)
    img_s = np.asarray(render_image_sharded(scene, cam, settings, mesh, seed=0))
    img_1 = np.asarray(render_image(scene, cam, settings, seed=0))
    assert img_s.shape == img_1.shape
    assert np.isfinite(img_s).all()
    # 8 spp Monte Carlo: loose but meaningful agreement on the mean image.
    assert np.abs(img_s - img_1).mean() < 0.08
    np.testing.assert_allclose(img_s.mean(), img_1.mean(), rtol=0.05)


def test_sharded_render_deterministic():
    scene, cam, settings = _tiny()
    mesh = make_mesh(4, sample_parallel=2)
    a = np.asarray(render_image_sharded(scene, cam, settings, mesh, seed=1))
    b = np.asarray(render_image_sharded(scene, cam, settings, mesh, seed=1))
    np.testing.assert_array_equal(a, b)


def test_sharded_regen_exact_accounting_uneven_spp():
    """Miss-only scene through the sharded FAST path: every sample retires
    the background exactly once, so the framebuffer is exactly spp * bg even
    when spp does not divide the device count (budget split must sum to spp,
    no sample dropped or double-counted across devices)."""
    import jax.numpy as jnp

    from raytracer_tpu.parallel.shard import render_regen_sharded

    b = SceneBuilder(0)
    b.lambertian((0.5, 0.5, 0.5))  # non-empty tables
    scene = b.build()
    cam, settings = make_camera(
        1.0, 16, samples_per_pixel=13, max_depth=6, background=(0.2, 0.4, 0.6),
        look_from=(0, 0, 2), look_at=(0, 0, 0),
    )
    mesh = make_mesh(8, sample_parallel=2)
    spp = 13  # 13 % 8 != 0: five devices get 2 samples, three get 1
    fb, segs, iters_max, iters_sum = render_regen_sharded(
        scene,
        cam,
        jax.random.PRNGKey(0),
        mesh=mesh,
        width=16,
        height=16,
        spp=spp,
        wavefront_per_device=1024,
        max_depth=6,
        sky_gradient=False,
        return_stats=True,
    )
    n_pix = 16 * 16
    assert int(segs) == n_pix * spp  # every camera ray misses: 1 segment each
    assert int(iters_max) <= int(iters_sum)
    expect = np.tile(np.array([0.2, 0.4, 0.6], np.float32) * spp, (n_pix, 1))
    np.testing.assert_allclose(
        np.asarray(fb).reshape(n_pix, 3), expect, rtol=1e-5, atol=1e-4
    )


def test_sharded_regen_matches_single_device_stats():
    """The sharded fast path (8 devices) and the single-device regen produce
    statistically matching images on a real scene (same estimator)."""
    from raytracer_tpu.render.driver import render_regen

    scene, cam, settings = _tiny()
    mesh = make_mesh(8, sample_parallel=4)
    w, h = settings.width, settings.height
    spp = 32
    img_s = np.asarray(
        render_image_sharded(
            scene, cam, settings._replace(samples_per_pixel=spp), mesh, seed=0
        )
    )
    img_1 = np.asarray(
        render_regen(
            scene,
            cam,
            jax.random.PRNGKey(0),
            spp=spp,
            width=w,
            height=h,
            wavefront_size=1 << 14,
            max_depth=settings.max_depth,
            sky_gradient=False,
        )
    )
    assert np.isfinite(img_s).all()
    assert np.abs(img_s - img_1).mean() < 0.05
    np.testing.assert_allclose(img_s.mean(), img_1.mean(), rtol=0.04)


def test_sharded_regen_load_balance_proxy():
    """Per-device iteration counts are the scaling-efficiency proxy: with the
    spp budget split evenly, max and mean per-device iters should be close
    (here: within 2x — CPU mesh, tiny image, so the tail is relatively fat)."""
    from raytracer_tpu.parallel.shard import render_regen_sharded

    scene, cam, settings = _tiny()
    mesh = make_mesh(8, sample_parallel=1)
    fb, segs, iters_max, iters_sum = render_regen_sharded(
        scene,
        cam,
        jax.random.PRNGKey(3),
        mesh=mesh,
        width=settings.width,
        height=settings.height,
        spp=64,
        wavefront_per_device=1 << 12,
        max_depth=settings.max_depth,
        sky_gradient=False,
        return_stats=True,
    )
    mean_iters = int(iters_sum) / 8
    assert int(iters_max) < 2.0 * mean_iters, (int(iters_max), mean_iters)


def test_graft_dryrun_multichip():
    import __graft_entry__

    __graft_entry__.dryrun_multichip(8)


def test_graft_entry_compiles():
    import __graft_entry__

    fn, args = __graft_entry__.entry()
    out = jax.jit(fn)(*args)
    assert np.isfinite(np.asarray(out)).all()


def test_sharded_samples_per_pass_uneven_spp_raises():
    """spp not divisible by the sample axis has NO valid pass size for the
    pass-based sharded render; the helper must refuse clearly instead of
    returning a k that crashes mid-trace (sixth-review finding)."""
    mesh = make_mesh(8, sample_parallel=4)
    with pytest.raises(ValueError, match="multiple of the sample-axis"):
        sharded_samples_per_pass(10, 1000, mesh, 1 << 20)
    # The regen path (default) handles the same spp fine.
    scene, cam, settings = _tiny()
    settings = settings._replace(samples_per_pixel=10)
    img = np.asarray(render_image_sharded(scene, cam, settings, mesh, seed=0))
    assert np.isfinite(img).all()


def test_make_mesh_too_many_devices_raises():
    with pytest.raises(ValueError, match="only 8 available"):
        make_mesh(16)


def test_sharded_metrics_and_progress(capsys):
    """--shard observability: metrics get segment/iteration totals and the
    progress stream prints per chunk (sixth-review finding)."""
    from raytracer_tpu.utils.metrics import RenderMetrics

    scene, cam, settings = _tiny()
    mesh = make_mesh(4, sample_parallel=2)
    m = RenderMetrics(
        total_spp=settings.samples_per_pixel,
        pixels=settings.width * settings.height,
    )
    img = np.asarray(
        render_image_sharded(
            scene, cam, settings, mesh, seed=0, progress=True, metrics=m
        )
    )
    assert np.isfinite(img).all()
    assert m.done_spp == settings.samples_per_pixel
    assert m.traced_segments > 0
    assert m.wavefront_iters > 0
    snap = m.snapshot()
    assert "traced_mrays_per_s" in snap and "occupancy" in snap
    assert "spp" in capsys.readouterr().out


def test_sharded_checkpoint_resume_bit_identical(tmp_path):
    """A killed sharded render resumes bit-identically on the 8-device mesh
    (round-3 VERDICT item 4: sharding and checkpointing unified).

    spp is chosen to need multiple chunks; the first run stops after one
    chunk (max_chunks=1 — the cooperative-preemption analog of a kill), the
    second resumes from the checkpoint, and the result must equal an
    uninterrupted render bit-for-bit (chunk keys are (seed, chunk)-derived,
    device keys mesh-position-derived)."""
    import raytracer_tpu.render.driver as drv

    scene, cam, settings = _tiny()
    settings = settings._replace(samples_per_pixel=8)
    mesh = make_mesh(8, sample_parallel=2)

    # Force multi-chunk: pin the chunk size to 2 spp (4 chunks of 8).
    orig = drv.regen_spp_chunk
    drv.regen_spp_chunk = lambda *a, **k: 2
    try:
        full = np.asarray(
            render_image_sharded(scene, cam, settings, mesh, seed=3)
        )
        ck = str(tmp_path / "shard.npz")
        partial_img = render_image_sharded(
            scene, cam, settings, mesh, seed=3,
            checkpoint_path=ck, max_chunks=1,
        )
        assert np.isfinite(np.asarray(partial_img)).all()
        from raytracer_tpu.render.checkpoint import load_checkpoint

        saved = load_checkpoint(ck)
        assert saved is not None and 0 < saved.done_spp < 8  # genuinely partial
        resumed = np.asarray(
            render_image_sharded(
                scene, cam, settings, mesh, seed=3, checkpoint_path=ck
            )
        )

        # Config drift refuses: different spp -> different fingerprint.
        bad = settings._replace(samples_per_pixel=16)
        with pytest.raises(ValueError, match="refusing to resume"):
            render_image_sharded(
                scene, cam, bad, mesh, seed=3, checkpoint_path=ck
            )
    finally:
        drv.regen_spp_chunk = orig
