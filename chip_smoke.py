#!/usr/bin/env python3
"""Smoke test of the renderer on one NVIDIA GPU: the quickest proof that the
system still starts, compiles and renders correctly on the card.

    python chip_smoke.py          # one card, all phases below
    python chip_smoke.py --four   # four cards: the sharded render only

Phases, one JSON line each, all in this one process:

1. device: JAX's platform/device_kind/count, the card's name and power
   limit (nvidia-smi), the compile-cache directory;
2. kernel: the Pallas-Triton closest-hit kernel compiled for the card
   against the dense XLA search on 524,288 rays per scene (rand_spheres,
   cornell, rand_spheres_large, quad_field), plus the render step's
   compiled memory analysis;
3. timed: rand_spheres (400x225, 500 spp, depth 50) and large_10k
   (400x225, 64 spp) rendered with each intersector in turns kernel, XLA,
   XLA, kernel after a warm-up; walls, traced Mrays/s and wavefront
   iterations, and one closest-hit call of each on 524,288 rays;
4. end_to_end: the CLI in-process for rand_spheres (its image against the
   XLA-intersector image of phase 3) and one_weekend_final (1200x800 at
   100 spp to bound this script's time); every scene pinned in
   tests/golden_stats.json against those CPU statistics; the
   retirement-log fold's exact per-pixel sample count;
5. gradient: three optimizer steps of the bucketed inverse renderer with
   boundary and shadow-edge terms at 400x225, 8 spp, depth 50, and one
   bucketed gradient against the checkpointed-scan gradient.

Any failure raises: the script exits non-zero and prints no result. The
last line is {"ok": true, "device": {"platform", "kind", "count"}}; the line
before it is the card's name and power limit as nvidia-smi prints them.
Exits non-zero when JAX finds no GPU.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np

REF_WIDTH, REF_SPP, REF_DEPTH = 400, 500, 50  # main.go:228-239
KERNEL_RAYS = 524288
# The dense reference runs in ray chunks, so its (rays, primitives)
# candidate arrays would fit the card even if XLA materialised them.
REF_CHUNK = 65536
TIMING_ORDER = ("kernel", "xla", "xla", "kernel")
# Phase 2: share of rays (same winner) whose kernel t is within rtol 1e-4,
# atol 1e-5 of XLA's. Not all of them: where the root formula is
# ill-conditioned (|o-c|^2 - r^2 cancels for rays leaving the r=1000 ground
# sphere; near-tangent rays divide by a small sqrt), two correct float32
# evaluations, fused or not, differ by more. On an H100, 0.023% of rays on
# rand_spheres_large did, by at most 4.3e-4 relative (PERF.md).
T_WITHIN_RTOL_MIN = 0.9995
# Kernel vs XLA image of rand_spheres at 500 spp (phase 4; see there).
IMAGE_MEAN_ABS_MAX = 1e-4
IMAGE_U8_OVER_1_MAX = 1e-3


def _intersects():
    from raytracer_tpu.geometry.intersect import closest_hit_t_prim

    # "kernel" is the platform default (None), exactly what render_image
    # and the CLI run; "xla" forces the dense search through regen_core's
    # intersect hook.
    return {"kernel": None, "xla": closest_hit_t_prim}


def _test_module(name: str):
    """A module of this repo's tests/, loaded by file path: tests/ is not a
    package, so an installed package named `tests` would win an import."""
    import importlib.util

    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests", f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"chip_smoke_{name}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def _peak_bytes(dev) -> int:
    return int((dev.memory_stats() or {}).get("peak_bytes_in_use", -1))


def _test_rays(scene, cam, settings, n, seed):
    """n rays for the closest-hit comparison: half camera rays at random
    pixels, half diffuse bounce rays leaving the camera rays' first hits."""
    import jax
    import jax.numpy as jnp

    from raytracer_tpu.core.camera import camera_frame, camera_rays
    from raytracer_tpu.geometry.intersect import intersect_scene

    w, h = settings.width, settings.height
    k_pix, k_cam, k_dir = jax.random.split(jax.random.PRNGKey(seed), 3)
    pix = jax.random.randint(k_pix, (n,), 0, w * h)
    o, d = camera_rays(
        camera_frame(cam, w, h), pix % w, pix // w,
        jax.random.uniform(k_cam, (n, 4), jnp.float32),
    )
    half = n // 2
    rec = jax.tree_util.tree_map(
        lambda *xs: jnp.concatenate(xs),
        *(intersect_scene(scene, o[i:i + REF_CHUNK], d[i:i + REF_CHUNK])
          for i in range(half, n, REF_CHUNK)),
    )
    bounce = rec.normal + jax.random.normal(k_dir, (n - half, 3), jnp.float32)
    o2 = jnp.where(rec.hit[:, None], rec.point, o[half:])
    d2 = jnp.where(rec.hit[:, None], bounce, d[half:])
    return jnp.concatenate([o[:half], o2]), jnp.concatenate([d[:half], d2])


def phase_kernel():
    import jax

    from raytracer_tpu.geometry.intersect import closest_hit_pallas, closest_hit_t_prim
    from raytracer_tpu.render.driver import (
        DEFAULT_TARGET_RAYS_PER_PASS,
        regen_plan,
        render_regen,
    )
    from raytracer_tpu.scenes.registry import get_scene

    scenes = {}
    for name in ("rand_spheres", "cornell", "rand_spheres_large", "quad_field"):
        scene, cam, settings = get_scene(name)
        o, d = _test_rays(scene, cam, settings, KERNEL_RAYS, seed=len(scenes))
        with jax.default_matmul_precision("highest"):
            t_k, p_k = map(np.asarray, closest_hit_pallas(scene, o, d))
            t_x, p_x = map(np.concatenate, zip(*(
                map(np.asarray, closest_hit_t_prim(scene, o[i:i + REF_CHUNK], d[i:i + REF_CHUNK]))
                for i in range(0, KERNEL_RAYS, REF_CHUNK)
            )))
        hit_k, hit_x = np.isfinite(t_k), np.isfinite(t_x)
        both = hit_k & hit_x
        hit_agree = float((hit_k == hit_x).mean())
        prim_agree = float((p_k[both] == p_x[both]).mean())
        same = both & (p_k == p_x)
        err = np.abs(t_k[same] - t_x[same])
        scenes[name] = dict(
            spheres=scene.num_spheres, quads=scene.num_quads, rays=KERNEL_RAYS,
            hit_frac=float(hit_x.mean()), hit_agree=hit_agree,
            prim_agree=prim_agree,
            t_within_rtol_1e4=float(
                (err <= 1e-5 + 1e-4 * np.abs(t_x[same])).mean()
            ),
            t_max_rel_err=float((err / np.abs(t_x[same])).max()),
        )

    memory = {}
    for cell, (scene, cam, settings) in _timed_cells().items():
        n = settings.width * settings.height
        wavefront, spp_chunk = regen_plan(
            n, settings.samples_per_pixel, DEFAULT_TARGET_RAYS_PER_PASS
        )
        for name, ix in _intersects().items():
            mem = (
                render_regen.lower(
                    scene, cam, jax.random.PRNGKey(0), width=settings.width,
                    height=settings.height, spp=spp_chunk,
                    wavefront_size=wavefront, max_depth=settings.max_depth,
                    sky_gradient=settings.sky_gradient, intersect=ix,
                    return_stats=True,
                )
                .compile()
                .memory_analysis()
            )
            memory[f"{cell}/{name}"] = dict(
                wavefront=wavefront, spp_chunk=spp_chunk,
                **{
                    k: int(getattr(mem, k))
                    for k in (
                        "argument_size_in_bytes", "output_size_in_bytes",
                        "temp_size_in_bytes", "generated_code_size_in_bytes",
                    )
                    if hasattr(mem, k)
                },
            )
    emit("kernel", scenes=scenes, render_step_memory=memory)
    for name, r in scenes.items():
        assert r["hit_agree"] > 0.999, (name, r)
        assert r["prim_agree"] > 0.999, (name, r)
        assert r["t_within_rtol_1e4"] >= T_WITHIN_RTOL_MIN, (name, r)


def _timed_cells():
    from raytracer_tpu.scenes.registry import get_scene

    return {
        "rand_spheres": get_scene("rand_spheres", bucket=True),
        # bench.py's large_10k cell: the scene's own depth (8).
        "large_10k": get_scene(
            "rand_spheres_large", width=REF_WIDTH, spp=64, bucket=True
        ),
    }


def _timed_render(scene, cam, settings, intersect):
    import jax

    from raytracer_tpu.render.driver import _render_regen_image
    from raytracer_tpu.utils.metrics import RenderMetrics

    m = RenderMetrics(
        total_spp=settings.samples_per_pixel, pixels=settings.width * settings.height
    )
    t0 = time.perf_counter()
    img = _render_regen_image(
        scene, cam, settings, seed=0, metrics=m, intersect=intersect
    )
    img = jax.block_until_ready(img)
    wall = time.perf_counter() - t0
    return img, wall, m.traced_segments / wall / 1e6, m.wavefront_iters


def _median_call_s(fn, reps: int = 5) -> float:
    import jax

    jax.block_until_ready(fn())  # compile
    walls = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        walls.append(time.perf_counter() - t0)
    return float(np.median(walls))


def phase_timed(card: str):
    import jax

    from raytracer_tpu.geometry.intersect import closest_hit_pallas, closest_hit_t_prim

    intersects = _intersects()
    calls = {"kernel": jax.jit(closest_hit_pallas), "xla": jax.jit(closest_hit_t_prim)}
    out, images = {}, {}
    for cell, (scene, cam, settings) in _timed_cells().items():
        # One closest-hit call alone on 524,288 rays, each implementation.
        o, d = _test_rays(scene, cam, settings, KERNEL_RAYS, seed=7)
        call_s = {
            name: _median_call_s(lambda f=f: f(scene, o, d)) for name, f in calls.items()
        }
        for name, ix in intersects.items():  # warm-up: compiles both
            _timed_render(scene, cam, settings, ix)
        runs = {name: [] for name in intersects}
        for name in TIMING_ORDER:
            img, wall, mrays, iters = _timed_render(scene, cam, settings, intersects[name])
            runs[name].append(
                dict(wall_s=wall, traced_mrays_per_s=mrays, wavefront_iters=iters)
            )
            images[(cell, name)] = np.asarray(img)
        out[cell] = dict(
            size=[settings.width, settings.height], spp=settings.samples_per_pixel,
            max_depth=settings.max_depth, prims=scene.num_spheres + scene.num_quads,
            runs=runs,
            closest_hit_call_s=call_s,
            kernel_wall_s=float(np.mean([r["wall_s"] for r in runs["kernel"]])),
            xla_wall_s=float(np.mean([r["wall_s"] for r in runs["xla"]])),
        )
        assert np.isfinite(images[(cell, "kernel")]).all()
    emit("timed", card=card, order=list(TIMING_ORDER), cells=out)
    return images


def phase_end_to_end(images, out_dir: str):
    import jax

    from raytracer_tpu import cli
    from raytracer_tpu.imgio.image import read_ppm
    from raytracer_tpu.render.driver import render_image
    from raytracer_tpu.render.postprocess import to_u8
    from raytracer_tpu.scenes.registry import get_scene

    golden_tests = _test_module("test_golden")
    fold_test = _test_module("test_integrator").test_fold_log_small_wavefront_exact_counts

    path = os.path.join(out_dir, "rand_spheres.ppm")
    report = cli.main(["--scene", "rand_spheres", "--out", path])
    cli_u8 = read_ppm(path)
    kernel_lin = images[("rand_spheres", "kernel")]
    xla_lin = images[("rand_spheres", "xla")]
    kernel_u8 = np.asarray(jax.device_get(to_u8(kernel_lin))).astype(np.int32)
    xla_u8 = np.asarray(jax.device_get(to_u8(xla_lin))).astype(np.int32)
    u8_delta = np.abs(kernel_u8 - xla_u8).max(-1)
    vs_xla = dict(
        mean_abs_linear=float(np.abs(kernel_lin - xla_lin).mean()),
        u8_pixels_differing=float((u8_delta > 0).mean()),
        u8_pixels_differing_over_1=float((u8_delta > 1).mean()),
        u8_max_delta=int(u8_delta.max()),
    )

    ow_path = os.path.join(out_dir, "one_weekend_final.ppm")
    ow = cli.main(["--scene", "one_weekend_final", "--spp", "100", "--out", ow_path])
    ow_img = read_ppm(ow_path)

    with open(golden_tests.GOLDEN_PATH) as f:
        golden = json.load(f)
    golden_result = {}
    for name in sorted(golden):
        scene, cam, settings = get_scene(name, **golden_tests.CFG)
        img = np.asarray(render_image(scene, cam, settings, seed=golden_tests.SEED))
        try:
            golden_tests.check_stats(golden_tests._stats(img), golden[name])
            golden_result[name] = "ok"
        except AssertionError as e:  # reported below, then fails the phase
            golden_result[name] = str(e)[:300]

    fold_test()
    emit(
        "end_to_end",
        rand_spheres=dict(
            wall_s=report["wall_s"], traced_mrays_per_s=report.get("traced_mrays_per_s"),
            kernel_vs_xla=vs_xla,
        ),
        one_weekend_final=dict(
            spp=100, wall_s=ow["wall_s"], size=ow["size"],
            traced_mrays_per_s=ow.get("traced_mrays_per_s"),
        ),
        golden=golden_result,
        fold_exact_counts="ok",
    )
    # The CLI runs the same program as phase 3's kernel render, same seed.
    np.testing.assert_array_equal(cli_u8, kernel_u8)
    # Kernel and XLA renders share every random number, but their float32
    # hit distances may differ in the last bits, and a path that a last-bit
    # difference sends elsewhere stays diverged: on an H100 about 2% of
    # pixels end one u8 level apart (mean abs 3.9e-5, 0.003% of pixels more
    # than one level apart, at most 3). So the u8 bound is on pixels more
    # than one level apart. A wrong closest hit moves far more than this.
    assert vs_xla["mean_abs_linear"] < IMAGE_MEAN_ABS_MAX, vs_xla
    assert vs_xla["u8_pixels_differing_over_1"] < IMAGE_U8_OVER_1_MAX, vs_xla
    assert ow_img.shape == (ow["size"][1], ow["size"][0], 3), ow_img.shape
    assert 20 < ow_img.mean() < 235, ow_img.mean()
    assert all(v == "ok" for v in golden_result.values()), golden_result


def phase_gradient():
    import jax
    import jax.numpy as jnp

    from raytracer_tpu.core.camera import camera_frame, camera_rays
    from raytracer_tpu.diff.bucketed import _lane_uniforms, make_bucketed_grad_fn
    from raytracer_tpu.diff.grad import make_inverse_renderer, split_scene
    from raytracer_tpu.geometry.backend import intersectors
    from raytracer_tpu.integrator.wavefront import trace
    from raytracer_tpu.scenes.registry import get_scene

    w, spp, depth = REF_WIDTH, 8, REF_DEPTH
    scene, cam, settings = get_scene("rand_spheres", width=w, spp=spp)
    h = settings.height
    target = jnp.zeros((h, w, 3), jnp.float32)
    trainable = ("sph_center", "sph_radius", "tex_c0")

    params, opt_state, step = make_inverse_renderer(
        scene, cam, target, trainable=trainable, width=w, height=h,
        samples_per_pass=spp, max_depth=depth, sky_gradient=settings.sky_gradient,
        boundary=True, shadow_edges=True, backend="bucketed",
    )
    p0 = params
    losses, walls = [], []
    for i in range(3):
        t0 = time.perf_counter()
        params, opt_state, loss = jax.block_until_ready(
            step(params, opt_state, jax.random.PRNGKey(100 + i))
        )
        walls.append(time.perf_counter() - t0)
        losses.append(float(loss))
    moved = max(float(jnp.abs(params[k] - p0[k]).max()) for k in trainable)

    # One bucketed gradient against the checkpointed-scan gradient with the
    # same rays and per-lane uniforms (tests/test_grad.py::
    # test_bucketed_grads_match_full_depth_scan, at full size).
    params, rebuild = split_scene(scene, trainable)
    key = jax.random.PRNGKey(5)
    loss_b, grads_b = make_bucketed_grad_fn(
        rebuild, cam, target, width=w, height=h, samples_per_pass=spp,
        max_depth=depth, sky_gradient=settings.sky_gradient,
    )(params, key)
    n, total = w * h, w * h * spp

    def scan_loss(p):
        frame = camera_frame(cam, w, h)
        key_cam, key_u = jax.random.split(key)
        pix = jnp.arange(total, dtype=jnp.int32) % n
        o, d = camera_rays(
            frame, pix % w, pix // w,
            jax.random.uniform(key_cam, (total, 4), jnp.float32),
        )
        useq = jnp.transpose(
            _lane_uniforms(key_u, jnp.arange(total, dtype=jnp.int32), depth),
            (1, 0, 2),
        )
        radiance = trace(
            rebuild(p), o, d, jax.random.PRNGKey(0), cam.background,
            max_depth=depth, sky_gradient=settings.sky_gradient,
            differentiable=True, uniform_seq=useq,
            intersect_fn=intersectors().hit_record, intersect_fn_differentiable=True,
        )
        img = radiance.reshape(spp, n, 3).mean(0).reshape(h, w, 3)
        return jnp.mean((img - target) ** 2)

    loss_s, grads_s = jax.jit(jax.value_and_grad(scan_loss))(params)
    grads_b = {k: np.asarray(v) for k, v in grads_b.items()}
    grads_s = {k: np.asarray(v) for k, v in grads_s.items()}
    # Largest |bucketed - scan| over its allowance, per leaf (<= 1 passes).
    worst = {
        k: float(np.max(np.abs(grads_b[k] - grads_s[k])
                        / (3e-4 + 6e-3 * np.abs(grads_s[k]))))
        for k in trainable
    }
    outside = {
        k: float((np.abs(grads_b[k] - grads_s[k])
                  > 3e-4 + 6e-3 * np.abs(grads_s[k])).mean())
        for k in trainable
    }
    emit(
        "gradient", size=[w, h], spp=spp, max_depth=depth, losses=losses,
        step_walls_s=walls, params_moved_max=moved,
        bucketed_vs_scan=dict(
            loss_bucketed=float(loss_b), loss_scan=float(loss_s),
            max_err_over_tol=worst, frac_outside_tol=outside,
        ),
        peak_bytes_in_use=_peak_bytes(jax.devices()[0]),
    )
    assert np.isfinite(losses).all(), losses
    assert moved > 0, "params did not move"
    np.testing.assert_allclose(float(loss_b), float(loss_s), rtol=1e-5)
    for k in trainable:
        np.testing.assert_allclose(
            grads_b[k], grads_s[k], rtol=6e-3, atol=3e-4, err_msg=k
        )


def phase_four():
    import jax

    from raytracer_tpu.parallel.mesh import make_mesh
    from raytracer_tpu.parallel.shard import render_image_sharded
    from raytracer_tpu.render.driver import render_image
    from raytracer_tpu.scenes.registry import get_scene

    devices = jax.devices()
    assert len(devices) == 4, devices
    scene, cam, settings = get_scene("one_weekend_final", spp=100)
    mesh = make_mesh(4, sample_parallel=2)  # 2 tiles x 2 sample groups
    walls = {}

    def timed(name, fn):
        jax.block_until_ready(fn())  # warm-up (compiles)
        t0 = time.perf_counter()
        img = jax.block_until_ready(fn())
        walls[name] = time.perf_counter() - t0
        return np.asarray(img)

    img_s = timed("sharded_2x2", lambda: render_image_sharded(scene, cam, settings, mesh, seed=0))
    img_1 = timed("one_card", lambda: render_image(scene, cam, settings, seed=0))
    mean_abs = float(np.abs(img_s - img_1).mean())
    emit(
        "four", mesh=dict(mesh.shape), size=[settings.width, settings.height],
        spp=settings.samples_per_pixel, walls_s=walls,
        mean_abs_diff_vs_one_card=mean_abs,
        image_means=dict(sharded=float(img_s.mean()), one_card=float(img_1.mean())),
        peak_bytes_in_use={str(d.id): _peak_bytes(d) for d in devices},
    )
    # tests/test_sharding.py::test_sharded_regen_matches_single_device_stats
    assert np.isfinite(img_s).all()
    assert mean_abs < 0.05, mean_abs
    np.testing.assert_allclose(img_s.mean(), img_1.mean(), rtol=0.04)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the four-card sharded render")
    ap.add_argument("--out", default=os.path.join("out", "smoke"),
                    help="directory for the rendered images")
    args = ap.parse_args(argv)

    import jax

    from raytracer_tpu.utils.compile_cache import enable_compile_cache
    from raytracer_tpu.utils.device import card_name_and_power_limit, require_gpu

    device = require_gpu()
    cache = enable_compile_cache()
    card = card_name_and_power_limit()
    emit("device", **device, card=card, compile_cache=cache,
         jax_version=jax.__version__)
    os.makedirs(args.out, exist_ok=True)
    t_start = time.perf_counter()
    phase_walls = {}

    def run(name, fn, *a):
        t0 = time.perf_counter()
        result = fn(*a)
        phase_walls[name] = time.perf_counter() - t0
        return result

    if args.four:
        run("four", phase_four)
    else:
        run("kernel", phase_kernel)
        images = run("timed", phase_timed, card)
        run("end_to_end", phase_end_to_end, images, args.out)
        run("gradient", phase_gradient)
    emit("done", phase_walls_s=phase_walls, total_s=time.perf_counter() - t_start)
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": device["platform"], "kind": device["kind"], "count": device["count"],
    }}))


if __name__ == "__main__":
    main()
