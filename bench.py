"""Headline benchmark: traced Mrays/s on the 500-sphere random scene, on
one NVIDIA GPU.

Prints ONE JSON line: {"metric": ..., "value": N, "unit": ..., "vs_baseline": N,
"detail": {...}} with the device (platform, device_kind, count) and the
card's name and power limit in `detail`. Exits non-zero, printing no
result, when JAX finds no GPU; a cell that fails fails the run.

The headline workload is the reference's own randSpheres config — 400x225 at
500 spp, depth 50 (/root/reference/main.go:228-239, BASELINE.md) — rendered by
the production fast path (the regenerative wavefront, render/driver.py). The
value is the traced-segment rate (camera rays + bounce continuations
actually shaded), the standard path-tracing throughput metric.
`detail.low_spp` reports the same scene at 64 spp.

Baseline (BASELINE.md): the reference publishes 8m54s for the book's
random-sphere render — ~0.9M *camera* rays/s lower bound. vs_baseline is our
camera-ray rate over that 0.9 Mrays/s.

Env knobs: RT_BENCH_SPP (default 500), RT_BENCH_WIDTH (default 400),
RT_BENCH_REPEATS (default 3; median reported).
"""

from __future__ import annotations

import json
import os
import statistics
import time

import jax
import jax.numpy as jnp


def _measure(scene, cam, settings, *, spp, repeats):
    """Median traced/camera rates over `repeats` timed runs of one
    `render_regen` call at the production wavefront size."""
    from raytracer_tpu.integrator.wavefront import strided_schedule
    from raytracer_tpu.render.driver import (
        DEFAULT_TARGET_RAYS_PER_PASS,
        regen_plan,
        render_regen,
    )

    w, h = settings.width, settings.height
    n = w * h
    wavefront, _ = regen_plan(n, spp, DEFAULT_TARGET_RAYS_PER_PASS)
    kw = dict(
        width=w,
        height=h,
        spp=spp,
        wavefront_size=wavefront,
        max_depth=settings.max_depth,
        sky_gradient=settings.sky_gradient,
        return_stats=True,
    )
    key = jax.random.PRNGKey(0)
    # Warmup / compile.
    jax.block_until_ready(render_regen(scene, cam, jax.random.fold_in(key, 999), **kw))

    walls, seg_counts, iter_counts = [], [], []
    for r in range(repeats):
        t0 = time.perf_counter()
        img, segs, iters = jax.block_until_ready(
            render_regen(scene, cam, jax.random.fold_in(key, r), **kw)
        )
        walls.append(time.perf_counter() - t0)
        seg_counts.append(int(segs))
        iter_counts.append(int(iters))
    i = walls.index(statistics.median_low(walls))
    dt, total_segments, total_iters = walls[i], seg_counts[i], iter_counts[i]
    # Iterations are whole-wavefront steps over the actual lane count.
    n_lanes, _, _ = strided_schedule(n, spp, wavefront)
    return {
        "traced_mrays_per_s": round(total_segments / dt / 1e6, 3),
        "camera_mrays_per_s": round(n * spp / dt / 1e6, 3),
        "avg_segments_per_camera_ray": round(total_segments / (n * spp), 2),
        "occupancy": round(total_segments / (total_iters * n_lanes), 3),
        "wall_s": round(dt, 3),
        "spp": spp,
        "walls_s": [round(x, 3) for x in walls],
    }


def _measure_grad_step(
    repeats: int, width: int = 200, height: int = 112, spp: int = 8,
    max_depth: int = 16,
):
    """Median wall time of one jitted value_and_grad inverse-render step
    (loss + scene-parameter gradients) on rand_spheres. Reported as
    camera-ray rate; the fixed-depth scan traces width*height*spp*max_depth
    lane-bounces forward AND rematerializes them in the backward pass."""
    from functools import partial

    from raytracer_tpu.diff.grad import render_loss, split_scene
    from raytracer_tpu.scenes.registry import get_scene

    scene, cam, _ = get_scene("rand_spheres", width=width, spp=spp)
    params, rebuild = split_scene(scene)
    target = jnp.zeros((height, width, 3), jnp.float32)
    lossfn = jax.jit(
        jax.value_and_grad(
            partial(
                render_loss, rebuild=rebuild, cam=cam, target=target,
                width=width, height=height, samples_per_pass=spp,
                max_depth=max_depth,
            )
        )
    )
    key = jax.random.PRNGKey(7)

    def step(k):
        return jax.block_until_ready(lossfn(params, key=k))

    step(key)  # compile
    step(jax.random.fold_in(key, 99))  # first post-compile step pays extra
    walls = []
    for r in range(repeats):
        t0 = time.perf_counter()
        step(jax.random.fold_in(key, r))
        walls.append(time.perf_counter() - t0)
    dt = statistics.median_low(walls)
    cam_rays = width * height * spp
    out = {
        "step_wall_s": round(dt, 3),
        "camera_mrays_per_s": round(cam_rays / dt / 1e6, 3),
        "fixed_depth_lane_bounces_mrays_per_s": round(
            cam_rays * max_depth / dt / 1e6, 2
        ),
        "size": [width, height],
        "spp": spp,
        "max_depth": max_depth,
        "walls_s": [round(x, 3) for x in walls],
    }

    # Production gradient backend: depth-bucketed tape replay. Extra
    # warmups: the first steps settle the bucket pad shapes.
    from raytracer_tpu.diff.bucketed import make_bucketed_grad_fn

    kfn = make_bucketed_grad_fn(
        rebuild, cam, target, width=width, height=height,
        samples_per_pass=spp, max_depth=max_depth,
    )

    def kstep(k):
        return jax.block_until_ready(kfn(params, k))

    for w in range(3):
        kstep(jax.random.fold_in(key, 90 + w))
    kwalls = []
    for r in range(repeats):
        t0 = time.perf_counter()
        kstep(jax.random.fold_in(key, r))
        kwalls.append(time.perf_counter() - t0)
    kdt = statistics.median_low(kwalls)
    out["bucketed_step_wall_s"] = round(kdt, 3)
    out["bucketed_camera_mrays_per_s"] = round(cam_rays / kdt / 1e6, 3)
    out["bucketed_walls_s"] = [round(x, 3) for x in kwalls]
    return out


def _measure_grad_depth50(repeats: int):
    """The reference-depth gradient point (round-3 VERDICT #2): one
    inverse-render step at 400x225 @ 8spp, depth 50, through (a) the
    checkpointed-scan backend and (b) the depth-bucketed tape-replay
    backend (diff/bucketed.py — phase-compacted forward + per-path-length
    replay buckets; exact to fp tolerance by test)."""
    import statistics as _st

    from raytracer_tpu.diff.bucketed import make_bucketed_grad_fn
    from raytracer_tpu.diff.grad import render_loss, split_scene
    from raytracer_tpu.scenes.registry import get_scene
    from functools import partial

    width, height, spp, depth = 400, 225, 8, 50
    scene, cam, _ = get_scene("rand_spheres", width=width, spp=spp)
    params, rebuild = split_scene(scene)
    target = jnp.zeros((height, width, 3), jnp.float32)
    out = {"size": [width, height], "spp": spp, "max_depth": depth}

    scan_fn = jax.jit(
        jax.value_and_grad(
            partial(
                render_loss, rebuild=rebuild, cam=cam, target=target,
                width=width, height=height, samples_per_pass=spp,
                max_depth=depth,
            )
        )
    )
    bucket_fn = make_bucketed_grad_fn(
        rebuild, cam, target, width=width, height=height,
        samples_per_pass=spp, max_depth=depth,
    )
    key = jax.random.PRNGKey(7)
    for name, fn, kw_style in (
        ("scan", scan_fn, "kw"),
        ("bucketed", bucket_fn, "pos"),
    ):
        def run(k):
            out = fn(params, key=k) if kw_style == "kw" else fn(params, k)
            return jax.block_until_ready(out)

        run(key)
        run(jax.random.fold_in(key, 99))
        run(jax.random.fold_in(key, 98))  # bucket pad shapes settle
        walls = []
        for r in range(repeats):
            t0 = time.perf_counter()
            run(jax.random.fold_in(key, r))
            walls.append(time.perf_counter() - t0)
        out[f"{name}_step_wall_s"] = round(_st.median_low(walls), 3)
        out[f"{name}_walls_s"] = [round(x, 3) for x in walls]
    return out


def _measure_grad_full(repeats: int):
    """Composed-gradient production point: one optimization step at
    400x225 @ 8spp depth 50 with the FULL gradient — interior (bucketed
    tape replay) + silhouette boundary term
    (diff/boundary.py) + first-bounce shadow edges (diff/shadow_edge.py) —
    the configuration a user optimizing geometry should actually run."""
    import statistics as _st

    from raytracer_tpu.diff.grad import make_inverse_renderer
    from raytracer_tpu.scenes.registry import get_scene
    from raytracer_tpu.utils.metrics import device_memory_stats

    width, height, spp, depth = 400, 225, 8, 50
    scene, cam, _ = get_scene("rand_spheres", width=width, spp=spp)
    target = jnp.zeros((height, width, 3), jnp.float32)
    params, opt_state, step = make_inverse_renderer(
        scene, cam, target, trainable=("sph_center", "sph_radius", "tex_c0"),
        width=width, height=height, samples_per_pass=spp, max_depth=depth,
        boundary=True, shadow_edges=True, backend="bucketed",
    )
    key = jax.random.PRNGKey(7)

    def run(k):
        nonlocal params, opt_state
        # Wait on the UPDATED params, not just the loss: the loss is
        # produced by the forward early in the step.
        params, opt_state, loss = jax.block_until_ready(
            step(params, opt_state, k)
        )

    for w in range(3):
        run(jax.random.fold_in(key, 90 + w))
    walls = []
    for r in range(repeats):
        t0 = time.perf_counter()
        run(jax.random.fold_in(key, r))
        walls.append(time.perf_counter() - t0)
    out = {
        "size": [width, height],
        "spp": spp,
        "max_depth": depth,
        "boundary": True,
        "shadow_edges": True,
        "step_wall_s": round(_st.median_low(walls), 3),
        "walls_s": [round(x, 3) for x in walls],
    }
    out.update(device_memory_stats())
    return out


def main() -> None:
    from raytracer_tpu.scenes.registry import get_scene
    from raytracer_tpu.utils.compile_cache import enable_compile_cache
    from raytracer_tpu.utils.device import card_name_and_power_limit, require_gpu

    device = require_gpu()
    enable_compile_cache()
    spp = int(os.environ.get("RT_BENCH_SPP", "500"))
    width = int(os.environ.get("RT_BENCH_WIDTH", "400"))
    repeats = int(os.environ.get("RT_BENCH_REPEATS", "3"))
    scene, cam, settings = get_scene("rand_spheres", width=width, spp=spp)
    w, h = settings.width, settings.height

    main_run = _measure(scene, cam, settings, spp=spp, repeats=repeats)
    detail = dict(main_run)
    detail["size"] = [w, h]
    detail["device"] = device
    detail["card"] = card_name_and_power_limit()
    if os.environ.get("RT_BENCH_LOW_SPP", "1") == "1" and spp != 64:
        detail["low_spp"] = _measure(scene, cam, settings, spp=64, repeats=repeats)
    if os.environ.get("RT_BENCH_SCENES", "1") == "1":
        # (cell name, scene name, spp, scene overrides). Texture-heavy
        # scenes, the reference configs of cornell (600x600 @ 200 spp,
        # main.go:194-225) and quads (400x225 @ 100 spp, main.go:132-160),
        # large scenes (10K/50K spheres, 8K quads) and the book-canonical
        # 1200x800 frame measured at one 125-spp chunk.
        cells = (
            ("perlin", "perlin", 500, dict(width=width)),
            ("simple_light", "simple_light", 500, dict(width=width)),
            ("earth", "earth", 500, dict(width=width)),
            ("earth_bilinear", "earth", 500, dict(width=width, bilinear=True)),
            ("earth_hires_tex", "earth", 100, dict(tex_height=512, tex_width=1024)),
            ("cornell", "cornell", 200, {}),
            ("quads", "quads", 100, {}),
            ("large_10k", "rand_spheres_large", 64, dict(width=400)),
            ("large_50k", "rand_spheres_large", 64, dict(width=400, n_spheres=50000)),
            ("quad_field_8k", "quad_field", 64, dict(width=400)),
            ("one_weekend_1200x800", "one_weekend_final", 125, {}),
        )
        for cell, name, cell_spp, overrides in cells:
            sc, cm, st = get_scene(name, spp=cell_spp, **overrides)
            detail[cell] = _measure(sc, cm, st, spp=cell_spp, repeats=repeats)
        # Differentiable-path points: one inverse-render step on the
        # 500-sphere scene (scan + bucketed backends), the reference-depth
        # step, and the composed interior + boundary + shadow-edge step.
        detail["grad"] = _measure_grad_step(repeats=repeats)
        detail["grad_depth50"] = _measure_grad_depth50(repeats=repeats)
        detail["grad_full"] = _measure_grad_full(repeats=repeats)

    print(
        json.dumps(
            {
                "metric": "traced_rays_per_s_randspheres",
                "value": main_run["traced_mrays_per_s"],
                "unit": "Mrays/s",
                "vs_baseline": round(main_run["camera_mrays_per_s"] / 0.9, 2),
                "detail": detail,
            }
        )
    )


if __name__ == "__main__":
    main()
