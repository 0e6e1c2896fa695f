"""Command-line driver: render a registered scene to PPM/PNG.

Replacement for the reference's main() (main.go:22-78) with real flags
instead of compile-time constants, plus structured progress and a rays/s
report (SURVEY.md §5 observability).

Usage:
    python -m raytracer_tpu.cli --scene cornell --out out/cornell.png
"""

from __future__ import annotations

import argparse
import json
import time

import jax

from raytracer_tpu.render.driver import render_scene
from raytracer_tpu.scenes.registry import SCENES, get_scene
from raytracer_tpu.imgio.image import write_png, write_ppm
from raytracer_tpu.utils.compile_cache import enable_compile_cache


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--scene", default="rand_spheres", choices=sorted(SCENES))
    ap.add_argument("--out", default="out/img.png")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--width", type=int, default=None)
    ap.add_argument("--spp", type=int, default=None)
    ap.add_argument("--max-depth", type=int, default=None)
    ap.add_argument("--profile", action="store_true", help="jax.profiler trace to out/trace")
    ap.add_argument(
        "--memory-profile",
        default=None,
        metavar="PATH",
        help="write a JSON device-memory report (live buffers by shape) "
        "after the render — heap-profile analog of the reference's "
        "main.go:70-73",
    )
    ap.add_argument(
        "--checkpoint",
        default=None,
        help="checkpoint file; resumes from it if present (fail-stop + rerun)",
    )
    ap.add_argument(
        "--shard",
        action="store_true",
        help="render over ALL visible devices ((tiles, samples) mesh via "
        "shard_map; see parallel/shard.py) — for multi-chip hosts",
    )
    ap.add_argument(
        "--sample-parallel",
        type=int,
        default=1,
        help="with --shard: devices cooperating on the same pixels "
        "(must divide the device count)",
    )
    ap.add_argument(
        "--bilinear",
        action="store_true",
        help="bilinear texture filtering (scenes with image textures; the "
        "reference is nearest-neighbor, materials.go:184-192)",
    )
    ap.add_argument(
        "--no-bucket",
        action="store_true",
        help="disable scene-table size bucketing (bucketing lets scenes with "
        "nearby table sizes share one jit executable; the image is "
        "bit-identical either way — see geometry.scene.bucket_size)",
    )
    args = ap.parse_args(argv)
    if args.sample_parallel != 1 and not args.shard:
        ap.error("--sample-parallel requires --shard")
    enable_compile_cache()

    overrides = {"bucket": not args.no_bucket}
    if args.bilinear:
        import inspect

        if "bilinear" not in inspect.signature(SCENES[args.scene]).parameters:
            ap.error(f"--bilinear is not supported by scene {args.scene!r}")
        overrides["bilinear"] = True
    if args.width is not None:
        overrides["width"] = args.width
    if args.spp is not None:
        overrides["spp"] = args.spp
    if args.max_depth is not None:
        overrides["max_depth"] = args.max_depth

    scene, cam, settings = get_scene(args.scene, args.seed, **overrides)

    from raytracer_tpu.utils.metrics import (
        RenderMetrics,
        device_memory_stats,
        profiler_trace,
        save_memory_profile,
    )

    metrics = RenderMetrics(
        total_spp=settings.samples_per_pixel,
        pixels=settings.width * settings.height,
    )
    t0 = time.perf_counter()
    with profiler_trace("out/trace" if args.profile else None):
        if args.checkpoint and not args.shard:
            import numpy as np

            from raytracer_tpu.render.checkpoint import render_with_checkpoints
            from raytracer_tpu.render.postprocess import to_u8

            linear = render_with_checkpoints(
                scene,
                cam,
                settings,
                seed=args.seed,
                checkpoint_path=args.checkpoint,
                progress=True,
            )
            img = np.asarray(jax.device_get(to_u8(linear)))
        elif args.shard:
            import numpy as np

            from raytracer_tpu.parallel.mesh import make_mesh
            from raytracer_tpu.parallel.shard import render_image_sharded
            from raytracer_tpu.render.postprocess import to_u8

            mesh = make_mesh(sample_parallel=args.sample_parallel)
            linear = render_image_sharded(
                scene, cam, settings, mesh, seed=args.seed,
                progress=True, metrics=metrics,
                checkpoint_path=args.checkpoint,
            )
            img = np.asarray(jax.device_get(to_u8(linear)))
        else:
            img = render_scene(
                scene, cam, settings, seed=args.seed, progress=True,
                metrics=metrics,
            )
    dt = time.perf_counter() - t0

    if args.out.endswith(".ppm"):
        write_ppm(args.out, img)
    else:
        write_png(args.out, img)

    if args.memory_profile:
        save_memory_profile(args.memory_profile)

    camera_rays = settings.width * settings.height * settings.samples_per_pixel
    report = {
        "scene": args.scene,
        "size": [settings.width, settings.height],
        "spp": settings.samples_per_pixel,
        "wall_s": round(dt, 3),
        "camera_mrays_per_s": round(camera_rays / dt / 1e6, 3),
        "out": args.out,
    }
    if metrics.traced_segments:
        # Over the render wall, not the metrics' own clock: that one would
        # also count writing the image file.
        report["traced_mrays_per_s"] = round(metrics.traced_segments / dt / 1e6, 3)
    snap = metrics.snapshot()
    for k in ("wavefront_iters", "occupancy", "retirement_log_mb"):
        if k in snap:
            report[k] = snap[k]
    report.update(device_memory_stats())
    print(json.dumps(report))
    return report


if __name__ == "__main__":
    main()
