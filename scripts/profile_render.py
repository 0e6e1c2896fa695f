#!/usr/bin/env python3
"""Device-time breakdown of one render on the GPU.

    python scripts/profile_render.py [--scene rand_spheres] [--width 400]
        [--spp 500] [--xla] [--trace-dir out/profile]

Renders the scene once to compile, three times on the clock (the median is
the wall), then once more under jax.profiler, whose own overhead makes that
render's wall meaningless. Prints one JSON line: the wall, the wavefront
iterations, the GPU's busy time in the traced render (the union of its
kernel intervals) and the idle share of the wall that leaves, and the
device time and call count of the largest kernels by name. `--xla` swaps
the platform's closest-hit kernel for the dense XLA search (regen_core's
intersect hook). Exits non-zero when JAX finds no GPU.
"""

from __future__ import annotations

import argparse
import collections
import glob
import json
import os
import statistics
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def device_events(trace_dir: str):
    """(events, lines): (name, start_ns, duration_ns) of every event on the
    GPU planes' stream lines of the newest trace under `trace_dir` (of all
    their lines if none is a stream), and each line's event count."""
    import jax.profiler

    path = max(glob.glob(os.path.join(trace_dir, "**", "*.xplane.pb"), recursive=True),
               key=os.path.getmtime)
    lines = [
        line
        for plane in jax.profiler.ProfileData.from_file(path).planes
        if plane.name.startswith("/device:GPU")
        for line in plane.lines
    ]
    streams = [line for line in lines if line.name.startswith("Stream")] or lines
    events = [(e.name, e.start_ns, e.duration_ns) for line in streams for e in line.events]
    return events, {line.name: len(list(line.events)) for line in lines}


def busy_ns(events) -> float:
    """Length of the union of the events' intervals."""
    total, end = 0.0, float("-inf")
    for _, start, dur in sorted(events, key=lambda e: e[1]):
        if start + dur > end:
            total += start + dur - max(start, end)
            end = start + dur
    return total


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--scene", default="rand_spheres")
    ap.add_argument("--width", type=int, default=400)
    ap.add_argument("--spp", type=int, default=500)
    ap.add_argument("--xla", action="store_true", help="dense XLA closest hit")
    ap.add_argument("--trace-dir", default=os.path.join("out", "profile"))
    ap.add_argument("--top", type=int, default=12)
    args = ap.parse_args(argv)

    import jax

    from raytracer_tpu.geometry.intersect import closest_hit_t_prim
    from raytracer_tpu.render.driver import _render_regen_image
    from raytracer_tpu.scenes.registry import get_scene
    from raytracer_tpu.utils.compile_cache import enable_compile_cache
    from raytracer_tpu.utils.device import card_name_and_power_limit, require_gpu
    from raytracer_tpu.utils.metrics import RenderMetrics

    device = require_gpu()
    enable_compile_cache()
    scene, cam, settings = get_scene(args.scene, width=args.width, spp=args.spp, bucket=True)
    intersect = closest_hit_t_prim if args.xla else None
    m = RenderMetrics(
        total_spp=settings.samples_per_pixel, pixels=settings.width * settings.height
    )

    def render(metrics=None):
        return jax.block_until_ready(_render_regen_image(
            scene, cam, settings, seed=0, metrics=metrics, intersect=intersect
        ))

    render()  # compile
    walls = []
    for _ in range(3):
        t0 = time.perf_counter()
        render()
        walls.append(time.perf_counter() - t0)
    wall = statistics.median(walls)
    trace_dir = os.path.join(args.trace_dir, f"{args.scene}_{'xla' if args.xla else 'kernel'}")
    jax.profiler.start_trace(trace_dir)
    render(m)
    jax.profiler.stop_trace()

    events, lines = device_events(trace_dir)
    by_name, calls = collections.Counter(), collections.Counter()
    for name, _, dur in events:
        by_name[name] += dur
        calls[name] += 1
    busy = busy_ns(events)
    print(json.dumps({
        "scene": args.scene, "size": [settings.width, settings.height],
        "spp": settings.samples_per_pixel, "max_depth": settings.max_depth,
        "intersect": "xla" if args.xla else "platform",
        "device": device, "card": card_name_and_power_limit(),
        "wall_s": wall, "walls_s": walls, "wavefront_iters": m.wavefront_iters,
        "device_busy_s": busy / 1e9, "device_idle_share": 1 - busy / 1e9 / wall,
        "events": len(events), "lines": lines,
        "top_kernels": {
            k: {"s": v / 1e9, "calls": calls[k]} for k, v in by_name.most_common(args.top)
        },
    }))


if __name__ == "__main__":
    main()
