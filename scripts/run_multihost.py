"""Multi-host render launcher: one process per host, each driving its
local GPUs.

Run this same script once on every host with the same --coordinator
(host:port of process 0), --num-processes and a distinct --process-id;
nothing in the environment tells JAX of the cluster, so all three are
required for a multi-host run. Without --coordinator it renders on the
local host's cards alone. The mesh lays image tiles across hosts and the
sample budget across each host's cards — see raytracer_tpu/parallel/mesh.py.
Process 0 assembles and writes the image.

Usage (per host):
    python scripts/run_multihost.py --scene rand_spheres --spp 500 \
        --coordinator host0:12345 --num-processes 2 --process-id 0 \
        --out out/mh.png
"""

from __future__ import annotations

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import jax
import numpy as np


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--scene", default="rand_spheres")
    ap.add_argument("--spp", type=int, default=None)
    ap.add_argument("--width", type=int, default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default="out/multihost.png")
    ap.add_argument("--coordinator", default=None,
                    help="host:port of process 0 (multi-host runs)")
    ap.add_argument("--num-processes", type=int, default=None)
    ap.add_argument("--process-id", type=int, default=None)
    # Local validation without several hosts: N CPU processes on one
    # machine stand in for N hosts (each with --local-devices virtual
    # devices) — the same jax.distributed + global-mesh code path, with
    # gloo over localhost as the transport.
    ap.add_argument("--local-devices", type=int, default=None,
                    help="virtual CPU devices per process (local testing)")
    ap.add_argument("--sample-parallel", type=int, default=None,
                    help="devices cooperating on the same pixels (mesh "
                    "samples axis; default = local device count). Pinning "
                    "it makes the GLOBAL mesh shape — and therefore the "
                    "per-device keys and the image, bit-for-bit — "
                    "independent of how devices split across processes")
    args = ap.parse_args()

    if args.local_devices is not None:
        os.environ["XLA_FLAGS"] = (
            os.environ.get("XLA_FLAGS", "")
            + f" --xla_force_host_platform_device_count={args.local_devices}"
        ).strip()
        jax.config.update("jax_platforms", "cpu")
    if args.coordinator is not None:
        if args.num_processes is None or args.process_id is None:
            ap.error("--coordinator needs --num-processes and --process-id")
        jax.distributed.initialize(
            args.coordinator,
            num_processes=args.num_processes,
            process_id=args.process_id,
        )

    from raytracer_tpu.imgio.image import write_png
    from raytracer_tpu.parallel.mesh import multihost_mesh
    from raytracer_tpu.parallel.shard import render_image_sharded
    from raytracer_tpu.render.postprocess import to_u8
    from raytracer_tpu.scenes.registry import get_scene

    overrides = {}
    if args.spp:
        overrides["spp"] = args.spp
    if args.width:
        overrides["width"] = args.width
    scene, cam, settings = get_scene(args.scene, args.seed, **overrides)

    mesh = multihost_mesh(sample_parallel=args.sample_parallel)
    if jax.process_index() == 0:
        print(f"mesh: {dict(mesh.shape)} over {jax.device_count()} devices "
              f"/ {jax.process_count()} hosts", flush=True)

    t0 = time.perf_counter()
    linear = render_image_sharded(scene, cam, settings, mesh, seed=args.seed)
    img = np.asarray(jax.device_get(to_u8(linear)))
    dt = time.perf_counter() - t0

    if jax.process_index() == 0:
        write_png(args.out, img)
        rays = settings.width * settings.height * settings.samples_per_pixel
        print(
            f"done in {dt:.2f}s — {rays / dt / 1e6:.1f} camera Mrays/s "
            f"aggregate -> {args.out}",
            flush=True,
        )


if __name__ == "__main__":
    main()
