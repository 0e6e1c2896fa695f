"""Sharded wavefront rendering over a device mesh (shard_map + collectives).

The image's pixel axis shards over the `tiles` mesh axis and the spp budget
over the `samples` axis; each device traces its own wavefront locally (the
wavefront loop needs no cross-device communication — rays never migrate), and
the per-pixel sample sum reduces over the `samples` axis. This is the
accelerator replacement for the reference's worker pool + ordered channel
fan-in (camera.go:167-230): ordering is free (indexed writes) and "fan-in" is
one XLA collective (NCCL over NVLink on a GPU host).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from jax import shard_map

from raytracer_tpu.core.camera import Camera, RenderSettings, camera_frame, camera_rays
from raytracer_tpu.geometry.scene import Scene
from raytracer_tpu.integrator.wavefront import (
    regen_core,
    schedule_arrays,
    strided_schedule,
    trace,
)
from raytracer_tpu.parallel.mesh import SAMPLE_AXIS, TILE_AXIS


def _pad_to(x: int, m: int) -> int:
    return (x + m - 1) // m * m


@partial(
    jax.jit,
    static_argnames=("mesh", "width", "height", "samples_per_pass", "max_depth", "sky_gradient"),
)
def render_pass_sharded(
    scene: Scene,
    cam: Camera,
    key,
    *,
    mesh: Mesh,
    width: int,
    height: int,
    samples_per_pass: int,
    max_depth: int,
    sky_gradient: bool,
):
    """One sharded pass: per-pixel radiance *sum* over `samples_per_pass`
    samples, shape (height, width, 3), sharded over the tile axis.

    Pixel count pads up to the tile-axis size; samples_per_pass must divide
    by the sample-axis size (callers use `sharded_samples_per_pass`).
    """
    n_tiles = mesh.shape[TILE_AXIS]
    n_samp = mesh.shape[SAMPLE_AXIS]
    if samples_per_pass % n_samp != 0:
        raise ValueError(f"{samples_per_pass=} not divisible by {n_samp=}")

    n = width * height
    n_pad = _pad_to(n, n_tiles)
    # (k, n_pad) grid of (sample slot, pixel id); padded pixels clamp to the
    # last real pixel and are dropped after the reduce.
    pix = jnp.minimum(
        jax.lax.broadcasted_iota(jnp.int32, (samples_per_pass, n_pad), 1), n - 1
    )

    frame = camera_frame(cam, width, height)
    background = cam.background

    def local_pass(pix_block, key):
        """Runs per device: pix_block (k_loc, n_loc)."""
        ti = jax.lax.axis_index(TILE_AXIS)
        si = jax.lax.axis_index(SAMPLE_AXIS)
        dev_key = jax.random.fold_in(jax.random.fold_in(key, ti), si)
        k_loc, n_loc = pix_block.shape
        flat_pix = pix_block.reshape(-1)
        key_cam, key_trace = jax.random.split(dev_key)
        uniforms = jax.random.uniform(key_cam, (k_loc * n_loc, 4), jnp.float32)
        o, d = camera_rays(frame, flat_pix % width, flat_pix // width, uniforms)
        radiance = trace(
            scene,
            o,
            d,
            key_trace,
            background,
            max_depth=max_depth,
            sky_gradient=sky_gradient,
        )
        # Local partial sum over this device's sample slots; the global sum
        # over the sample axis happens in the out-sharded reduce below.
        return radiance.reshape(k_loc, n_loc, 3).sum(axis=0, keepdims=True)

    def wrapped(pix_grid, key):
        return shard_map(
            local_pass,
            mesh=mesh,
            in_specs=(P(SAMPLE_AXIS, TILE_AXIS), P()),
            out_specs=P(SAMPLE_AXIS, TILE_AXIS),
            check_vma=False,  # while_loop carry inits are unvarying constants
        )(pix_grid, key)

    partial_sums = wrapped(pix, key)  # (n_samp, n_pad, 3) sharded
    per_pixel = partial_sums.sum(axis=0)  # reduce over sample axis (psum)
    return per_pixel[:n].reshape(height, width, 3)


def sharded_samples_per_pass(spp: int, num_pixels: int, mesh: Mesh, target_rays: int) -> int:
    """Largest k dividing spp with k % sample_axis == 0 and k*n <= target.

    A valid k exists iff spp is a multiple of the sample-axis size (k must
    divide spp AND be a multiple of n_samp); raise a clear error otherwise
    instead of returning a k that crashes mid-trace in render_pass_sharded."""
    n_samp = mesh.shape[SAMPLE_AXIS]
    if spp % n_samp != 0:
        raise ValueError(
            f"spp={spp} must be a multiple of the sample-axis size "
            f"({n_samp}) for the pass-based sharded render; use "
            "regenerative=True (the default), which splits any spp exactly"
        )
    ideal = max(n_samp, min(spp, target_rays // max(1, num_pixels)))
    for k in range(ideal, 0, -1):
        if spp % k == 0 and k % n_samp == 0:
            return k
    return n_samp


@partial(
    jax.jit,
    static_argnames=(
        "mesh",
        "width",
        "height",
        "spp",
        "wavefront_per_device",
        "max_depth",
        "sky_gradient",
        "rr_max_q",
        "return_stats",
    ),
)
def render_regen_sharded(
    scene: Scene,
    cam: Camera,
    key,
    *,
    mesh: Mesh,
    width: int,
    height: int,
    spp: int,
    wavefront_per_device: int,
    max_depth: int,
    sky_gradient: bool,
    rr_max_q: float = 0.95,
    return_stats: bool = False,
):
    """The production fast path, sharded: every device runs the full
    regenerative wavefront loop (the same `regen_core` as single-device) on
    its own slice of the spp budget, then the per-pixel partial sums reduce
    over the mesh with one `psum`.

    The spp budget splits as evenly as integers allow across all D = tiles x
    samples devices; devices differ only in their per-lane sample-queue
    *data* (`init_remaining`) and PRNG key — it is one compiled SPMD program
    (the analog of the reference's identical workers pulling from a shared
    pixel queue, camera.go:167-230). Rays never migrate between
    devices; the wavefront loop itself needs zero communication.

    Returns the (height, width, 3) framebuffer of radiance *sums* over spp
    (divide by spp for the mean); with return_stats also (total_segments,
    max_per_device_iters, summed_iters) — max/sum agreeing means perfect
    load balance.
    """
    n_pixels = width * height
    n_dev = mesh.devices.size
    frame = camera_frame(cam, width, height)

    # Per-device sample budgets (sum == spp exactly; differ by <= 1).
    spp_dev = [spp // n_dev + (1 if i < spp % n_dev else 0) for i in range(n_dev)]
    n_loc, num_slots, _ = strided_schedule(n_pixels, max(spp_dev), wavefront_per_device)
    rem_rows = []
    px0 = py0 = None
    for s_d in spp_dev:
        rem_d, px0, py0 = schedule_arrays(n_loc, n_pixels, s_d, width)
        rem_rows.append(rem_d)
    rem0 = jnp.stack(rem_rows)  # (D, n_loc) — the only per-device data

    def local_render(rem_block, key):
        dev = jax.lax.axis_index(TILE_AXIS) * mesh.shape[SAMPLE_AXIS] + jax.lax.axis_index(
            SAMPLE_AXIS
        )
        fb, segs, iters = regen_core(
            scene,
            frame,
            cam.background,
            rem_block[0],
            px0,
            py0,
            jax.random.fold_in(key, dev),
            width=width,
            height=height,
            num_slots=num_slots,
            max_depth=max_depth,
            sky_gradient=sky_gradient,
            rr_max_q=rr_max_q,
            return_stats=True,
        )
        axes = (TILE_AXIS, SAMPLE_AXIS)
        fb = jax.lax.psum(fb, axes)  # the one collective: per-pixel sums
        return (
            fb,
            jax.lax.psum(segs, axes),
            jax.lax.pmax(iters, axes),
            jax.lax.psum(iters, axes),
        )

    fb, segs, iters_max, iters_sum = shard_map(
        local_render,
        mesh=mesh,
        in_specs=(P((TILE_AXIS, SAMPLE_AXIS)), P()),
        out_specs=(P(), P(), P(), P()),
        check_vma=False,  # while_loop carry inits are unvarying constants
    )(rem0, key)
    fb = fb.reshape(height, width, 3)
    if return_stats:
        return fb, segs, iters_max, iters_sum
    return fb


def render_image_sharded(
    scene: Scene,
    cam: Camera,
    settings: RenderSettings,
    mesh: Mesh,
    *,
    seed: int = 0,
    target_rays_per_pass: int = 1 << 20,
    regenerative: bool = True,
    progress: bool = False,
    metrics=None,
    checkpoint_path: str | None = None,
    max_chunks: int | None = None,
) -> jnp.ndarray:
    """Full sharded render; returns linear mean radiance (H, W, 3).

    regenerative=True (default) runs the production fast path on every
    device (`render_regen_sharded`); False keeps the simple per-pass batch
    tracer (`render_pass_sharded`, the shape the differentiable path uses).

    metrics: optional utils.metrics.RenderMetrics — per-chunk spp progress
    immediately, traced-segment/iteration totals once at the end (iteration
    counts SUM over devices; occupancy is per-device-lane basis, matching
    the single-device report).

    checkpoint_path: resumable sharded rendering (round-3 VERDICT item 4) —
    the regenerative chunk loop checkpoints exactly like the single-device
    render_with_checkpoints (same fingerprint machinery, per-chunk
    background saves, refusal on config mismatch). Chunk keys are
    fold_in(PRNGKey(seed), chunk) and per-device keys derive from the mesh
    position, so a resumed sharded render is bit-identical to an
    uninterrupted one on the same mesh shape (the fingerprint pins the mesh
    axes/sizes). max_chunks stops early after that many chunks (testing /
    cooperative preemption; the checkpoint holds the partial sums).
    """
    w, h, spp = settings.width, settings.height, settings.samples_per_pixel
    key = jax.random.PRNGKey(seed)

    if regenerative:
        from raytracer_tpu.render.driver import REGEN_MAX_SLOTS, regen_spp_chunk

        n_dev = mesh.devices.size
        n = w * h
        wavefront = int(
            min(max(n, 1 << 16), max(target_rays_per_pass // n_dev, 1 << 16))
        )
        # Same chunk-sizing rule as render_image, scaled by the device count
        # (each device's share of a chunk is ceil(spp_chunk / n_dev)).
        spp_chunk = regen_spp_chunk(
            spp, n, wavefront, REGEN_MAX_SLOTS, n_dev=n_dev
        )
        if metrics is not None:
            from raytracer_tpu.integrator.wavefront import strided_schedule

            per_dev_spp = -(-min(spp_chunk, spp) // n_dev)
            n_lanes, num_slots, _ = strided_schedule(n, per_dev_spp, wavefront)
            # Occupancy basis is per-device lanes (iters below SUM across
            # devices, so segments / (iters * lanes) stays comparable to the
            # single-device number).
            metrics.wavefront_lanes = n_lanes
            metrics.retirement_log_mb = 3 * num_slots * n_lanes * 4 / 2**20
        acc = jnp.zeros((h, w, 3), jnp.float32)
        done = 0
        chunk_idx = 0
        saver = None
        fingerprint = ""
        if checkpoint_path:
            from raytracer_tpu.render.checkpoint import (
                BackgroundSaver,
                RenderCheckpoint,
                config_fingerprint,
                load_checkpoint,
            )

            fingerprint = config_fingerprint(
                scene, cam, settings, spp_chunk, seed,
                extra=(
                    "sharded",
                    tuple(mesh.axis_names),
                    tuple(int(s) for s in mesh.devices.shape),
                    wavefront,
                    jax.default_backend(),
                ),
            )
            ck = load_checkpoint(checkpoint_path)
            if ck is not None:
                if ck.config_hash != fingerprint:
                    raise ValueError(
                        f"checkpoint {checkpoint_path} was written under a "
                        "different scene/camera/settings/mesh configuration; "
                        "refusing to resume (delete it to restart)"
                    )
                done, acc, chunk_idx = (
                    ck.done_spp, jnp.asarray(ck.acc), ck.chunk_idx
                )
                if progress:
                    print(f"resumed at {done}/{spp} spp", flush=True)
            saver = BackgroundSaver(checkpoint_path)
        chunk_stats = []  # device scalars; synced once after the last chunk
        chunks_run = 0
        try:
            while done < spp:
                if max_chunks is not None and chunks_run >= max_chunks:
                    break
                step_spp = min(spp_chunk, spp - done)
                out = render_regen_sharded(
                    scene,
                    cam,
                    jax.random.fold_in(key, chunk_idx),
                    mesh=mesh,
                    width=w,
                    height=h,
                    spp=step_spp,
                    wavefront_per_device=wavefront,
                    max_depth=settings.max_depth,
                    sky_gradient=settings.sky_gradient,
                    return_stats=metrics is not None,
                )
                if metrics is not None:
                    fb, segments, _iters_max, iters_sum = out
                    chunk_stats.append((segments, iters_sum))
                else:
                    fb = out
                acc = acc + fb
                done += step_spp
                chunk_idx += 1
                chunks_run += 1
                if saver is not None:
                    saver.submit(
                        RenderCheckpoint(
                            acc=acc,
                            done_spp=done,
                            seed=seed,
                            chunk_idx=chunk_idx,
                            config_hash=fingerprint,
                        )
                    )
                if metrics is not None:
                    metrics.update(done)
                if progress:
                    print(f"spp {done}/{spp}", flush=True)
        finally:
            if saver is not None:
                saver.wait()
        if saver is not None:
            saver.raise_errors()
        if metrics is not None and chunk_stats:
            metrics.update(
                done,
                segments=sum(int(s) for s, _ in chunk_stats),
                iters=sum(int(i) for _, i in chunk_stats),
            )
        return acc / jnp.float32(max(done, 1))

    if checkpoint_path:
        # The per-pass fallback has no chunk checkpoints; refuse loudly
        # instead of silently rendering unresumably.
        raise ValueError(
            "checkpointing requires the regenerative sharded path "
            "(regenerative=True); the per-pass fallback does not checkpoint"
        )
    k = sharded_samples_per_pass(spp, w * h, mesh, target_rays_per_pass)
    passes = spp // k
    acc = jnp.zeros((h, w, 3), jnp.float32)
    for p in range(passes):
        acc = acc + render_pass_sharded(
            scene,
            cam,
            jax.random.fold_in(key, p),
            mesh=mesh,
            width=w,
            height=h,
            samples_per_pass=k,
            max_depth=settings.max_depth,
            sky_gradient=settings.sky_gradient,
        )
        if metrics is not None:
            metrics.update((p + 1) * k)
        if progress:
            print(f"pass {p + 1}/{passes} ({(p + 1) * k}/{spp} spp)", flush=True)
    return acc / jnp.float32(spp)
