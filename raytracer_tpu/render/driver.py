"""Tiled/batched render driver: the accelerator replacement for the reference's
goroutine worker pool + ordered channel pipeline (camera.go:180-263).

Design (SURVEY.md §2.1 "Render engine"): the image is a flat pixel array;
each jitted *pass* traces `samples_per_pass` fresh camera samples for every
pixel in one big wavefront batch (pixel index is just an array index, so the
reference's ordering machinery — Bridge/Agg/Buf stages — has no analog).
Passes accumulate radiance on device; spp is exact. One compiled executable
serves all passes (the PRNG key is the only changing input).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from raytracer_tpu.core.camera import Camera, RenderSettings, camera_frame, camera_rays
from raytracer_tpu.geometry.scene import Scene
from raytracer_tpu.integrator.wavefront import render_wavefront_regen, trace
from raytracer_tpu.render.postprocess import to_u8

# Target wavefront size per pass: one image's worth of lanes up to 2M, at
# least 512K — chunking a big image through a small wavefront multiplies the
# per-call overheads and the drain tail.
DEFAULT_TARGET_RAYS_PER_PASS = 1 << 19
MAX_WAVEFRONT = 1 << 21

# Retirement-log slots per lane: the (3, K, N) log lives in device memory,
# so K bounds its size (3 * 64 * 2M lanes * 4 B = 1.5 GB at the cap).
REGEN_MAX_SLOTS = 64


def regen_spp_chunk(
    spp: int, n_pixels: int, wavefront: int, max_slots: int, n_dev: int = 1
) -> int:
    """Chunk the spp budget so each device's retirement-log slot count stays
    within `max_slots` (a device's share of a chunk is ceil(chunk / n_dev),
    so bound that ceil: chunk <= n_dev * floor(max_slots * wavefront / n)).
    Prefers a divisor of spp: every chunk is then the same size -> exactly
    ONE compiled executable instead of two. Shared by render_image and the
    sharded renderer so the two sizing rules cannot drift."""
    cap = max(1, min(spp, n_dev * ((max_slots * wavefront) // max(1, n_pixels))))
    return next((k for k in range(cap, 0, -1) if spp % k == 0), cap)


def samples_per_pass_for(
    spp: int, num_pixels: int, target_rays: int = DEFAULT_TARGET_RAYS_PER_PASS
) -> int:
    """Largest k <= ideal that divides spp, so passes * k == spp exactly."""
    ideal = max(1, min(spp, target_rays // max(1, num_pixels)))
    for k in range(ideal, 0, -1):
        if spp % k == 0:
            return k
    return 1


@partial(
    jax.jit,
    static_argnames=("width", "height", "samples_per_pass", "max_depth", "sky_gradient"),
)
def render_pass(
    scene: Scene,
    cam: Camera,
    key,
    *,
    width: int,
    height: int,
    samples_per_pass: int,
    max_depth: int,
    sky_gradient: bool,
):
    """Trace `samples_per_pass` samples for every pixel; return the per-pixel
    radiance *sum* of this pass, shape (height, width, 3)."""
    n = width * height
    k = samples_per_pass
    frame = camera_frame(cam, width, height)

    pix = jax.lax.broadcasted_iota(jnp.int32, (k * n, 1), 0)[:, 0] % n
    px = pix % width
    py = pix // width

    key_cam, key_trace = jax.random.split(key)
    cam_uniforms = jax.random.uniform(key_cam, (k * n, 4), jnp.float32)
    origin, direction = camera_rays(frame, px, py, cam_uniforms)

    radiance = trace(
        scene,
        origin,
        direction,
        key_trace,
        cam.background,
        max_depth=max_depth,
        sky_gradient=sky_gradient,
    )
    per_pixel = radiance.reshape(k, n, 3).sum(axis=0)
    return per_pixel.reshape(height, width, 3)


@partial(
    jax.jit,
    static_argnames=(
        "width",
        "height",
        "spp",
        "wavefront_size",
        "max_depth",
        "sky_gradient",
        "rr_max_q",
        "intersect",
        "return_stats",
    ),
)
def render_regen(
    scene: Scene,
    cam: Camera,
    key,
    *,
    width: int,
    height: int,
    spp: int,
    wavefront_size: int,
    max_depth: int,
    sky_gradient: bool,
    rr_max_q: float = 0.95,
    intersect=None,
    return_stats: bool = False,
):
    """Full-image render via the regenerative wavefront (the production fast
    path): one jit call traces the entire sample budget at ~full occupancy.
    Returns mean radiance (H, W, 3) (+ (segments, iters) with stats).
    `intersect` overrides the platform's closest hit (see regen_core)."""
    frame = camera_frame(cam, width, height)
    out = render_wavefront_regen(
        scene,
        frame,
        cam.background,
        width=width,
        height=height,
        spp=spp,
        wavefront_size=wavefront_size,
        key=key,
        max_depth=max_depth,
        sky_gradient=sky_gradient,
        rr_max_q=rr_max_q,
        intersect=intersect,
        return_stats=return_stats,
    )
    if return_stats:
        fb, segments, iters = out
        return fb.reshape(height, width, 3) / jnp.float32(spp), segments, iters
    return out.reshape(height, width, 3) / jnp.float32(spp)


def regen_plan(n_pixels: int, spp: int, target_rays_per_pass: int):
    """(wavefront lanes, spp per chunk) for a regenerative render: at least
    one full image of lanes (capped), chunked so the retirement log stays
    within REGEN_MAX_SLOTS samples per lane."""
    wavefront = int(max(target_rays_per_pass, min(n_pixels, MAX_WAVEFRONT)))
    return wavefront, regen_spp_chunk(spp, n_pixels, wavefront, REGEN_MAX_SLOTS)


def _render_regen_image(
    scene: Scene,
    cam: Camera,
    settings: RenderSettings,
    *,
    seed: int,
    target_rays_per_pass: int = DEFAULT_TARGET_RAYS_PER_PASS,
    progress: bool = False,
    metrics=None,
    intersect=None,
):
    """render_image's regenerative path: spp chunks of `render_regen`, each
    keyed fold_in(PRNGKey(seed), chunk). `intersect` is regen_core's
    closest-hit hook (None: the platform's)."""
    w, h, spp = settings.width, settings.height, settings.samples_per_pixel
    n = w * h
    key = jax.random.PRNGKey(seed)
    wavefront, spp_chunk = regen_plan(n, spp, target_rays_per_pass)
    if metrics is not None:
        from raytracer_tpu.integrator.wavefront import strided_schedule

        n_lanes, num_slots, _ = strided_schedule(n, spp_chunk, wavefront)
        # Occupancy basis: whole-wavefront iterations over the actual lane
        # count, not the requested wavefront.
        metrics.wavefront_lanes = n_lanes
        metrics.retirement_log_mb = 3 * num_slots * n_lanes * 4 / 2**20
    acc = jnp.zeros((h, w, 3), jnp.float32)
    done = 0
    chunk_idx = 0
    chunk_stats = []  # device scalars; synced once after the last chunk
    while done < spp:
        step_spp = min(spp_chunk, spp - done)
        out = render_regen(
            scene,
            cam,
            jax.random.fold_in(key, chunk_idx),
            width=w,
            height=h,
            spp=step_spp,
            wavefront_size=wavefront,
            max_depth=settings.max_depth,
            sky_gradient=settings.sky_gradient,
            intersect=intersect,
            return_stats=metrics is not None,
        )
        if metrics is not None:
            fb, segments, iters = out
            chunk_stats.append((segments, iters))
        else:
            fb = out
        acc = acc + fb * jnp.float32(step_spp)
        done += step_spp
        chunk_idx += 1
        if metrics is not None:
            metrics.update(done)
        if progress:
            print(f"spp {done}/{spp}", flush=True)
    if metrics is not None and chunk_stats:
        metrics.update(
            done,
            segments=sum(int(s) for s, _ in chunk_stats),
            iters=sum(int(i) for _, i in chunk_stats),
        )
    return acc / jnp.float32(spp)


def render_image(
    scene: Scene,
    cam: Camera,
    settings: RenderSettings,
    *,
    seed: int = 0,
    target_rays_per_pass: int = DEFAULT_TARGET_RAYS_PER_PASS,
    progress: bool = False,
    regenerative: bool = True,
    metrics=None,
) -> jnp.ndarray:
    """Render the full image; returns linear mean radiance (H, W, 3) f32.

    Equivalent of Camera.Render + GetPixelColor's spp averaging
    (camera.go:180-263), minus the output encoding (see postprocess/imgio).

    regenerative=True (default) uses the path-regeneration wavefront (fast);
    False uses the simple pass loop (reference implementation, also the
    shape the differentiable path uses).

    metrics: optional utils.metrics.RenderMetrics — receives per-chunk spp
    progress immediately (no device sync) and traced-segment / iteration
    totals after the last chunk (one sync at the end; SURVEY.md §5
    observability).
    """
    if regenerative:
        return _render_regen_image(
            scene, cam, settings, seed=seed,
            target_rays_per_pass=target_rays_per_pass, progress=progress,
            metrics=metrics,
        )
    w, h, spp = settings.width, settings.height, settings.samples_per_pixel
    n = w * h
    key = jax.random.PRNGKey(seed)
    k = samples_per_pass_for(spp, n, target_rays_per_pass)
    passes = spp // k
    acc = jnp.zeros((h, w, 3), jnp.float32)
    for p in range(passes):
        acc = acc + render_pass(
            scene,
            cam,
            jax.random.fold_in(key, p),
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


def render_scene(scene: Scene, cam: Camera, settings: RenderSettings, **kw):
    """Render and postprocess to uint8 (H, W, 3) on host."""
    linear = render_image(scene, cam, settings, **kw)
    return np.asarray(jax.device_get(to_u8(linear)))
