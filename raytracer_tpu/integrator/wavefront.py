"""Wavefront path-trace integrator: bounce recursion → iterative masked loop.

This is the heart of the rebuild (SURVEY.md §2.1 "Recursive integrator").
The reference integrates radiance by recursion per ray
(/root/reference/internal/ray.go:32-54):

    depth <= 0            -> black
    miss                  -> background color
    hit, no scatter       -> emitted
    hit, scatter          -> emitted + attenuation ⊙ recurse(scattered)

On the accelerator the recursion becomes an iterative wavefront over a whole ray batch:
a `throughput` product replaces the attenuation multiply chain, `radiance`
accumulates emitted/background terms, and an `alive` mask replaces early
returns. Two loop flavors:

* `lax.while_loop` (default): exits as soon as every lane is dead — for
  sky-lit scenes most paths die in a few bounces, so this skips the long tail
  of the depth-50 budget. Not reverse-differentiable.
* `lax.scan` with per-bounce `jax.checkpoint` (differentiable=True): fixed
  `max_depth` iterations, rematerializing each bounce in the backward pass so
  the VJP does not store every intermediate wavefront (SURVEY.md §7 step 7).
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from raytracer_tpu.core import vecmath as vm
from raytracer_tpu.geometry.intersect import intersect_scene
from raytracer_tpu.geometry.scene import Scene
from raytracer_tpu.materials.materials import UNIFORMS_PER_BOUNCE, shade
from raytracer_tpu.materials.packed import primitive_shading_table


class WavefrontState(NamedTuple):
    origin: jnp.ndarray  # (N, 3)
    direction: jnp.ndarray  # (N, 3)
    throughput: jnp.ndarray  # (N, 3)
    radiance: jnp.ndarray  # (N, 3)
    alive: jnp.ndarray  # (N,) bool
    key: jnp.ndarray  # PRNG key
    bounce: jnp.ndarray  # () i32
    segments: jnp.ndarray  # () i32 — ray segments traced this batch (perf metric)
    # Optional (max_depth, N) i32 path tape: winning prim id per bounce, -1
    # for miss/never-reached. None (an empty subtree) unless the caller
    # requested it — the tape-replay differentiable backend (diff/tape.py)
    # records it with the FAST non-diff forward, then differentiates a
    # cheap per-recorded-prim replay.
    tape: jnp.ndarray | None = None


def sky_color(direction):
    """Book-canonical gradient sky: lerp(white, (0.5, 0.7, 1.0)) on unit-y.
    The reference uses only a flat background color (ray.go:53); this is the
    BASELINE.md 'gradient sky' config option."""
    unit = vm.normalize(direction, eps=1e-20)
    a = 0.5 * (unit[..., 1] + 1.0)
    white = jnp.array([1.0, 1.0, 1.0], direction.dtype)
    blue = jnp.array([0.5, 0.7, 1.0], direction.dtype)
    return (1.0 - a)[..., None] * white + a[..., None] * blue


def _bounce_step(
    scene: Scene,
    packed,
    background,
    sky_gradient: bool,
    state: WavefrontState,
    uniform_seq=None,
    intersect_fn=None,
    rr=None,
):
    """One wavefront bounce: intersect, accumulate emission/background,
    scatter, update masks. Mirrors one level of Ray.GetColor (ray.go:37-53).
    `packed` is the loop-invariant primitive shading table. `uniform_seq`
    ((max_depth, N, UNIFORMS_PER_BOUNCE), optional) replaces the per-bounce
    PRNG draw with injected uniforms — the hook the end-to-end GetColor
    oracle test uses to compare against a scalar reference per ray.
    `intersect_fn(scene, o, d) -> HitRecord` overrides the dense XLA
    closest hit (geometry.backend's kernel-backed intersector)."""
    key, sub = jax.random.split(state.key)
    ifn = intersect_fn or intersect_scene
    if getattr(ifn, "takes_bounce", False):
        # Tape-replay intersector: looks the winner up by bounce index
        # instead of searching primitives (diff/tape.py).
        hit = ifn(scene, state.origin, state.direction, state.bounce)
    else:
        hit = ifn(scene, state.origin, state.direction)
    tape = state.tape
    if tape is not None:
        rec = jnp.where(state.alive & hit.hit, hit.prim_id, -1)
        tape = jax.lax.dynamic_update_index_in_dim(tape, rec, state.bounce, 0)

    # Miss -> background (ray.go:53). `background` is (3,) flat color unless
    # the static sky_gradient flag selects the book sky.
    if sky_gradient:
        bg = sky_color(state.direction)
    else:
        bg = jnp.broadcast_to(background, state.direction.shape)
    miss = state.alive & ~hit.hit
    radiance = state.radiance + jnp.where(
        miss[..., None], state.throughput * bg, 0.0
    )

    if uniform_seq is None:
        uniforms = jax.random.uniform(
            sub, (state.origin.shape[0], UNIFORMS_PER_BOUNCE), state.origin.dtype
        )
    else:
        uniforms = jax.lax.dynamic_index_in_dim(
            uniform_seq, state.bounce, axis=0, keepdims=False
        )
    scat = shade(scene, hit, state.direction, uniforms, packed=packed)

    # Emission adds on every hit (ray.go:41-46).
    live_hit = state.alive & hit.hit
    radiance = radiance + jnp.where(
        live_hit[..., None], state.throughput * scat.emitted, 0.0
    )

    # Continue only where the material scattered (ray.go:44-46; metal absorb
    # materials.go:73-74; lights never scatter materials.go:301-303).
    alive = live_hit & scat.scattered
    throughput = jnp.where(
        alive[..., None], state.throughput * scat.attenuation, state.throughput
    )
    if rr is not None:
        # Unbiased russian roulette (survive with q = clamp(max throughput),
        # boost by 1/q — identical rule to the regen epilogue): used by the
        # edge-radiance tracers, whose while_loop otherwise runs at the
        # GLOBAL max path length (round-5: one deep glass path held 375K
        # edge lanes for ~50 iterations, ~90% of a composed gradient
        # step). Draws its own uniform from the loop key, so uniform_seq
        # consumers are unaffected.
        rr_start, rr_lo, rr_hi = rr
        key, rr_sub = jax.random.split(key)
        q = jnp.clip(jnp.max(throughput, axis=-1), rr_lo, rr_hi)
        rr_on = alive & (state.bounce >= rr_start)
        rru = jax.random.uniform(rr_sub, alive.shape, state.origin.dtype)
        alive = alive & (~rr_on | (rru < q))
        throughput = jnp.where(
            (rr_on & alive)[..., None], throughput / q[..., None], throughput
        )
    origin = jnp.where(alive[..., None], hit.point, state.origin)
    direction = jnp.where(alive[..., None], scat.direction, state.direction)

    return WavefrontState(
        origin=origin,
        direction=direction,
        throughput=throughput,
        radiance=radiance,
        alive=alive,
        key=key,
        bounce=state.bounce + 1,
        segments=state.segments + jnp.sum(state.alive).astype(state.segments.dtype),
        tape=tape,
    )


def trace(
    scene: Scene,
    origin,
    direction,
    key,
    background,
    *,
    max_depth: int = 50,
    sky_gradient: bool = False,
    differentiable: bool = False,
    return_stats: bool = False,
    uniform_seq=None,
    intersect_fn=None,
    intersect_fn_differentiable: bool = False,
    fixed_trip_count: bool = False,
    return_tape: bool = False,
    init_throughput=None,
    init_radiance=None,
    init_alive=None,
    return_state: bool = False,
    checkpoint_bounces: bool = True,
    russian_roulette: bool = False,
    rr_start_depth: int = 5,
    rr_max_q: float = 0.95,
):
    """Trace a batch of rays to completion; returns radiance (N, 3)
    (or (radiance, traced_segment_count) with return_stats=True; with
    return_tape=True additionally the (max_depth, N) i32 per-bounce winner
    tape — see diff/tape.py).

    `init_throughput` / `init_radiance` / `init_alive` resume mid-path
    lanes (phase-compacted tracing, diff/bucketed.py): the batch continues
    with the given carried state instead of fresh camera rays' (1, 0,
    True). `return_state=True` appends the final WavefrontState so a
    caller can compact survivors and resume in a later call.

    Depth exhaustion contributes black (ray.go:33-35): lanes still alive after
    `max_depth` bounces simply never add their tail.

    `uniform_seq` ((max_depth, N, UNIFORMS_PER_BOUNCE), optional): injected
    per-bounce shading uniforms instead of PRNG draws (oracle testing).

    `intersect_fn` overrides the closest-hit backend for every bounce. It
    does not compose with differentiable=True (Pallas kernels have no VJP)
    UNLESS the caller passes intersect_fn_differentiable=True, asserting the
    override routes no cotangent into a Pallas call (e.g.
    geometry.intersect.intersect_scene_pallas_diff, whose kernel runs on
    stop-gradient inputs and whose t is recomputed differentiably).
    """
    n = origin.shape[0]
    dtype = origin.dtype
    init = WavefrontState(
        origin=origin,
        direction=direction,
        throughput=(
            jnp.ones((n, 3), dtype) if init_throughput is None else init_throughput
        ),
        radiance=(
            jnp.zeros((n, 3), dtype) if init_radiance is None else init_radiance
        ),
        alive=jnp.ones((n,), bool) if init_alive is None else init_alive,
        key=key,
        bounce=jnp.int32(0),
        segments=jnp.int32(0),
        tape=jnp.full((max_depth, n), -1, jnp.int32) if return_tape else None,
    )
    # Build the packed shading table once; it is loop-invariant.
    packed = primitive_shading_table(scene)
    step = partial(
        _bounce_step, scene, packed, background, sky_gradient,
        uniform_seq=uniform_seq, intersect_fn=intersect_fn,
        rr=(rr_start_depth, 0.05, rr_max_q) if russian_roulette else None,
    )

    assert intersect_fn_differentiable or not (
        differentiable and intersect_fn
    ), "Pallas intersector overrides have no VJP; use the default backend"

    if differentiable:
        # Fixed-depth scan; checkpoint each bounce so the backward pass
        # rematerializes intersections instead of storing every (N,S)
        # buffer. checkpoint_bounces=False skips the remat (stores all
        # bounce residuals): right for SHORT loops over O(1)-per-lane
        # intersectors — the depth-bucketed replay's shallow buckets, where
        # residual memory is small and the recompute pass is ~25% of the
        # step (round-5 measurement).
        step_d = jax.checkpoint(step) if checkpoint_bounces else step

        def scan_body(state, _):
            return step_d(state), None

        final, _ = jax.lax.scan(scan_body, init, None, length=max_depth)
    elif fixed_trip_count:
        # No data-dependent early exit: every device of a shard_map runs
        # the same number of bounces.
        final = jax.lax.fori_loop(0, max_depth, lambda _, s: step(s), init)
    else:
        final = jax.lax.while_loop(
            lambda s: (s.bounce < max_depth) & jnp.any(s.alive),
            step,
            init,
        )
    if return_state:
        return final
    if return_stats and return_tape:
        return final.radiance, final.segments, final.tape
    if return_stats:
        return final.radiance, final.segments
    if return_tape:
        return final.radiance, final.tape
    return final.radiance


class RegenState(NamedTuple):
    """Carry for the regenerative wavefront loop (strided-dynamic)."""

    origin: jnp.ndarray  # (N, 3)
    direction: jnp.ndarray  # (N, 3)
    throughput: jnp.ndarray  # (N, 3)
    radiance: jnp.ndarray  # (N, 3) — current path's accumulated radiance
    active: jnp.ndarray  # (N,) bool — lane has a path in flight
    depth: jnp.ndarray  # (N,) i32 — current path's bounce count
    px: jnp.ndarray  # (N,) i32 — pixel column (updated incrementally)
    py: jnp.ndarray  # (N,) i32 — pixel row
    remaining: jnp.ndarray  # (N,) i32 — samples this lane still owes
    sample_k: jnp.ndarray  # (N,) i32 — index of the lane's current sample
    log: jnp.ndarray  # (3, K, N) — per-(sample-slot, lane) retired radiance
    # (channel-major layout: the lane axis is minor, so every masked add
    # and the fold read contiguous lane rows)
    key: jnp.ndarray
    segments: jnp.ndarray  # () i32 — total segments traced (perf metric)
    iters: jnp.ndarray  # () i32 — loop iterations (occupancy metric)


def regen_jump(n: int, n_pixels: int) -> int:
    """Per-regeneration pixel advance for the strided schedule.

    Default: n mod n_pixels — sample t of lane L lands on pixel
    (L + slot*jump) mod n_pixels == t mod n_pixels, i.e. contiguous global
    sample ids sweep pixels, giving exactly spp samples per pixel.

    When n_pixels divides n (e.g. power-of-two images whose pixel count
    divides a power-of-two wavefront — 128x128, 64x64...), that default is ZERO and
    would statically bind lanes to pixels (measured 2.7x more iterations:
    lanes stuck on glass-heavy pixels straggle). In that regime ANY advance
    keeps the schedule exact: per sample-row the active lanes [0, n) cover
    every pixel residue n/n_pixels times, and the final partial row
    [0, total mod n) is a multiple of n_pixels lanes (total and n are both
    multiples of n_pixels), so per-slot shifts cannot skew per-pixel counts.
    Pick a golden-ratio stride for decorrelation."""
    j = n % n_pixels
    if j == 0 and n_pixels > 1:
        j = max(1, int(0.6180339887 * n_pixels)) % n_pixels or 1
    return j


def strided_schedule(n_pixels: int, spp: int, wavefront_size: int):
    """Static layout of the strided per-lane sample queue.

    Lane L owns sample ids L, L+N, L+2N, ... (< n_pixels*spp); returns
    (n, num_slots, jump) where `n` is the wavefront size (capped at the
    sample budget — the closest-hit kernel masks its own tail block, so no
    rounding is needed), `num_slots` the max samples any lane owns, and
    `jump` the per-regeneration pixel advance (regen_jump — guaranteed
    nonzero when a lane owns more than one sample). All python ints (static
    in the compiled loop)."""
    total_samples = n_pixels * spp
    n = min(wavefront_size, total_samples)
    num_slots = -(-total_samples // n)  # ceil: max samples per lane
    return n, num_slots, regen_jump(n, n_pixels)


def schedule_arrays(n: int, n_pixels: int, spp: int, width: int):
    """Per-lane schedule data for `strided_schedule`'s layout: samples owed
    and first pixel. Pure data (devices in a sharded render differ only
    here, never in the compiled program)."""
    total_samples = n_pixels * spp
    lane = jax.lax.broadcasted_iota(jnp.int32, (n, 1), 0)[:, 0]
    # ceil((T-L)/N), clamped: padding lanes beyond the budget own 0 samples.
    init_remaining = jnp.maximum((total_samples - lane + n - 1) // n, 0)
    init_pixel = lane % n_pixels
    return init_remaining.astype(jnp.int32), init_pixel % width, init_pixel // width


def _regen_bounce_epilogue(
    scene,
    resolve_table,
    background,
    sky_gradient,
    max_depth,
    russian_roulette,
    rr_start_depth,
    rr_max_q,
    slot_ids,
    *,
    t_hit,
    prim,
    origin,
    direction,
    uniforms,
    rr_uniform,
    active,
    throughput,
    radiance,
    depth,
    sample_k,
    log,
):
    """Shared post-intersection epilogue of one regen-wavefront iteration:
    resolve+shade, background/emission accumulation (ray.go:41-53), depth
    budget (ray.go:33-35), russian roulette, and retirement into the dense
    per-slot log.

    Returns (origin, direction, throughput, radiance, survives, depth, log).
    """
    from raytracer_tpu.materials.materials import resolve_and_shade

    scat = resolve_and_shade(
        scene, resolve_table, t_hit, prim, origin, direction, uniforms
    )
    if sky_gradient:
        bg = sky_color(direction)
    else:
        bg = jnp.broadcast_to(background, direction.shape)
    miss = active & ~scat.hit
    radiance = radiance + jnp.where(miss[:, None], throughput * bg, 0.0)
    live_hit = active & scat.hit
    radiance = radiance + jnp.where(
        live_hit[:, None], throughput * scat.emitted, 0.0
    )
    survives = live_hit & scat.scattered
    depth = depth + active.astype(jnp.int32)
    survives = survives & (depth < max_depth)  # depth budget (ray.go:33-35)
    throughput = jnp.where(
        survives[:, None], throughput * scat.attenuation, throughput
    )
    if russian_roulette:
        q = jnp.clip(jnp.max(throughput, axis=-1), 0.05, rr_max_q)
        rr_on = survives & (depth >= rr_start_depth)
        survives = survives & (~rr_on | (rr_uniform < q))
        throughput = jnp.where(
            (rr_on & survives)[:, None], throughput / q[:, None], throughput
        )
    origin = jnp.where(survives[:, None], scat.point, origin)
    direction = jnp.where(survives[:, None], scat.direction, direction)

    # ---- retire finished paths into the dense per-slot log ----
    finished = active & ~survives
    slot_mask = (slot_ids == sample_k[None, :]) & finished[None, :]  # (K, N)
    log = log + slot_mask[None, :, :] * radiance.T[:, None, :]
    return origin, direction, throughput, radiance, survives, depth, log


def render_wavefront_regen(
    scene: Scene,
    frame,
    background,
    *,
    width: int,
    height: int,
    spp: int,
    wavefront_size: int,
    key,
    max_depth: int = 50,
    sky_gradient: bool = False,
    russian_roulette: bool = True,
    rr_start_depth: int = 5,
    rr_max_q: float = 0.95,
    intersect=None,
    return_stats: bool = False,
):
    """Render with *path regeneration*: a fixed-size wavefront where a lane
    whose path terminates immediately starts the next camera sample, keeping
    occupancy near 100%.

    Why: the plain batched loop runs until the LAST path dies — at depth 50
    with ~2.9 average segments per path that is ~6% average occupancy
    (measured). Regeneration is the standard wavefront-path-tracing fix
    (SURVEY.md §5 "long-context analog"): total iterations collapse from
    max_depth to ≈ total_segments / wavefront_size + a straggler tail.

    Work distribution is a *strided per-lane sample queue*: lane L owns
    sample ids L, L+N, L+2N, ... (< n_pixels*spp), so there is no global
    counter (no cumsum) and no in-loop integer div/mod — the lane's pixel
    advances by the constant jump N mod n_pixels with add/compare/subtract
    updates. The jumping pixel binding also load-balances per-pixel path
    difficulty across lanes (a fixed lane->pixel binding measured 2.7x more
    loop iterations: lanes stuck on glass-heavy pixels straggle).

    Retirement is scatter-free: sample k of lane L lands in a dense
    (3, K, N) log at [:, k, L] via a masked add (dense and contention-free,
    where a framebuffer scatter-add would collide on shared pixels). Because
    pixel(L, k) = (L + k*N) mod n is affine, the log folds into the
    framebuffer *densely* afterwards: for each slot k, chunk-sum the lane
    axis modulo n and rotate by (k*N) mod n.

    russian_roulette: after `rr_start_depth` bounces, paths survive with
    probability q = clamp(max(throughput), 0.05, 0.95) and are reweighted by
    1/q — an *unbiased* tail trim (the expectation equals the reference's
    depth-capped estimator exactly; only variance changes). Mostly matters
    for dielectric paths whose throughput never attenuates (materials.go:111
    attenuation = (1,1,1)) and would otherwise ride out all 50 bounces.

    The per-lane camera sampling and bounce math are identical to
    trace()/render_pass, so images agree in distribution (same estimator).

    Returns the (height*width, 3) framebuffer of radiance *sums* over spp
    samples per pixel (divide by spp for the mean); with return_stats also
    (segments, iterations).
    """
    n_pixels = width * height
    n, num_slots, _jump = strided_schedule(n_pixels, spp, wavefront_size)
    init_remaining, init_px, init_py = schedule_arrays(n, n_pixels, spp, width)
    return regen_core(
        scene,
        frame,
        background,
        init_remaining,
        init_px,
        init_py,
        key,
        width=width,
        height=height,
        num_slots=num_slots,
        max_depth=max_depth,
        sky_gradient=sky_gradient,
        russian_roulette=russian_roulette,
        rr_start_depth=rr_start_depth,
        rr_max_q=rr_max_q,
        intersect=intersect,
        return_stats=return_stats,
    )


def regen_core(
    scene: Scene,
    frame,
    background,
    init_remaining,
    init_px,
    init_py,
    key,
    *,
    width: int,
    height: int,
    num_slots: int,
    max_depth: int = 50,
    sky_gradient: bool = False,
    russian_roulette: bool = True,
    rr_start_depth: int = 5,
    rr_max_q: float = 0.95,
    intersect=None,
    return_stats: bool = False,
):
    """Run the regenerative wavefront loop over an explicit per-lane schedule
    (`init_remaining`/`init_px`/`init_py` of shape (N,), from
    `schedule_arrays`) and fold the retirement log into a (n_pixels, 3)
    framebuffer of radiance sums.

    `intersect(scene, origin, direction) -> (t, prim)` is the closest-hit
    implementation; None takes the platform's (geometry.backend).

    This is the single-device core; `render_wavefront_regen` wraps it with
    the standard schedule, and `parallel.shard.render_regen_sharded` runs it
    per-device under shard_map (same compiled program on every device —
    devices differ only in schedule *data* and PRNG key)."""
    from raytracer_tpu.core.camera import camera_rays  # local: avoid cycle
    from raytracer_tpu.geometry.backend import intersectors
    from raytracer_tpu.geometry.intersect import quad_derived
    from raytracer_tpu.materials.packed import primitive_resolve_table

    n_pixels = width * height
    n = init_remaining.shape[0]
    closest_hit = intersect or intersectors().closest_hit

    # Strided schedule constants (python ints, static in the loop).
    jump = regen_jump(n, n_pixels)  # pixel advance per regeneration
    jump_px = jump % width
    jump_py = jump // width

    resolve_table = primitive_resolve_table(scene, quad_derived(scene))
    dtype = jnp.float32

    slot_ids = jax.lax.broadcasted_iota(jnp.int32, (num_slots, 1), 0)  # (K,1)
    epilogue = partial(
        _regen_bounce_epilogue,
        scene,
        resolve_table,
        background,
        sky_gradient,
        max_depth,
        russian_roulette,
        rr_start_depth,
        rr_max_q,
        slot_ids,
    )

    def body(s: RegenState) -> RegenState:
        key, k_regen, k_bounce, k_rr = jax.random.split(s.key, 4)

        # ---- regeneration phase: idle lanes owing samples restart ----
        grant = ~s.active & (s.remaining > 0)
        first = s.remaining == init_remaining
        # Advance this lane's pixel by the stride jump (no div/mod).
        px_adv = s.px + jump_px
        py_adv = s.py + jump_py
        carry = px_adv >= width
        px_adv = jnp.where(carry, px_adv - width, px_adv)
        py_adv = jnp.where(carry, py_adv + 1, py_adv)
        wrap = py_adv >= height
        py_adv = jnp.where(wrap, py_adv - height, py_adv)
        px = jnp.where(grant, jnp.where(first, init_px, px_adv), s.px)
        py = jnp.where(grant, jnp.where(first, init_py, py_adv), s.py)
        sample_k = jnp.where(grant, s.sample_k + 1, s.sample_k)

        cam_uni = jax.random.uniform(k_regen, (n, 4), dtype)
        cam_o, cam_d = camera_rays(frame, px, py, cam_uni)
        g3 = grant[:, None]
        origin = jnp.where(g3, cam_o, s.origin)
        direction = jnp.where(g3, cam_d, s.direction)
        throughput = jnp.where(g3, 1.0, s.throughput)
        radiance = jnp.where(g3, 0.0, s.radiance)
        depth = jnp.where(grant, 0, s.depth)
        active = s.active | grant
        remaining = s.remaining - grant.astype(jnp.int32)

        # ---- one bounce (identical math to _bounce_step, fused path) ----
        t_hit, prim = closest_hit(scene, origin, direction)
        uniforms = jax.random.uniform(k_bounce, (n, UNIFORMS_PER_BOUNCE), dtype)
        rr_uni = jax.random.uniform(k_rr, (n,), dtype)
        origin, direction, throughput, radiance, survives, depth, log = epilogue(
            t_hit=t_hit,
            prim=prim,
            origin=origin,
            direction=direction,
            uniforms=uniforms,
            rr_uniform=rr_uni,
            active=active,
            throughput=throughput,
            radiance=radiance,
            depth=depth,
            sample_k=sample_k,
            log=s.log,
        )
        return RegenState(
            origin=origin,
            direction=direction,
            throughput=throughput,
            radiance=radiance,
            active=survives,
            depth=depth,
            px=px,
            py=py,
            remaining=remaining,
            sample_k=sample_k,
            log=log,
            key=key,
            segments=s.segments + jnp.sum(active.astype(jnp.int32)),
            iters=s.iters + 1,
        )

    init = RegenState(
        origin=jnp.zeros((n, 3), dtype),
        direction=jnp.ones((n, 3), dtype),
        throughput=jnp.ones((n, 3), dtype),
        radiance=jnp.zeros((n, 3), dtype),
        active=jnp.zeros((n,), bool),
        depth=jnp.zeros((n,), jnp.int32),
        px=init_px,
        py=init_py,
        remaining=init_remaining.astype(jnp.int32),
        sample_k=jnp.full((n,), -1, jnp.int32),
        log=jnp.zeros((3, num_slots, n), dtype),
        key=key,
        segments=jnp.int32(0),
        iters=jnp.int32(0),
    )
    final = jax.lax.while_loop(
        lambda s: jnp.any(s.active | (s.remaining > 0)),
        body,
        init,
    )
    return _fold_log(
        final.log, num_slots, n, n_pixels, jump,
        final.segments, final.iters, return_stats,
    )


def _fold_log(log, num_slots, n, n_pixels, jump, segments, iters, return_stats):
    """Fold the dense (3, K, N) retirement log into the framebuffer.

    Slot k, lane L -> pixel (L + k*jump) mod n_pixels (jump from regen_jump,
    matching the kernel's per-regeneration advance): chunk-sum lanes modulo
    n_pixels, then rotate by the slot's constant offset (all dense — no
    scatter; see render_wavefront_regen docstring)."""
    chunks = -(-n // n_pixels)
    pad = chunks * n_pixels - n
    log = jnp.pad(log, ((0, 0), (0, 0), (0, pad)))
    per_slot = log.reshape(3, num_slots, chunks, n_pixels).sum(axis=2)  # (3,K,n)
    fb = jnp.zeros((n_pixels, 3), log.dtype)
    for k in range(num_slots):
        offset = (k * jump) % n_pixels
        fb = fb + jnp.roll(per_slot[:, k, :].T, offset, axis=0)
    if return_stats:
        return fb, segments, iters
    return fb
