"""Checkpoint/resume for long renders and inverse-rendering runs.

The reference has no resume story — a render runs start-to-finish and the
output file is truncated up front (file.go:9-18, main.go:43; SURVEY.md §5).
Here the accumulated per-pixel radiance *sums* + the completed-spp counter
are a natural checkpoint: chunk keys are derived deterministically from
(seed, chunk index), so a resumed render is bit-identical to an
uninterrupted one (tested). Failure handling is fail-stop + resume: rerun
the driver with the same checkpoint path and it continues from the last
completed chunk.
"""

from __future__ import annotations

import hashlib
import os
from typing import NamedTuple

import numpy as np
import jax
import jax.numpy as jnp

from raytracer_tpu.core.camera import Camera, RenderSettings
from raytracer_tpu.geometry.scene import Scene
from raytracer_tpu.render.driver import render_regen

CHECKPOINT_VERSION = 2


def config_fingerprint(
    scene, cam, settings, spp_per_chunk: int, seed: int, extra: tuple = ()
) -> str:
    """Hash of everything that determines the accumulated image: scene and
    camera leaves AND treedef (the treedef carries the static Scene fields —
    bilinear_textures, procedural perlin — whose toggling also changes the
    image), render settings, the chunk size the schedule actually uses, the
    seed, and `extra` (wavefront size + backend flags: they change the
    lane-to-sample assignment and hence the per-sample RNG stream, breaking
    the bit-identical-resume guarantee if they differ). Resuming under a
    different configuration would silently blend inconsistent accumulations
    or reuse chunk PRNG keys, so load refuses on mismatch."""
    h = hashlib.sha256()
    leaves, treedef = jax.tree_util.tree_flatten((scene, cam))
    h.update(str(treedef).encode())
    for leaf in leaves:
        arr = np.asarray(leaf)
        h.update(str(arr.dtype).encode())
        h.update(str(arr.shape).encode())
        h.update(arr.tobytes())
    h.update(repr(tuple(settings)).encode())
    h.update(str(int(spp_per_chunk)).encode())
    h.update(str(int(seed)).encode())
    h.update(repr(extra).encode())
    return h.hexdigest()


class RenderCheckpoint(NamedTuple):
    acc: np.ndarray  # (H, W, 3) radiance sums over completed samples
    done_spp: int
    seed: int
    chunk_idx: int = 0  # next chunk to run (persisted, not recomputed)
    config_hash: str = ""  # config_fingerprint at save time


def save_checkpoint(path: str, ckpt: RenderCheckpoint) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = path + ".tmp"
    np.savez(
        tmp,
        version=CHECKPOINT_VERSION,
        acc=np.asarray(ckpt.acc),
        done_spp=ckpt.done_spp,
        seed=ckpt.seed,
        chunk_idx=ckpt.chunk_idx,
        config_hash=np.array(ckpt.config_hash),
    )
    os.replace(tmp + ".npz", path)


def load_checkpoint(path: str) -> RenderCheckpoint | None:
    if not os.path.exists(path):
        return None
    with np.load(path) as z:
        if int(z["version"]) != CHECKPOINT_VERSION:
            # Refuse loudly: returning None would silently restart from
            # 0 spp and the first chunk save would clobber the old file.
            raise ValueError(
                f"checkpoint {path} has version {int(z['version'])}, this "
                f"build writes {CHECKPOINT_VERSION}; finish it with the old "
                "build or delete it to restart"
            )
        return RenderCheckpoint(
            acc=z["acc"],
            done_spp=int(z["done_spp"]),
            seed=int(z["seed"]),
            chunk_idx=int(z["chunk_idx"]),
            config_hash=str(z["config_hash"]),
        )


class BackgroundSaver:
    """One worker thread writing checkpoints off the dispatch loop
    (compute/IO overlap — reference analog: camera.go:224-252 pipelines
    rendering with ordered chunk writing). A newer checkpoint supersedes a
    queued older one (cancel-if-not-started), so at most one save runs and
    one waits — bounds pinned accumulator copies. close() drains the queue
    and surfaces any save error. Shared by the single-device and sharded
    renderers so the overlap/backpressure rules cannot drift."""

    def __init__(self, path: str):
        import concurrent.futures

        self._path = path
        self._pool = concurrent.futures.ThreadPoolExecutor(max_workers=1)
        self._futures: list = []

    def submit(self, ckpt: RenderCheckpoint) -> None:
        if self._futures and self._futures[-1].cancel():
            self._futures.pop()
        self._futures.append(
            self._pool.submit(save_checkpoint, self._path, ckpt)
        )

    def wait(self) -> None:
        """Drain the queue (call from `finally` — never raises, so a render
        error in flight is not masked by a save error)."""
        self._pool.shutdown(wait=True)

    def raise_errors(self) -> None:
        """Surface any save error (call after the render loop succeeded)."""
        for f in self._futures:
            if not f.cancelled():
                f.result()


def render_with_checkpoints(
    scene: Scene,
    cam: Camera,
    settings: RenderSettings,
    *,
    seed: int = 0,
    checkpoint_path: str | None = None,
    spp_per_chunk: int | None = None,
    target_rays_per_pass: int = 1 << 20,
    max_chunks: int | None = None,
    progress: bool = False,
):
    """Render with periodic checkpoints; returns linear mean radiance
    (H, W, 3) (possibly partial if max_chunks stopped it early).

    Deterministic: chunk c always uses key fold_in(PRNGKey(seed), c), so
    resuming reproduces the exact uninterrupted image.
    """
    w, h, spp = settings.width, settings.height, settings.samples_per_pixel
    n = w * h
    wavefront = int(min(max(n, 1 << 16), target_rays_per_pass))
    if spp_per_chunk is None:
        # Prefer a divisor of spp: a trailing short chunk is a different
        # static spp for the jitted program — a second compile (same
        # rationale as render_image's divisor search).
        cap = max(1, min(spp, (64 * wavefront) // max(1, n)))
        spp_per_chunk = next((k for k in range(cap, 0, -1) if spp % k == 0), cap)

    fingerprint = config_fingerprint(
        scene, cam, settings, spp_per_chunk, seed,
        # The platform picks the closest-hit implementation, whose t can
        # differ in the last bits: a checkpoint resumes on its own platform.
        extra=(wavefront, jax.default_backend()),
    )
    done, acc, chunk_idx = 0, jnp.zeros((h, w, 3), jnp.float32), 0
    if checkpoint_path:
        ck = load_checkpoint(checkpoint_path)
        if ck is not None:
            if ck.config_hash != fingerprint:
                raise ValueError(
                    f"checkpoint {checkpoint_path} was written under a "
                    "different scene/camera/settings/chunking configuration; "
                    "refusing to resume (delete it to restart)"
                )
            done, acc, chunk_idx = ck.done_spp, jnp.asarray(ck.acc), ck.chunk_idx
            if progress:
                print(f"resumed at {done}/{spp} spp", flush=True)

    key = jax.random.PRNGKey(seed)
    chunks_run = 0
    # Checkpoint writes — a device->host fetch + npz save — run on the
    # BackgroundSaver worker, so neither the fetch DMA nor the host encode
    # blocks the dispatch loop. Fail-stop mid-chunk loses at most the last
    # chunk's save, which resume re-renders.
    saver = BackgroundSaver(checkpoint_path) if checkpoint_path else None
    try:
        while done < spp:
            if max_chunks is not None and chunks_run >= max_chunks:
                break
            step_spp = min(spp_per_chunk, spp - done)
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
            )
            acc = acc + out * jnp.float32(step_spp)
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
            if progress:
                print(f"spp {done}/{spp}", flush=True)
    finally:
        if saver is not None:
            saver.wait()
    if saver is not None:
        saver.raise_errors()

    return acc / jnp.float32(max(done, 1))
