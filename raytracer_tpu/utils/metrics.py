"""Observability: structured render metrics + profiler hooks.

The reference's only observability is a per-scanline Printf and a final
duration print (camera.go:203, main.go:77; SURVEY.md §5). Here: structured
progress (tiles/spp done, rays/s), `jax.profiler` trace capture (TensorBoard
compatible), and a Mrays/s counter based on actually-traced segments.
"""

from __future__ import annotations

import contextlib
import json
import time
from dataclasses import dataclass, field


@dataclass
class RenderMetrics:
    """Accumulates render progress; print or export as JSON lines.

    The driver updates `done_spp` per chunk (cheap, no device sync) and adds
    traced-segment / iteration counts once at the end of the render (one
    sync), so observability never serializes the async chunk pipeline."""

    total_spp: int
    pixels: int
    wavefront_lanes: int = 0  # lanes per regen wavefront (occupancy basis)
    retirement_log_mb: float = 0.0  # (3, K, N) f32 log — the active HBM constraint
    start_time: float = field(default_factory=time.perf_counter)
    done_spp: int = 0
    traced_segments: int = 0
    wavefront_iters: int = 0

    def update(self, spp_done: int, segments: int = 0, iters: int = 0):
        self.done_spp = spp_done
        self.traced_segments += int(segments)
        self.wavefront_iters += int(iters)

    @property
    def elapsed(self) -> float:
        return time.perf_counter() - self.start_time

    def snapshot(self) -> dict:
        dt = max(self.elapsed, 1e-9)
        out = {
            "spp": f"{self.done_spp}/{self.total_spp}",
            "wall_s": round(dt, 3),
            "camera_mrays_per_s": round(self.pixels * self.done_spp / dt / 1e6, 3),
        }
        if self.traced_segments:
            out["traced_mrays_per_s"] = round(self.traced_segments / dt / 1e6, 3)
        if self.wavefront_iters:
            out["wavefront_iters"] = self.wavefront_iters
            if self.wavefront_lanes and self.traced_segments:
                out["occupancy"] = round(
                    self.traced_segments
                    / (self.wavefront_iters * self.wavefront_lanes),
                    3,
                )
        if self.retirement_log_mb:
            out["retirement_log_mb"] = round(self.retirement_log_mb, 1)
        return out

    def log(self) -> None:
        print(json.dumps(self.snapshot()), flush=True)


def device_memory_stats() -> dict:
    """Device memory usage: backend counters when the runtime exposes them
    (peak/current/limit device memory; the CPU backend has none), plus the
    live-buffer total from jax.live_arrays(). The analog of the reference's
    heap profile write (main.go:70-73)."""
    import jax

    stats = jax.local_devices()[0].memory_stats() or {}
    out = {}
    if "peak_bytes_in_use" in stats:
        out["peak_hbm_mb"] = round(stats["peak_bytes_in_use"] / 2**20, 1)
    if "bytes_in_use" in stats:
        out["hbm_in_use_mb"] = round(stats["bytes_in_use"] / 2**20, 1)
    if "bytes_limit" in stats:
        out["hbm_limit_mb"] = round(stats["bytes_limit"] / 2**20, 1)
    live = sum(a.nbytes for a in jax.live_arrays())
    out["live_buffers_mb"] = round(live / 2**20, 1)
    return out


def save_memory_profile(path: str) -> None:
    """Write a device memory profile: every live device buffer with shape,
    dtype, and size, largest first, as JSON. Built from jax.live_arrays()
    rather than the pprof-format jax.profiler.save_device_memory_profile so
    the report is plain JSON on every backend."""
    import jax

    buffers = [
        {
            "shape": list(a.shape),
            "dtype": str(a.dtype),
            "mb": round(a.nbytes / 2**20, 3),
            "sharding": type(a.sharding).__name__,
        }
        for a in jax.live_arrays()
    ]
    buffers.sort(key=lambda b: -b["mb"])
    report = {
        "total_mb": round(sum(b["mb"] for b in buffers), 1),
        "num_buffers": len(buffers),
        "device": str(jax.local_devices()[0].device_kind),
        "buffers": buffers[:200],
        **device_memory_stats(),
    }
    with open(path, "w") as f:
        json.dump(report, f, indent=1)


@contextlib.contextmanager
def profiler_trace(log_dir: str | None):
    """Capture a jax.profiler trace around the block when log_dir is set
    (view with TensorBoard). Replacement for the reference's pprof span
    (main.go:52-73)."""
    if not log_dir:
        yield
        return
    import jax

    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()
