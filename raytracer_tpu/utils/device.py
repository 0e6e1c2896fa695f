"""The device a measurement ran on, as JAX and the driver report it."""

from __future__ import annotations

import subprocess

import jax


def require_gpu() -> dict:
    """{platform, kind, count} of JAX's devices; raises SystemExit unless
    the first device is a GPU (a measurement path never falls back to the
    CPU)."""
    devs = jax.devices()
    if devs[0].platform != "gpu":
        raise SystemExit(
            f"no GPU: JAX's first device is {devs[0].platform!r}; this "
            "command measures the GPU and refuses to run elsewhere"
        )
    return {"platform": devs[0].platform, "kind": devs[0].device_kind, "count": len(devs)}


def card_name_and_power_limit() -> str:
    """`nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`, one
    line per card, from a child process that stays off JAX."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True,
        capture_output=True,
        text=True,
        timeout=60,
    )
    return out.stdout.strip()
