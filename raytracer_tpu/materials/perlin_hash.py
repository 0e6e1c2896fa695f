"""Procedural (hash-generated) Perlin tables: gather-free noise.

7-octave turbulence does 98 tiny-table gathers per lane per bounce when the
tables are gathered. Instead of *gathering* from randomly-filled tables,
the scene's Perlin tables are GENERATED by cheap integer hash functions;
the hot path then recomputes table entries with pure elementwise integer
math (zero gathers), while the table arrays remain on the
Scene so the scalar NumPy oracle and the table-gather path produce
bit-identical results.

The reference algorithm (materials.go:195-262) is unchanged: three per-axis
permutation tables XOR-combined into a gradient index, 256 gradient vectors
with components U[-1,1). The reference fills those tables from wall-clock
rand (its renders are unreproducible run to run; BASELINE.md); hash-filled
tables are one deterministic draw from the same family.

Every function here is generic over NumPy and jax.numpy uint32 arrays (plain
operators + Python int constants only), so `build_tables()` (NumPy, host)
and the in-trace recomputation (jnp, device) share one definition — the
bit-exact-equality test in tests/test_textures.py rests on that.
"""

from __future__ import annotations

import numpy as np

# Per-axis odd multipliers for the 8-bit permutation mixes. Odd multiplies
# mod 256 and x ^= x >> 4 are both bijective on 8 bits, so each axis table
# is a true permutation of 0..255 (like rng.permutation before it).
_AXIS_MUL1 = (167, 139, 101)
_AXIS_MUL2 = (91, 197, 213)
_AXIS_ADD = (11, 157, 223)

# Stream constants for the three gradient components (splitmix/murmur-style).
_GRAD_SEED = (0x68E31DA4, 0xB5297A4D, 0x1B56C4E9)


def perm_u8(axis: int, x):
    """Permutation value for lattice coordinate x (uint32 array, any shape).

    Bijective on the low 8 bits; the result is in [0, 256). Replaces
    rng.permutation as the content of scene.perlin_p{x,y,z}[x & 255]."""
    u32 = np.uint32
    m1, m2 = u32(_AXIS_MUL1[axis]), u32(_AXIS_MUL2[axis])
    h = (x * m1 + u32(_AXIS_ADD[axis])) & u32(255)
    h = h ^ (h >> u32(4))
    h = (h * m2) & u32(255)
    h = h ^ (h >> u32(4))
    return h


def _mix32(u):
    """Wang-style 32-bit avalanche mix (uint32 in, uint32 out)."""
    u32 = np.uint32
    u = (u ^ u32(61)) ^ (u >> u32(16))
    u = u * u32(9)
    u = u ^ (u >> u32(4))
    u = u * u32(0x27D4EB2D)
    u = u ^ (u >> u32(15))
    return u


def grad_component(k: int, h):
    """Component k (0..2) of gradient vector h (uint32 in [0,256)) in [-1,1).

    The low 24 bits of the mix convert exactly to float32, so NumPy and XLA
    agree bit-for-bit."""
    u32 = np.uint32
    u = _mix32((h + u32(((k + 1) * 0x9E3779B9) & 0xFFFFFFFF)) ^ u32(_GRAD_SEED[k]))
    return (u & u32(0xFFFFFF)).astype("float32") * np.float32(2.0 ** -23) - np.float32(1.0)


def build_tables():
    """Host-side table materialization: (vec (256,3) f32, px, py, pz (256,) i32).

    Same distribution role as the reference's rand-filled tables
    (materials.go:202-216); contents are exactly what the procedural device
    path recomputes."""
    x = np.arange(256, dtype=np.uint32)
    px = perm_u8(0, x).astype(np.int32)
    py = perm_u8(1, x).astype(np.int32)
    pz = perm_u8(2, x).astype(np.int32)
    vec = np.stack([grad_component(k, x) for k in range(3)], axis=-1)
    return vec.astype(np.float32), px, py, pz
