"""Packed per-primitive shading table: one gather per bounce.

Each irregular (N,)-indexed gather at wavefront sizes is a separate pass
over device memory, and the naive shading path needed ~10 of them
(mat_type/fuzz/ior/albedo/tex_type/...). Instead we
resolve the reference's two-level indirection (primitive -> Material ->
Texture, materials.go:9-17/147-149) into a single (P, COLS) f32 row per
primitive at trace setup, and the shade kernel does ONE row gather by the
winning prim_id. Row construction is jit-traced gathers over the small
material/texture tables (hundreds of rows — negligible), and is fully
differentiable back to mat_albedo / tex_c0 / fuzz / ior leaves.
"""

from __future__ import annotations

import jax.numpy as jnp

from raytracer_tpu.geometry.scene import METAL, Scene, TEX_SOLID

# Column layout of the packed table.
COL_MTYPE = 0  # material type enum (as float)
COL_FUZZ = 1
COL_IOR = 2
COL_C0 = slice(3, 6)  # base color: metal flat albedo / solid color / checker even
COL_C1 = slice(6, 9)  # checker odd color
COL_TTYPE = 9  # texture type enum (as float; SOLID forced for metals)
COL_TSCALE = 10  # checker / noise scale
COL_TIMAGE = 11  # image index (as float)
N_COLS = 12

# Geometry columns of the *resolve* table (primitive_resolve_table): the hit
# epilogue (point/normal/uv) reads these from the same single row gather
# instead of separate sph_center/quad-derived gathers per bounce.
COL_SPH_CENTER = slice(12, 15)  # sphere center (zeros for quads)
COL_SPH_RADIUS = 15  # signed radius (hollow-glass negative)
COL_Q_NORMAL = slice(16, 19)  # quad unit plane normal
COL_Q_AV = slice(19, 22)  # alpha basis vector (v × w)
COL_Q_BV = slice(22, 25)  # beta basis vector (w × u)
COL_Q_QAV = 25  # Q·av
COL_Q_QBV = 26  # Q·bv
N_RESOLVE_COLS = 27


def primitive_shading_table(scene: Scene) -> jnp.ndarray:
    """(S+Q, N_COLS) f32 table, spheres first then quads (matching
    HitRecord.prim_id numbering in geometry/intersect.py)."""
    mat_id = jnp.concatenate([scene.sph_mat, scene.quad_mat])  # (P,)
    mtype = scene.mat_type[mat_id]
    tex_id = scene.mat_tex[mat_id]
    ttype = scene.tex_type[tex_id]
    is_metal = mtype == METAL
    base_color = jnp.where(
        is_metal[:, None], scene.mat_albedo[mat_id], scene.tex_c0[tex_id]
    )
    ttype_eff = jnp.where(is_metal, TEX_SOLID, ttype)
    cols = [
        mtype.astype(jnp.float32)[:, None],
        scene.mat_fuzz[mat_id][:, None],
        scene.mat_ior[mat_id][:, None],
        base_color,
        scene.tex_c1[tex_id],
        ttype_eff.astype(jnp.float32)[:, None],
        scene.tex_scale[tex_id][:, None],
        scene.tex_image[tex_id].astype(jnp.float32)[:, None],
    ]
    return jnp.concatenate(cols, axis=1)


def primitive_resolve_table(scene: Scene, qd) -> jnp.ndarray:
    """(S+Q, N_RESOLVE_COLS): shading columns + the geometry needed by the
    hit epilogue, so intersect->shade does exactly ONE table gather per
    bounce. `qd` is geometry.intersect.quad_derived(scene)."""
    s = scene.num_spheres
    q = scene.num_quads
    shading = primitive_shading_table(scene)  # (S+Q, N_COLS)
    zero_s = jnp.zeros((s, 1), jnp.float32)
    zero_q = jnp.zeros((q, 1), jnp.float32)
    geom = jnp.concatenate(
        [
            jnp.concatenate([scene.sph_center, jnp.zeros((q, 3))], axis=0),
            jnp.concatenate([scene.sph_radius[:, None], zero_q], axis=0),
            jnp.concatenate([jnp.zeros((s, 3)), qd.normal], axis=0),
            jnp.concatenate([jnp.zeros((s, 3)), qd.av], axis=0),
            jnp.concatenate([jnp.zeros((s, 3)), qd.bv], axis=0),
            jnp.concatenate([zero_s, qd.q_av[:, None]], axis=0),
            jnp.concatenate([zero_s, qd.q_bv[:, None]], axis=0),
        ],
        axis=1,
    )
    return jnp.concatenate([shading, geom], axis=1)
