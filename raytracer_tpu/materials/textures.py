"""Texture evaluation: solid / checker / image / Perlin-noise, fully batched.

Replaces the reference's `Texture` interface dispatch (materials.go:147-149)
with a type-enum select: every texture kind present in the scene is evaluated
for the whole batch and the per-lane result chosen by `tex_type` masks.
Static scene flags (`has_image`, `has_noise`, `has_checker`) gate the
optional kinds at trace time so scenes without them pay nothing.
"""

from __future__ import annotations

import jax.numpy as jnp

from raytracer_tpu.geometry.scene import (
    Scene,
    TEX_CHECKER,
    TEX_IMAGE,
    TEX_NOISE,
)


def _smoothstep(t):
    """materials.go:218-220."""
    return t * t * (3.0 - 2.0 * t)


def perlin_noise(scene: Scene, p):
    """Gradient-noise value at points `p` (N, 3). Reference: Perlin.Noise
    (materials.go:222-249): lattice gradients via permX[x]^permY[y]^permZ[z]
    indexing, dot products with corner offsets, trilinear blend of
    smoothstep-faded weights.

    Two evaluation strategies, bit-identical results:
    * scene.perlin_procedural (the production default): table entries are
      RECOMPUTED per lane with integer hashes (materials/perlin_hash.py) —
      zero gathers (7 octaves x 8 corners would otherwise be 56+ tiny-table
      gathers per lane per bounce).
    * otherwise: 8 gathers over the (256, 3) gradient table (works for any
      table contents, e.g. the reference's rand-filled ones).
    """
    pf = jnp.floor(p)
    t = p - pf  # (N, 3) fractional offsets
    pi = pf.astype(jnp.int32)
    i0 = pi & 255  # (N, 3)
    i1 = (i0 + 1) & 255

    if scene.perlin_procedural:
        from raytracer_tpu.materials import perlin_hash as ph

        u0 = i0.astype(jnp.uint32)
        u1 = i1.astype(jnp.uint32)
        px = (ph.perm_u8(0, u0[:, 0]), ph.perm_u8(0, u1[:, 0]))
        py = (ph.perm_u8(1, u0[:, 1]), ph.perm_u8(1, u1[:, 1]))
        pz = (ph.perm_u8(2, u0[:, 2]), ph.perm_u8(2, u1[:, 2]))

        def gradient(h):  # (N,) uint32 -> (gx, gy, gz) f32, no memory access
            return tuple(ph.grad_component(k, h) for k in range(3))

    else:
        px = (scene.perlin_px[i0[:, 0]], scene.perlin_px[i1[:, 0]])
        py = (scene.perlin_py[i0[:, 1]], scene.perlin_py[i1[:, 1]])
        pz = (scene.perlin_pz[i0[:, 2]], scene.perlin_pz[i1[:, 2]])

        def gradient(h):
            g = scene.perlin_vec[h]  # (N, 3)
            return g[:, 0], g[:, 1], g[:, 2]

    tx, ty, tz = t[:, 0], t[:, 1], t[:, 2]
    fx, fy, fz = _smoothstep(tx), _smoothstep(ty), _smoothstep(tz)

    def corner(ix, iy, iz):
        gx, gy, gz = gradient(px[ix] ^ py[iy] ^ pz[iz])
        return gx * (tx - ix) + gy * (ty - iy) + gz * (tz - iz)

    # Trilinear blend (math.go:84-92 TriLinearLerp with smoothstep weights).
    c00 = c_lerp(fx, corner(0, 0, 0), corner(1, 0, 0))
    c10 = c_lerp(fx, corner(0, 1, 0), corner(1, 1, 0))
    c01 = c_lerp(fx, corner(0, 0, 1), corner(1, 0, 1))
    c11 = c_lerp(fx, corner(0, 1, 1), corner(1, 1, 1))
    c0 = c_lerp(fy, c00, c10)
    c1 = c_lerp(fy, c01, c11)
    return c_lerp(fz, c0, c1)


def c_lerp(t, a, b):
    return a * (1.0 - t) + b * t


def perlin_turbulence(scene: Scene, p, depth: int = 7):
    """|sum of 7 halving octaves|. Reference: Perlin.Turb (materials.go:251-262)."""
    total = jnp.zeros(p.shape[:-1], p.dtype)
    weight = 1.0
    pp = p
    for _ in range(depth):
        total = total + weight * perlin_noise(scene, pp)
        weight *= 0.5
        pp = pp * 2.0
    return jnp.abs(total)


def _image_lookup(scene: Scene, img_id, u, v):
    """Nearest-neighbor image texture fetch. Reference: ImageTexture.GetTexture
    (materials.go:176-193): clamp u, flip v, truncate to pixel indices.
    We clamp the indices into range (the reference indexes out of bounds at
    u == 1 and Go's image.At returns zero there — converged-image tolerance
    absorbs that single-texel edge)."""
    dims = scene.image_dims[img_id]  # (N, 2) true (H, W)
    h = dims[:, 0].astype(jnp.float32)
    w = dims[:, 1].astype(jnp.float32)
    uu = jnp.clip(u, 0.0, 1.0)
    vv = 1.0 - jnp.clip(v, 0.0, 1.0)
    i = jnp.clip((uu * w).astype(jnp.int32), 0, dims[:, 1] - 1)
    j = jnp.clip((vv * h).astype(jnp.int32), 0, dims[:, 0] - 1)
    return scene.images[img_id, j, i]  # (N, 3)


def _image_lookup_bilinear(scene: Scene, img_id, u, v):
    """Bilinear variant (BASELINE.md asks for a bilinear upgrade; the
    reference is nearest-neighbor)."""
    dims = scene.image_dims[img_id]
    h = dims[:, 0].astype(jnp.float32)
    w = dims[:, 1].astype(jnp.float32)
    uu = jnp.clip(u, 0.0, 1.0)
    vv = 1.0 - jnp.clip(v, 0.0, 1.0)
    x = uu * w - 0.5
    y = vv * h - 0.5
    x0 = jnp.floor(x)
    y0 = jnp.floor(y)
    fx = (x - x0)[..., None]
    fy = (y - y0)[..., None]

    def at(xi, yi):
        xi = jnp.clip(xi.astype(jnp.int32), 0, dims[:, 1] - 1)
        yi = jnp.clip(yi.astype(jnp.int32), 0, dims[:, 0] - 1)
        return scene.images[img_id, yi, xi]

    top = at(x0, y0) * (1 - fx) + at(x0 + 1, y0) * fx
    bot = at(x0, y0 + 1) * (1 - fx) + at(x0 + 1, y0 + 1) * fx
    return top * (1 - fy) + bot * fy


def eval_texture_packed(
    scene: Scene, ttype, c0, c1, scale, img_id, u, v, point, *, bilinear: bool = False
):
    """Evaluate texture color for each lane from *pre-gathered* per-lane
    fields (see materials/packed.py — avoids one table gather per field).

    Args:
      ttype: (N,) texture type enum (float or int).
      c0, c1: (N, 3) solid/checker colors.
      scale: (N,) checker/noise scale.
      img_id: (N,) image index (float or int).
      u, v: (N,) surface coordinates.
      point: (N, 3) world-space hit points (checker/noise are solid textures
        over the hit point, materials.go:127-137 / 285-288).

    Returns (N, 3) colors. Dispatch via masked selects on ttype; the static
    scene.has_* flags skip kinds not present in the scene.
    """
    ttype = ttype.astype(jnp.int32)
    color = c0  # solid color (materials.go:157-159)

    if scene.has_checker:
        # materials.go:127-137: parity of summed floor(point / scale).
        inv_scale = 1.0 / scale[..., None]
        ipt = jnp.floor(inv_scale * point).astype(jnp.int32)
        parity = (ipt[:, 0] + ipt[:, 1] + ipt[:, 2]) % 2
        checker = jnp.where((parity == 0)[..., None], c0, c1)
        color = jnp.where((ttype == TEX_CHECKER)[..., None], checker, color)

    if scene.has_image:
        iid = img_id.astype(jnp.int32)
        img = (
            _image_lookup_bilinear(scene, iid, u, v)
            if (bilinear or scene.bilinear_textures)
            else _image_lookup(scene, iid, u, v)
        )
        color = jnp.where((ttype == TEX_IMAGE)[..., None], img, color)

    if scene.has_noise:
        # materials.go:285-288: marble — scale the point, then
        # 0.5 * (1 + sin(z + 10 * turb(p, 7))).
        sp = point * scale[..., None]
        turb = perlin_turbulence(scene, sp, depth=7)
        val = 0.5 * (1.0 + jnp.sin(sp[:, 2] + 10.0 * turb))
        noise_col = jnp.broadcast_to(val[..., None], point.shape)
        color = jnp.where((ttype == TEX_NOISE)[..., None], noise_col, color)

    return color


def eval_texture(scene: Scene, tex_id, u, v, point, *, bilinear: bool = False):
    """Texture evaluation addressed by texture id (gathers each field; use
    eval_texture_packed on hot paths)."""
    return eval_texture_packed(
        scene,
        scene.tex_type[tex_id],
        scene.tex_c0[tex_id],
        scene.tex_c1[tex_id],
        scene.tex_scale[tex_id],
        scene.tex_image[tex_id],
        u,
        v,
        point,
        bilinear=bilinear,
    )
