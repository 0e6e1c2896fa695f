"""Scene representation: structure-of-arrays tables on device.

Replaces the reference's `World` (a Go slice of `Hittable` interface values,
/root/reference/internal/hittables.go:39-76) and its `Material`/`Texture`
interface dispatch (materials.go:9-17, 147-149) with flat, statically-shaped
tables — the idiomatic accelerator encoding: geometry is `(S,3)`/`(Q,3)` arrays,
materials a type-enum + packed-parameter table, textures likewise. All
dispatch happens as masked selects in the shading kernel.

`SceneBuilder` is the host-side construction API (the analog of the scene
set-up code in main.go:80-289); `Scene` is the device pytree. Scene geometry
and material parameters are differentiable leaves — gradients flow to sphere
centers/radii, quad corners, albedos, fuzz and IOR.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp

# Material type enum (reference: concrete Material impls, materials.go).
LAMBERTIAN = 0  # materials.go:19-42
METAL = 1  # materials.go:44-75
DIELECTRIC = 2  # materials.go:77-119
DIFFUSE_LIGHT = 3  # materials.go:297-313

# Texture type enum (reference: concrete Texture impls, materials.go).
TEX_SOLID = 0  # materials.go:151-163
TEX_CHECKER = 1  # materials.go:121-145
TEX_IMAGE = 2  # materials.go:165-193
TEX_NOISE = 3  # materials.go:264-295

PERLIN_POINT_COUNT = 256  # materials.go:203


def _static(default=False):
    """A dataclass field that is pytree metadata (static), not a leaf."""
    return dataclasses.field(default=default, metadata={"static": True})


def _pytree_dataclass(cls):
    """Frozen dataclass registered as a pytree: fields made with `_static`
    are metadata, every other field is a leaf. `replace(**changes)` returns
    a copy with those fields swapped."""
    cls = dataclasses.dataclass(frozen=True)(cls)
    fields = dataclasses.fields(cls)
    jax.tree_util.register_dataclass(
        cls,
        data_fields=[f.name for f in fields if not f.metadata.get("static")],
        meta_fields=[f.name for f in fields if f.metadata.get("static")],
    )
    cls.replace = dataclasses.replace
    return cls


@_pytree_dataclass
class Scene:
    """Device-side scene tables. Array fields are pytree leaves
    (differentiable); `has_*` fields are static and gate optional work."""

    # Spheres (hittables.go:78-136). A padded/dummy sphere has radius == 0.
    sph_center: jnp.ndarray  # (S, 3) f32
    sph_radius: jnp.ndarray  # (S,) f32  (negative = hollow-glass trick)
    sph_mat: jnp.ndarray  # (S,) i32

    # Quads (hittables.go:138-198). A dummy quad has u = v = 0 (degenerate
    # normal -> the |n.d| < 1e-8 test rejects it, matching hittables.go:169-171).
    quad_q: jnp.ndarray  # (Q, 3) f32
    quad_u: jnp.ndarray  # (Q, 3) f32
    quad_v: jnp.ndarray  # (Q, 3) f32
    quad_mat: jnp.ndarray  # (Q,) i32

    # Material table (materials.go:9-12 interface -> enum + params).
    mat_type: jnp.ndarray  # (M,) i32
    mat_albedo: jnp.ndarray  # (M, 3) f32 — Metal's flat albedo (materials.go:45)
    mat_fuzz: jnp.ndarray  # (M,) f32
    mat_ior: jnp.ndarray  # (M,) f32
    mat_tex: jnp.ndarray  # (M,) i32 — texture id for Lambertian/DiffuseLight

    # Texture table (materials.go:147-149 interface -> enum + params).
    tex_type: jnp.ndarray  # (T,) i32
    tex_c0: jnp.ndarray  # (T, 3) f32 — solid color / checker even
    tex_c1: jnp.ndarray  # (T, 3) f32 — checker odd
    tex_scale: jnp.ndarray  # (T,) f32 — checker / noise scale
    tex_image: jnp.ndarray  # (T,) i32 — index into `images`

    # Image textures, padded to a common (H, W): (I, H, W, 3) f32 in [0, 1].
    images: jnp.ndarray
    image_dims: jnp.ndarray  # (I, 2) i32 — true (H, W) of each image

    # Perlin tables (materials.go:195-216).
    perlin_vec: jnp.ndarray  # (256, 3) f32, components U[-1, 1)
    perlin_px: jnp.ndarray  # (256,) i32 permutation
    perlin_py: jnp.ndarray  # (256,) i32
    perlin_pz: jnp.ndarray  # (256,) i32

    # Static flags (not traced) gating optional texture machinery.
    has_image: bool = _static()
    has_noise: bool = _static()
    has_checker: bool = _static()
    # Perlin tables were generated by materials/perlin_hash.py: the noise
    # eval recomputes entries with integer hashes (zero gathers) instead of
    # gathering.
    # The tables stay on the Scene either way, so the scalar oracle and the
    # gather path remain bit-identical to the procedural path.
    perlin_procedural: bool = _static()
    # Bilinear image filtering (BASELINE.md upgrade; reference is nearest-
    # neighbor, materials.go:181-192 — keep False for reference parity).
    bilinear_textures: bool = _static()

    @property
    def num_spheres(self) -> int:
        return self.sph_center.shape[0]

    @property
    def num_quads(self) -> int:
        return self.quad_q.shape[0]


def bucket_size(n: int) -> int:
    """Round a table length up to a shared size bucket.

    jit cache keys include every Scene leaf shape, so two scenes share a
    compiled executable only if ALL their table shapes match. Bucketing maps
    nearby sizes to one canonical size: <=32 -> 32 (covers five of the six
    reference scenes' material/texture/quad tables), then powers of two to
    512, then multiples of 512 (bounds dummy-row overhead at <=~10% for big
    scenes, where the intersect loop cost is real). Dummy rows never hit
    (radius 0 / degenerate quads) and dummy material/texture rows are never
    referenced, so bucketing is invisible to the rendered image."""
    if n <= 32:
        return 32
    if n <= 512:
        return 1 << (n - 1).bit_length()
    return -(-n // 512) * 512


class SceneBuilder:
    """Host-side scene construction (analog of main.go scene functions,
    but with explicit seeding — the reference seeds from wall-clock,
    main.go:120,176,246, which we deliberately fix, see SURVEY.md §4)."""

    def __init__(self, seed: int = 0):
        self.rng = np.random.default_rng(seed)
        self._sph: list[tuple] = []  # (center, radius, mat_id)
        self._quads: list[tuple] = []  # (Q, u, v, mat_id)
        self._mats: list[tuple] = []  # (type, albedo3, fuzz, ior, tex_id)
        self._texs: list[tuple] = []  # (type, c0, c1, scale, image_id)
        self._images: list[np.ndarray] = []

    # ---- textures ------------------------------------------------------
    def solid_color(self, r, g, b) -> int:
        """materials.go:151-163."""
        self._texs.append((TEX_SOLID, (r, g, b), (0, 0, 0), 0.0, 0))
        return len(self._texs) - 1

    def checker(self, scale, even, odd) -> int:
        """materials.go:121-145 (3D solid checker over the hit point)."""
        self._texs.append((TEX_CHECKER, tuple(even), tuple(odd), float(scale), 0))
        return len(self._texs) - 1

    def image(self, img: np.ndarray) -> int:
        """materials.go:165-193. `img` is (H, W, 3) float in [0, 1].

        Texels are quantized to 8-bit steps (k/255) at build time: the
        reference's textures are 8-bit JPEGs whose 16-bit RGBA() promotion
        scales back to exactly value/255 (materials.go:184-192, file.go:20-28),
        so this matches the reference pipeline's source fidelity."""
        img = np.asarray(img, np.float32)
        assert img.ndim == 3 and img.shape[2] == 3, img.shape
        img = np.clip(np.round(img * 255.0), 0.0, 255.0) * np.float32(1.0 / 255.0)
        self._images.append(img)
        self._texs.append((TEX_IMAGE, (0, 0, 0), (0, 0, 0), 0.0, len(self._images) - 1))
        return len(self._texs) - 1

    def noise(self, scale) -> int:
        """materials.go:264-295 (marble noise)."""
        self._texs.append((TEX_NOISE, (0, 0, 0), (0, 0, 0), float(scale), 0))
        return len(self._texs) - 1

    # ---- materials -----------------------------------------------------
    def _resolve_tex(self, albedo) -> int:
        """Accept either a texture id or an RGB tuple (implicit solid)."""
        if isinstance(albedo, (int, np.integer)):
            return int(albedo)
        r, g, b = albedo
        return self.solid_color(r, g, b)

    def lambertian(self, albedo) -> int:
        """materials.go:19-42; `albedo` = texture id or RGB tuple."""
        tex = self._resolve_tex(albedo)
        self._mats.append((LAMBERTIAN, (0, 0, 0), 0.0, 1.0, tex))
        return len(self._mats) - 1

    def metal(self, albedo, fuzz: float = 0.0) -> int:
        """materials.go:44-75; flat-color albedo (the reference Metal does not
        take a texture)."""
        self._mats.append((METAL, tuple(albedo), float(fuzz), 1.0, 0))
        return len(self._mats) - 1

    def dielectric(self, ior: float) -> int:
        """materials.go:77-119."""
        self._mats.append((DIELECTRIC, (0, 0, 0), 0.0, float(ior), 0))
        return len(self._mats) - 1

    def diffuse_light(self, emit) -> int:
        """materials.go:297-313; `emit` = texture id or RGB tuple."""
        tex = self._resolve_tex(emit)
        self._mats.append((DIFFUSE_LIGHT, (0, 0, 0), 0.0, 1.0, tex))
        return len(self._mats) - 1

    # ---- geometry ------------------------------------------------------
    def add_sphere(self, center, radius, mat_id: int):
        """hittables.go:85-94."""
        self._sph.append((tuple(center), float(radius), int(mat_id)))

    def add_quad(self, q, u, v, mat_id: int):
        """hittables.go:149-165."""
        self._quads.append((tuple(q), tuple(u), tuple(v), int(mat_id)))

    def add_box(self, a, b, mat_id: int):
        """Axis-aligned box = 6 quads. hittables.go:200-216."""
        a = np.asarray(a, np.float32)
        b = np.asarray(b, np.float32)
        mn = np.minimum(a, b)
        mx = np.maximum(a, b)
        dx = np.array([mx[0] - mn[0], 0, 0], np.float32)
        dy = np.array([0, mx[1] - mn[1], 0], np.float32)
        dz = np.array([0, 0, mx[2] - mn[2]], np.float32)
        self.add_quad((mn[0], mn[1], mx[2]), dx, dy, mat_id)  # front
        self.add_quad((mx[0], mn[1], mx[2]), -dz, dy, mat_id)  # right
        self.add_quad((mx[0], mn[1], mn[2]), -dx, dy, mat_id)  # back
        self.add_quad((mn[0], mn[1], mn[2]), dz, dy, mat_id)  # left
        self.add_quad((mn[0], mx[1], mx[2]), dx, -dz, mat_id)  # top
        self.add_quad((mn[0], mn[1], mn[2]), dx, dz, mat_id)  # bottom

    # ---- build ---------------------------------------------------------
    def build(
        self,
        pad_spheres: int | None = None,
        pad_quads: int | None = None,
        bilinear_textures: bool = False,
        procedural_perlin: bool = True,
        bucket_shapes: bool = False,
    ) -> Scene:
        """Produce the device Scene. Optional padding rounds primitive counts
        up (dummy rows never hit); note jit cache stability additionally
        needs matching material/texture table shapes — padding alone only
        helps scenes that share those. bucket_shapes=True rounds EVERY table
        (spheres, quads, materials, textures) up to a shared size bucket
        (see `bucket_size`) so scenes with nearby table sizes and equal
        static flags share one jit executable — one compile serves them all.
        The CLI enables it by default. bilinear_textures upgrades image lookups from the
        reference's nearest-neighbor to bilinear filtering.

        procedural_perlin=True (default) fills the Perlin tables from
        materials/perlin_hash.py so the device recomputes entries gather-free;
        False keeps rng-filled tables (gather path — the reference's exact
        construction, materials.go:202-216)."""
        sph = self._sph or [((0.0, 0.0, 0.0), 0.0, 0)]
        quads = self._quads or [((0.0, 0.0, 0.0), (0.0, 0.0, 0.0), (0.0, 0.0, 0.0), 0)]
        mats = self._mats or [(LAMBERTIAN, (0, 0, 0), 0.0, 1.0, 0)]
        texs = self._texs or [(TEX_SOLID, (0, 0, 0), (0, 0, 0), 0.0, 0)]

        def pad_list(rows, target, dummy):
            if target is not None and target > len(rows):
                rows = rows + [dummy] * (target - len(rows))
            return rows

        sph = pad_list(sph, pad_spheres, ((0.0, 0.0, 0.0), 0.0, 0))
        quads = pad_list(
            quads, pad_quads, ((0.0, 0.0, 0.0), (0.0, 0.0, 0.0), (0.0, 0.0, 0.0), 0)
        )
        if bucket_shapes:
            dummy_quad = ((0.0, 0.0, 0.0), (0.0, 0.0, 0.0), (0.0, 0.0, 0.0), 0)
            sph = pad_list(sph, bucket_size(len(sph)), ((0.0, 0.0, 0.0), 0.0, 0))
            quads = pad_list(quads, bucket_size(len(quads)), dummy_quad)
            mats = pad_list(
                mats, bucket_size(len(mats)), (LAMBERTIAN, (0, 0, 0), 0.0, 1.0, 0)
            )
            texs = pad_list(
                texs, bucket_size(len(texs)), (TEX_SOLID, (0, 0, 0), (0, 0, 0), 0.0, 0)
            )

        sph_center = np.array([s[0] for s in sph], np.float32)
        sph_radius = np.array([s[1] for s in sph], np.float32)
        sph_mat = np.array([s[2] for s in sph], np.int32)

        quad_q = np.array([q[0] for q in quads], np.float32)
        quad_u = np.array([q[1] for q in quads], np.float32)
        quad_v = np.array([q[2] for q in quads], np.float32)
        quad_mat = np.array([q[3] for q in quads], np.int32)

        mat_type = np.array([m[0] for m in mats], np.int32)
        mat_albedo = np.array([m[1] for m in mats], np.float32)
        mat_fuzz = np.array([m[2] for m in mats], np.float32)
        mat_ior = np.array([m[3] for m in mats], np.float32)
        mat_tex = np.array([m[4] for m in mats], np.int32)

        tex_type = np.array([t[0] for t in texs], np.int32)
        tex_c0 = np.array([t[1] for t in texs], np.float32)
        tex_c1 = np.array([t[2] for t in texs], np.float32)
        tex_scale = np.array([t[3] for t in texs], np.float32)
        tex_image = np.array([t[4] for t in texs], np.int32)

        if self._images:
            hmax = max(i.shape[0] for i in self._images)
            wmax = max(i.shape[1] for i in self._images)
            images = np.zeros((len(self._images), hmax, wmax, 3), np.float32)
            dims = np.zeros((len(self._images), 2), np.int32)
            for k, im in enumerate(self._images):
                images[k, : im.shape[0], : im.shape[1]] = im
                dims[k] = (im.shape[0], im.shape[1])
        else:
            images = np.zeros((1, 1, 1, 3), np.float32)
            dims = np.ones((1, 2), np.int32)

        # Perlin tables (materials.go:202-216): 256 vectors with components
        # U[-1,1) + three independent permutations of 0..255.
        if procedural_perlin:
            from raytracer_tpu.materials.perlin_hash import build_tables

            perlin_vec, perlin_px, perlin_py, perlin_pz = build_tables()
        else:
            perlin_vec = self.rng.uniform(
                -1.0, 1.0, size=(PERLIN_POINT_COUNT, 3)
            ).astype(np.float32)
            perlin_px = self.rng.permutation(PERLIN_POINT_COUNT).astype(np.int32)
            perlin_py = self.rng.permutation(PERLIN_POINT_COUNT).astype(np.int32)
            perlin_pz = self.rng.permutation(PERLIN_POINT_COUNT).astype(np.int32)

        tex_types_present = set(int(t[0]) for t in texs)
        return Scene(
            sph_center=jnp.asarray(sph_center),
            sph_radius=jnp.asarray(sph_radius),
            sph_mat=jnp.asarray(sph_mat),
            quad_q=jnp.asarray(quad_q),
            quad_u=jnp.asarray(quad_u),
            quad_v=jnp.asarray(quad_v),
            quad_mat=jnp.asarray(quad_mat),
            mat_type=jnp.asarray(mat_type),
            mat_albedo=jnp.asarray(mat_albedo),
            mat_fuzz=jnp.asarray(mat_fuzz),
            mat_ior=jnp.asarray(mat_ior),
            mat_tex=jnp.asarray(mat_tex),
            tex_type=jnp.asarray(tex_type),
            tex_c0=jnp.asarray(tex_c0),
            tex_c1=jnp.asarray(tex_c1),
            tex_scale=jnp.asarray(tex_scale),
            tex_image=jnp.asarray(tex_image),
            images=jnp.asarray(images),
            image_dims=jnp.asarray(dims),
            perlin_vec=jnp.asarray(perlin_vec),
            perlin_px=jnp.asarray(perlin_px),
            perlin_py=jnp.asarray(perlin_py),
            perlin_pz=jnp.asarray(perlin_pz),
            has_image=TEX_IMAGE in tex_types_present,
            has_noise=TEX_NOISE in tex_types_present,
            has_checker=TEX_CHECKER in tex_types_present,
            bilinear_textures=bilinear_textures,
            perlin_procedural=procedural_perlin,
        )
