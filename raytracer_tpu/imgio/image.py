"""Image I/O: PPM (for byte-parity with the reference) + PNG, JPEG loading.

Reference: file.go:9-28 (Overwrite + LoadJPEG) and the P3 PPM emission in
camera.go:183-191 / vec3.go:141-143.
"""

from __future__ import annotations

import os
import struct
import zlib

import numpy as np


def write_ppm(path: str, img_u8: np.ndarray) -> None:
    """Write a P3 (ASCII) PPM exactly like the reference: 'P3\\nW H\\n255\\n'
    header (camera.go:183-191) then one 'r g b' triple per line
    (vec3.go:141-143, joined with newlines camera.go:224-247).

    Uses the C++ native encoder when available (same bytes; tested)."""
    img_u8 = np.asarray(img_u8)
    from raytracer_tpu import native

    if native.write_ppm_native(path, img_u8):
        return
    h, w, _ = img_u8.shape
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    flat = img_u8.reshape(-1, 3)
    lines = [f"{r} {g} {b}" for r, g, b in flat]
    with open(path, "w") as f:
        f.write(f"P3\n{w} {h}\n255\n")
        f.write("\n".join(lines))
        f.write("\n")


def read_ppm(path: str) -> np.ndarray:
    """Parse a P3 PPM back into (H, W, 3) uint8 (test utility)."""
    with open(path) as f:
        tokens = f.read().split()
    assert tokens[0] == "P3", tokens[0]
    w, h, maxv = int(tokens[1]), int(tokens[2]), int(tokens[3])
    assert maxv == 255
    data = np.array(tokens[4 : 4 + w * h * 3], dtype=np.int64)
    return data.reshape(h, w, 3).astype(np.uint8)


def _png_chunk(kind: bytes, data: bytes) -> bytes:
    return (
        struct.pack(">I", len(data))
        + kind
        + data
        + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF)
    )


def write_png(path: str, img_u8: np.ndarray) -> None:
    """Write an (H, W, 3) uint8 image as an 8-bit RGB PNG with the standard
    library alone (zlib + struct), so `--out x.png` needs no imaging
    package: signature, IHDR, one zlib IDAT of filter-0 scanlines, IEND."""
    img = np.ascontiguousarray(np.asarray(img_u8, np.uint8))
    if img.ndim != 3 or img.shape[2] != 3:
        raise ValueError(f"expected (H, W, 3) uint8, got {img.shape}")
    h, w, _ = img.shape
    rows = np.concatenate([np.zeros((h, 1), np.uint8), img.reshape(h, w * 3)], 1)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n")
        f.write(_png_chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)))
        f.write(_png_chunk(b"IDAT", zlib.compress(rows.tobytes(), 6)))
        f.write(_png_chunk(b"IEND", b""))


def load_jpeg(path: str) -> np.ndarray:
    """Load a JPEG as float (H, W, 3) in [0, 1]. Reference: file.go:20-28.

    The Go ImageTexture scales 16-bit RGBA() by 1/65535 (materials.go:184-192);
    8-bit JPEG data promoted to 16-bit is value*257/65535 == value/255, so
    float [0,1] here matches. Needs Pillow (optional: the default earth
    texture is synthetic).
    """
    from PIL import Image

    img = Image.open(path).convert("RGB")
    return np.asarray(img, np.float32) / 255.0


def synthetic_earth_texture(height: int = 256, width: int = 512) -> np.ndarray:
    """Deterministic stand-in for textures/earthmap.jpg, which is a missing
    large blob in the reference mount (/root/reference — .MISSING_LARGE_BLOBS).
    A plausible lat/lon earth-like map: value-noise continents over ocean,
    polar ice caps. Used by the earth scene when no texture file is given.
    """
    rng = np.random.default_rng(42)
    # Low-frequency value noise via random grids upsampled with cosine easing.
    def value_noise(gh, gw):
        grid = rng.uniform(-1.0, 1.0, size=(gh + 1, gw + 1))
        ys = np.linspace(0, gh, height, endpoint=False)
        xs = np.linspace(0, gw, width, endpoint=False)
        yi = ys.astype(int)
        xi = xs.astype(int)
        ty = (ys - yi)[:, None]
        tx = (xs - xi)[None, :]
        ty = ty * ty * (3 - 2 * ty)
        tx = tx * tx * (3 - 2 * tx)
        a = grid[yi][:, xi]
        b = grid[yi][:, (xi + 1) % (gw + 1)]
        c = grid[(yi + 1) % (gh + 1)][:, xi]
        d = grid[(yi + 1) % (gh + 1)][:, (xi + 1) % (gw + 1)]
        return (a * (1 - tx) + b * tx) * (1 - ty) + (c * (1 - tx) + d * tx) * ty

    elev = (
        value_noise(4, 8) + 0.5 * value_noise(8, 16) + 0.25 * value_noise(16, 32)
    )
    lat = np.linspace(-np.pi / 2, np.pi / 2, height)[:, None]
    img = np.zeros((height, width, 3), np.float32)
    ocean = np.array([0.05, 0.15, 0.45])
    land = np.array([0.15, 0.42, 0.12])
    mountain = np.array([0.45, 0.38, 0.30])
    img[:] = ocean
    img[elev > 0.05] = land
    img[elev > 0.55] = mountain
    ice = np.abs(lat) > np.deg2rad(66)
    img[np.broadcast_to(ice, elev.shape)] = (0.92, 0.94, 0.97)
    return img
