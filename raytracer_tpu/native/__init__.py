"""ctypes bindings to the C++ native runtime (cpp/libraytpu.so).

Native host-side components (scene compiler / image encode) built from the
tracked source on first use in each process (`make` rebuilds whenever
raytpu_native.cc or the Makefile is newer than the library), with NumPy
fallbacks when no toolchain is available or the build fails — the device
compute path (Pallas/XLA) is unaffected either way.
"""

from __future__ import annotations

import ctypes
import os
import subprocess

import numpy as np

_CPP_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "cpp")
_LIB_PATH = os.path.join(_CPP_DIR, "libraytpu.so")
_lib = None
_tried = False


def _load():
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    _tried = True
    # Always ask make: it rebuilds a library older than its source, and a
    # failed build (or no toolchain) means no native library at all rather
    # than a stale one.
    try:
        subprocess.run(
            ["make", "-C", _CPP_DIR],
            check=True,
            capture_output=True,
            timeout=120,
        )
    except (OSError, subprocess.SubprocessError):
        return None
    try:
        lib = ctypes.CDLL(_LIB_PATH)
    except OSError:
        return None

    f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
    i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
    u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")

    lib.rt_build_bvh.restype = ctypes.c_int32
    lib.rt_build_bvh.argtypes = [
        f32p, f32p, ctypes.c_int32, ctypes.c_int32,
        f32p, f32p, i32p, i32p, i32p, i32p,
        ctypes.POINTER(ctypes.c_int32),
    ]
    lib.rt_tonemap.restype = None
    lib.rt_tonemap.argtypes = [f32p, ctypes.c_int64, u8p]
    lib.rt_write_ppm.restype = ctypes.c_int32
    lib.rt_write_ppm.argtypes = [u8p, ctypes.c_int32, ctypes.c_int32, ctypes.c_char_p]
    _lib = lib
    return _lib


def available() -> bool:
    return _load() is not None


def build_bvh_native(bmin: np.ndarray, bmax: np.ndarray, leaf_size: int = 4):
    """C++ BVH build; same array contract as geometry/bvh.build_bvh.

    Returns (box_min, box_max, skip, leaf_start, leaf_count, prim_order) as
    NumPy arrays, or None if the native library is unavailable.
    """
    lib = _load()
    if lib is None:
        return None
    bmin = np.ascontiguousarray(bmin, np.float32)
    bmax = np.ascontiguousarray(bmax, np.float32)
    n = bmin.shape[0]
    cap = 2 * max(n, 1)
    out_min = np.empty((cap, 3), np.float32)
    out_max = np.empty((cap, 3), np.float32)
    skip = np.empty(cap, np.int32)
    lstart = np.empty(cap, np.int32)
    lcount = np.empty(cap, np.int32)
    order = np.empty(max(n, 1), np.int32)
    order_len = ctypes.c_int32(0)
    m = lib.rt_build_bvh(
        bmin, bmax, n, leaf_size, out_min, out_max, skip, lstart, lcount,
        order, ctypes.byref(order_len),
    )
    if m < 0:
        return None
    k = order_len.value
    return (
        out_min[:m].copy(),
        out_max[:m].copy(),
        skip[:m].copy(),
        lstart[:m].copy(),
        lcount[:m].copy(),
        order[:k].copy(),
    )


def tonemap_native(rgb: np.ndarray) -> np.ndarray | None:
    lib = _load()
    if lib is None:
        return None
    rgb = np.ascontiguousarray(rgb, np.float32)
    out = np.empty(rgb.shape, np.uint8)
    lib.rt_tonemap(rgb.reshape(-1), rgb.size, out.reshape(-1))
    return out


def write_ppm_native(path: str, img_u8: np.ndarray) -> bool:
    lib = _load()
    if lib is None:
        return False
    img = np.ascontiguousarray(img_u8, np.uint8)
    h, w, _ = img.shape
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    return lib.rt_write_ppm(img.reshape(-1), w, h, path.encode()) == 0
