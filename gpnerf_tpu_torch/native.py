"""ctypes bindings for the native host kernels (native/gpnerf_host.cpp, the
repo's C++ source shared by both packages).

Builds the shared library with g++ on first use into the port's git-ignored
build directory (gpnerf_tpu_torch/_build/); the callers in data/ keep their
numpy path for hosts without a toolchain. Plain C ABI + ctypes."""

from __future__ import annotations

import ctypes
import os
import subprocess

import numpy as np

_PKG = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(os.path.dirname(_PKG), "native", "gpnerf_host.cpp")
_LIB = os.path.join(_PKG, "_build", "libgpnerf_host.so")

_lib = None
_tried = False


def _load():
    global _lib, _tried
    if _tried:
        return _lib
    _tried = True
    try:
        if (not os.path.exists(_LIB)) or (
            os.path.getmtime(_LIB) < os.path.getmtime(_SRC)
        ):
            os.makedirs(os.path.dirname(_LIB), exist_ok=True)
            subprocess.run(
                ["g++", "-O3", "-shared", "-fPIC", _SRC, "-o", _LIB],
                check=True,
                capture_output=True,
            )
        lib = ctypes.CDLL(_LIB)
        dp = ctypes.POINTER(ctypes.c_double)
        fp = ctypes.POINTER(ctypes.c_float)
        up = ctypes.POINTER(ctypes.c_uint8)
        i64 = ctypes.c_int64
        lib.near_far.argtypes = [dp, dp, dp, i64, dp, dp, up]
        lib.bilinear_remap.argtypes = [fp, i64, i64, i64, dp, dp, fp]
        lib.nearest_remap_u8.argtypes = [up, i64, i64, dp, dp, up]
        lib.zsplat.argtypes = [dp, dp, dp, fp, i64, i64, i64, i64, fp, fp]
        _lib = lib
    except Exception:
        _lib = None
    return _lib


def available() -> bool:
    return _load() is not None


def _c(arr, dtype):
    a = np.ascontiguousarray(arr, dtype=dtype)
    return a, a.ctypes.data_as(
        ctypes.POINTER(
            {np.float64: ctypes.c_double, np.float32: ctypes.c_float, np.uint8: ctypes.c_uint8}[dtype]
        )
    )


def near_far(bounds, ray_o, ray_d):
    """Native ray/AABB intersection; same contract as
    gpnerf_tpu_torch.data.geometry.get_near_far (near/far only for masked rays)."""
    lib = _load()
    n = len(ray_o)
    b, bp = _c(bounds, np.float64)
    o, op = _c(ray_o, np.float64)
    d, dp_ = _c(ray_d, np.float64)
    near = np.empty(n, np.float64)
    far = np.empty(n, np.float64)
    mask = np.empty(n, np.uint8)
    lib.near_far(
        bp, op, dp_, n,
        near.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        far.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        mask.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
    )
    m = mask.astype(bool)
    return near[m], far[m], m


def bilinear_remap(src, map_u, map_v):
    lib = _load()
    h, w = src.shape[:2]
    c = 1 if src.ndim == 2 else src.shape[2]
    s, sp = _c(src.reshape(h, w, c), np.float32)
    mu, mup = _c(map_u, np.float64)
    mv, mvp = _c(map_v, np.float64)
    out = np.empty((h, w, c), np.float32)
    lib.bilinear_remap(sp, h, w, c,
                       mup, mvp,
                       out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
    return out if src.ndim == 3 else out[..., 0]


def nearest_remap_u8(src, map_u, map_v):
    lib = _load()
    h, w = src.shape[:2]
    s, sp = _c(src, np.uint8)
    mu, mup = _c(map_u, np.float64)
    mv, mvp = _c(map_v, np.float64)
    out = np.empty((h, w), np.uint8)
    lib.nearest_remap_u8(sp, h, w, mup, mvp,
                         out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
    return out


def zsplat(px, py, z, colors, radius, img_hw):
    lib = _load()
    h, w = img_hw
    n = len(px)
    pxa, pxp = _c(px, np.float64)
    pya, pyp = _c(py, np.float64)
    za, zp = _c(z, np.float64)
    ca, cp = _c(colors, np.float32)
    img = np.zeros((h * w, 3), np.float32)
    zbuf = np.empty(h * w, np.float32)
    lib.zsplat(pxp, pyp, zp, cp, n, radius, h, w,
               img.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
               zbuf.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
    mask = (zbuf < 1e29).astype(np.uint8)
    return img.reshape(h, w, 3), mask.reshape(h, w)
