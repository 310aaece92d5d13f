"""ctypes bindings for the native host library (native/lidar_ops.cpp).

The port's own loader for the C++ source it shares with the JAX package:
the library is built with g++ on first use into this directory (its own
path, not the JAX package's); every entry point has a numpy fallback so
the port works without a compiler. `available()` reports which path is
active. Host code only: no device kernel lives here.
"""

from __future__ import annotations

import ctypes
import os
import subprocess

import numpy as np

_LIB = None
_SRC = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "native",
    "lidar_ops.cpp",
)
_SO = os.path.join(os.path.dirname(os.path.abspath(__file__)), "_lidar_ops.so")


def _build() -> bool:
    try:
        subprocess.run(
            ["g++", "-O3", "-march=native", "-shared", "-fPIC", _SRC, "-o", _SO],
            check=True, capture_output=True, timeout=120,
        )
        return True
    except (OSError, subprocess.SubprocessError):
        return False


def _load():
    global _LIB
    if _LIB is not None:
        return _LIB
    if not os.path.exists(_SO) or os.path.getmtime(_SO) < os.path.getmtime(_SRC):
        if not _build():
            return None
    try:
        lib = ctypes.CDLL(_SO)
    except OSError:
        return None
    i64, f32p = ctypes.c_int64, np.ctypeslib.ndpointer(np.float32, flags="C")
    i64p = np.ctypeslib.ndpointer(np.int64, flags="C")
    u8p = np.ctypeslib.ndpointer(np.uint8, flags="C")
    u32p = np.ctypeslib.ndpointer(np.uint32, flags="C")
    i32p = np.ctypeslib.ndpointer(np.int32, flags="C")
    lib.transform_points_f32.argtypes = [f32p, i64, i64, f32p, f32p]
    lib.crop_lidar_box_f32.argtypes = [f32p, i64, i64, f32p, i64, f32p, i64p]
    lib.crop_lidar_box_f32.restype = i64
    lib.mask_hit_counts_u8.argtypes = [u8p, i64, i64, i64, f32p, u8p, i64, i64p]
    lib.hamming_matrix_u32.argtypes = [u32p, i64, u32p, i64, i32p]
    _LIB = lib
    return lib


def available() -> bool:
    return _load() is not None


def transform_points(T: np.ndarray, pts: np.ndarray) -> np.ndarray:
    lib = _load()
    pts = np.ascontiguousarray(pts, np.float32)
    if lib is None:
        return pts[:, :3] @ np.asarray(T, np.float32)[:3, :3].T + T[:3, 3]
    out = np.empty((len(pts), 3), np.float32)
    lib.transform_points_f32(
        pts, len(pts), pts.shape[1], np.ascontiguousarray(T, np.float32).reshape(-1),
        out,
    )
    return out


def crop_lidar_box(velo: np.ndarray, box: np.ndarray, max_points: int) -> np.ndarray:
    """Native path of objects.detections.crop_lidar_for_box."""
    lib = _load()
    if lib is None:
        from ..objects.detections import crop_lidar_for_box

        return crop_lidar_for_box(velo, box, max_points)[:, :3]
    velo = np.ascontiguousarray(velo, np.float32)
    out = np.empty((max_points, 3), np.float32)
    scratch = np.empty(len(velo), np.int64)
    n = lib.crop_lidar_box_f32(
        velo, len(velo), velo.shape[1],
        np.ascontiguousarray(box, np.float32), max_points, out, scratch,
    )
    return out[:n]


def mask_hit_counts(masks: np.ndarray, uv: np.ndarray, valid: np.ndarray) -> np.ndarray:
    lib = _load()
    if lib is None:
        pi = uv.astype(np.int64)
        h, w = masks.shape[1:]
        ok = valid & (pi[:, 0] >= 0) & (pi[:, 0] < w) & (pi[:, 1] >= 0) & (pi[:, 1] < h)
        pi = pi[ok]
        return masks[:, pi[:, 1], pi[:, 0]].sum(axis=-1).astype(np.int64)
    m = np.ascontiguousarray(masks.astype(np.uint8))
    counts = np.empty(len(masks), np.int64)
    lib.mask_hit_counts_u8(
        m, len(masks), masks.shape[1], masks.shape[2],
        np.ascontiguousarray(uv, np.float32),
        np.ascontiguousarray(valid.astype(np.uint8)), len(uv), counts,
    )
    return counts


def hamming_matrix(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    lib = _load()
    if lib is None:
        x = a[:, None, :] ^ b[None, :, :]
        return np.unpackbits(x.view(np.uint8), axis=-1).sum(-1).astype(np.int32)
    out = np.empty((len(a), len(b)), np.int32)
    lib.hamming_matrix_u32(
        np.ascontiguousarray(a, np.uint32), len(a),
        np.ascontiguousarray(b, np.uint32), len(b), out,
    )
    return out
