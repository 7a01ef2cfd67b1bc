"""ctypes binding to the native geometry engine (geom/geom.cpp).

The per-step scene rebuild is the host-side hot path for animated cases (the
reference rebuilds the whole mask every step, FluidSolver2D.cpp:130); the
C++ engine accelerates rasterization, flood fill and line classification.
Falls back to the NumPy implementations when the library isn't built.

Build: g++ compiles ``geom/geom.cpp`` (this package's copy of
``native/geom.cpp``) into ``build/cmcfs_tpu_torch/libcmcfsgeom.so`` at the
repository root on first use when g++ is available.
"""
from __future__ import annotations

import ctypes
import os
import subprocess
from typing import Optional

import numpy as np

_LIB: Optional[ctypes.CDLL] = None
_TRIED = False

_HERE = os.path.dirname(os.path.abspath(__file__))
_ROOT = os.path.dirname(os.path.dirname(_HERE))
_SO = os.path.join(_ROOT, "build", "cmcfs_tpu_torch", "libcmcfsgeom.so")
_SRC = os.path.join(_HERE, "geom.cpp")

_i8p = np.ctypeslib.ndpointer(np.int8, flags="C_CONTIGUOUS")
_f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
_i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")


def _build() -> bool:
    try:
        os.makedirs(os.path.dirname(_SO), exist_ok=True)
        tmp = f"{_SO}.{os.getpid()}.tmp"    # concurrent builders never clash
        subprocess.run(["g++", "-O3", "-shared", "-fPIC", "-o", tmp, _SRC],
                       check=True, capture_output=True, timeout=120)
        os.replace(tmp, _SO)
        return True
    except Exception:
        return False


def get_lib() -> Optional[ctypes.CDLL]:
    global _LIB, _TRIED
    if _LIB is not None or _TRIED:
        return _LIB
    _TRIED = True
    if os.environ.get("CMCFS_NO_NATIVE"):
        return None
    if not os.path.exists(_SO) or os.path.getmtime(_SO) < os.path.getmtime(_SRC):
        if not _build():
            return None
    try:
        lib = ctypes.CDLL(_SO)
    except OSError:
        return None

    lib.raster_polyline_2d.argtypes = [
        ctypes.c_int, ctypes.c_int, _f32p, _f32p, ctypes.c_int, ctypes.c_int8,
        ctypes.c_int, ctypes.c_float, ctypes.c_float, ctypes.c_void_p,
        _i8p, _i8p, _f32p, _f32p]
    lib.flood_fill_2d.argtypes = [ctypes.c_int, ctypes.c_int, _i8p]
    lib.flood_fill_3d.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_int, _i8p]
    lib.line_class_2d.argtypes = [ctypes.c_int, ctypes.c_int, _i8p,
                                  ctypes.c_int, _i8p]
    lib.line_class_3d_lines.argtypes = [
        ctypes.c_long, ctypes.c_long, ctypes.c_long, _i64p, _i8p,
        _i8p, _i8p, _i8p]
    lib.line_class_3d_lines.restype = ctypes.c_int
    _LIB = lib
    return _LIB


def raster_polyline(types, bct, vel, T, pts, vels, color, bc_noslip,
                    bc_strength, start_T, bv_field=None) -> bool:
    lib = get_lib()
    if lib is None:
        return False
    dimx, dimy = types.shape
    bv = None
    if bv_field is not None:
        bv = np.ascontiguousarray(bv_field, dtype=np.float32)
    lib.raster_polyline_2d(
        dimx, dimy, np.ascontiguousarray(pts, np.float32),
        np.ascontiguousarray(vels, np.float32), len(pts), np.int8(color),
        int(bc_noslip), np.float32(bc_strength), np.float32(start_T),
        None if bv is None else bv.ctypes.data_as(ctypes.c_void_p),
        types, bct, vel.reshape(-1), T)
    return True


def flood_fill_2d(types) -> bool:
    lib = get_lib()
    if lib is None:
        return False
    lib.flood_fill_2d(types.shape[0], types.shape[1], types)
    return True


def flood_fill_3d(types) -> bool:
    lib = get_lib()
    if lib is None:
        return False
    lib.flood_fill_3d(types.shape[0], types.shape[1], types.shape[2], types)
    return True


def line_class_2d(types, axis: int):
    lib = get_lib()
    if lib is None:
        return None
    cls = np.zeros_like(types)
    lib.line_class_2d(types.shape[0], types.shape[1],
                      np.ascontiguousarray(types), axis, cls)
    return cls


def line_class_3d(types, axis: int):
    """Returns (cls_a, cls_b | None, take_b | None)."""
    lib = get_lib()
    if lib is None:
        return None
    nx, ny, nz = types.shape
    t = np.ascontiguousarray(types)
    cls_a = np.zeros_like(t)
    cls_b = np.zeros_like(t)
    take_b = np.zeros_like(t)
    if axis == 0:
        N, stride = nx, ny * nz
        bases = np.arange(ny * nz, dtype=np.int64)
    elif axis == 1:
        N, stride = ny, nz
        ii, kk = np.meshgrid(np.arange(nx), np.arange(nz), indexing="ij")
        bases = (ii * (ny * nz) + kk).reshape(-1).astype(np.int64)
    else:
        N, stride = nz, 1
        bases = (np.arange(nx * ny, dtype=np.int64) * nz)
    bases = np.ascontiguousarray(bases)
    has_dual = lib.line_class_3d_lines(len(bases), N, stride, bases, t,
                                       cls_a, cls_b, take_b)
    if has_dual:
        return cls_a, cls_b, take_b.astype(bool)
    return cls_a, None, None
