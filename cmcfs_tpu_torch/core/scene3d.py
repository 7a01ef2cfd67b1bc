"""3D scene sources: animated triangle meshes and NetCDF bathymetry.

Mirrors the reference loaders (src/FluidSolver3D/Grid3D.cpp:373-486) with
NumPy; the NetCDF4/HDF5 bathymetry file is read via h5py (the reference links
libnetcdf).
"""
from __future__ import annotations

import dataclasses
import math
from typing import List, Optional

import numpy as np

from .types import GRID_SCALE_FACTOR, BBOX_PADDING

F32 = np.float32


@dataclasses.dataclass
class Shape3D:
    vertices: np.ndarray     # (nv, 3) f32 (grid coords after init)
    velocities: np.ndarray   # (nv, 3) f32
    indices: np.ndarray      # (nt, 3) int32
    active: bool = False


@dataclasses.dataclass
class Frame3D:
    shapes: List[Shape3D]
    duration: float


class Scene3D:
    """Triangle-mesh animation (reference Load3DShape, Grid3D.cpp:373-435)."""

    def __init__(self) -> None:
        self.frames: List[Frame3D] = []
        self.bbox_min = np.zeros(3, dtype=F32)
        self.bbox_max = np.zeros(3, dtype=F32)
        self.dimx = self.dimy = self.dimz = 0

    @staticmethod
    def load(path: str, dx: float, dy: float, dz: float, align: bool = False) -> "Scene3D":
        sc = Scene3D()
        with open(path) as f:
            toks = f.read().replace(",", ".").split()
        it = iter(toks)
        num_frames = int(next(it))
        for _ in range(num_frames):
            nv = int(next(it))
            verts = np.empty((nv, 3), dtype=F32)
            vels = np.empty((nv, 3), dtype=F32)
            for k in range(nv):
                verts[k] = [float(next(it)) for _ in range(3)]
                vels[k] = [float(next(it)) for _ in range(3)]
            verts *= F32(GRID_SCALE_FACTOR)
            nt = int(next(it))
            inds = np.asarray([int(next(it)) for _ in range(nt * 3)],
                              dtype=np.int32).reshape(nt, 3)
            sc.frames.append(Frame3D(
                shapes=[Shape3D(vertices=verts, velocities=vels, indices=inds)],
                duration=1.0 / 75))    # 75 fps, Grid3D.cpp:415

        # bbox with 2% padding (Geometry.h:510-529)
        pmin = np.full(3, np.inf)
        pmax = np.full(3, -np.inf)
        for fr in sc.frames:
            for sh in fr.shapes:
                pmin = np.minimum(pmin, sh.vertices.min(axis=0))
                pmax = np.maximum(pmax, sh.vertices.max(axis=0))
        w = (pmax - pmin).astype(F32)
        sc.bbox_min = pmin.astype(F32) - w * F32(BBOX_PADDING)
        sc.bbox_max = pmax.astype(F32) + w * F32(BBOX_PADDING)

        sc.dimx = int(math.ceil(float(sc.bbox_max[0] - sc.bbox_min[0]) / dx)) + 1
        sc.dimy = int(math.ceil(float(sc.bbox_max[1] - sc.bbox_min[1]) / dy)) + 1
        sc.dimz = int(math.ceil(float(sc.bbox_max[2] - sc.bbox_min[2]) / dz)) + 1
        if align:
            from .types import align_by_32
            sc.dimx = align_by_32(sc.dimx)
            sc.dimy = align_by_32(sc.dimy)
            sc.dimz = align_by_32(sc.dimz)

        d = np.array([F32(dx), F32(dy), F32(dz)], dtype=F32)
        for fr in sc.frames:
            for sh in fr.shapes:
                sh.vertices = ((sh.vertices - sc.bbox_min) / d).astype(F32)
        return sc

    def num_frames(self) -> int:
        return len(self.frames)

    def cycle_length(self) -> float:
        return sum(fr.duration for fr in self.frames)

    def frame_substep(self, time: float):
        a = [0.0]
        for fr in self.frames:
            a.append(a[-1] + fr.duration)
        r = math.fmod(time, a[-1])
        frame = 0
        for i in range(1, len(self.frames)):
            if a[i] < r:
                frame = i
        substep = (r - a[frame]) / (a[frame + 1] - a[frame])
        return frame, substep

    def compute_subframe(self, frame: int, substep: float) -> Frame3D:
        """Reference ComputeSubframeInfo (Grid3D.cpp:900-945), f32 blend."""
        nf = len(self.frames)
        f0 = self.frames[frame % nf]
        f1 = self.frames[(frame + 1) % nf]
        s = F32(substep)
        isub = F32(1.0 - substep)
        shapes = []
        for s0, s1 in zip(f0.shapes, f1.shapes):
            shapes.append(Shape3D(
                vertices=(s0.vertices * isub + s1.vertices * s).astype(F32),
                velocities=(s0.velocities * isub + s1.velocities * s).astype(F32),
                indices=s0.indices, active=s0.active))
        return Frame3D(shapes=shapes, duration=0.0)


@dataclasses.dataclass
class Bathymetry:
    """Sea-depth input (reference LoadNetCDF, Grid3D.cpp:437-486)."""
    lats: np.ndarray     # (nx,)
    lons: np.ndarray     # (ny,)
    depth: np.ndarray    # (nx, ny) f32, negative = below sea level

    @staticmethod
    def load(path: str) -> "Bathymetry":
        import h5py
        with h5py.File(path, "r") as f:
            lats = np.asarray(f["_lat_subset"][:], dtype=np.float64)
            lons = np.asarray(f["_lon_subset"][:], dtype=np.float64)
            depth = np.asarray(f["z"][:], dtype=np.float32)
        assert depth.shape == (lats.size, lons.size)
        return Bathymetry(lats=lats, lons=lons, depth=depth)

    def bbox(self, dz: float):
        pmin = np.array([min(self.lats[0], self.lats[-1]),
                         min(self.lons[0], self.lons[-1]),
                         min(0.0, float(self.depth.min())) - dz], dtype=F32)
        pmax = np.array([max(self.lats[0], self.lats[-1]),
                         max(self.lons[0], self.lons[-1]), 0.0], dtype=F32)
        return pmin, pmax
