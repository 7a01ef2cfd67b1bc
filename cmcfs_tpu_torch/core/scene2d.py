"""2D animated-polyline scene: loading, border velocities, frame interpolation.

Replicates the semantics of the reference loader and per-step subframe
computation (reference: src/FluidSolver2D/Grid2D.cpp:268-454) with NumPy
arrays.  All geometry here is host-side preprocessing; the device never sees
polylines, only the rasterized masks (see geom/raster2d.py).
"""
from __future__ import annotations

import dataclasses
import re
from typing import List, Optional

import numpy as np

from .types import GRID_SCALE_FACTOR, BBOX_PADDING

F32 = np.float32


def _parse_float(tok: str) -> float:
    """Locale-tolerant float: commas become dots (reference: IO.h:511-543)."""
    return float(tok.replace(",", "."))


@dataclasses.dataclass
class Shape2D:
    points: np.ndarray        # (n, 2) f32, grid coords after Scene2D.init()
    velocities: np.ndarray    # (n, 2) f32
    active: bool              # True = "Motion" (valve), False = "Passive" (wall)


@dataclasses.dataclass
class Field2D:
    """Sampled velocity-source field (reference: Geometry.h:232-302)."""
    min_x: float = 0.0
    min_y: float = 0.0
    dx: float = 0.0
    dy: float = 0.0
    nx: int = 0
    ny: int = 0
    data: Optional[np.ndarray] = None   # (ny, nx, 2) f32, row-major j*nx+i

    def correlate(self, other: "Field2D") -> bool:
        eps = 1e-8
        return (abs(self.min_x - other.min_x) < eps and abs(self.min_y - other.min_y) < eps
                and abs(self.dx - other.dx) < eps and abs(self.dy - other.dy) < eps
                and self.nx == other.nx and self.ny == other.ny)


@dataclasses.dataclass
class Frame2D:
    shapes: List[Shape2D]
    duration: float
    field: Field2D = dataclasses.field(default_factory=Field2D)


class Scene2D:
    """All frames of a 2D case plus the bounding box / grid mapping."""

    def __init__(self) -> None:
        self.frames: List[Frame2D] = []
        self.bbox_min = np.zeros(2, dtype=F32)
        self.bbox_max = np.zeros(2, dtype=F32)
        self.dimx = 0
        self.dimy = 0
        self.dx = 0.0
        self.dy = 0.0

    # ------------------------------------------------------------------ load
    @staticmethod
    def load(path: str, field_path: str = "", dx: float = 1.0, dy: float = 1.0,
             align: bool = False) -> "Scene2D":
        sc = Scene2D()
        sc.dx, sc.dy = dx, dy
        with open(path, "r") as f:
            toks = f.read().split()
        it = iter(toks)

        num_frames = int(next(it))
        for _ in range(num_frames):
            duration = _parse_float(next(it))
            num_shapes = int(next(it))
            shapes = []
            for _ in range(num_shapes):
                npts = int(next(it))
                pts = np.empty((npts, 2), dtype=F32)
                for k in range(npts):
                    pts[k, 0] = _parse_float(next(it)) * GRID_SCALE_FACTOR
                    pts[k, 1] = _parse_float(next(it)) * GRID_SCALE_FACTOR
                marker = next(it)
                vel = np.zeros(2, dtype=F32)
                active = marker.startswith("M")   # reference Grid2D.cpp:305
                if active:
                    vel[0] = _parse_float(next(it)) * GRID_SCALE_FACTOR
                    vel[1] = _parse_float(next(it)) * GRID_SCALE_FACTOR
                vels = np.tile(vel, (npts, 1)).astype(F32)
                shapes.append(Shape2D(points=pts, velocities=vels, active=active))
            sc.frames.append(Frame2D(shapes=shapes, duration=duration))

        if field_path:
            sc._load_field(field_path)

        for j in range(len(sc.frames)):
            sc._compute_border_velocities(j)

        sc._init(align)
        return sc

    def _load_field(self, path: str) -> None:
        """Reference Grid2D.cpp:321-365."""
        with open(path, "r") as f:
            lines = f.read().splitlines()
        hdr0 = lines[0].split()
        hdr1 = lines[1].split()
        minx = _parse_float(hdr0[0]) * GRID_SCALE_FACTOR
        miny = _parse_float(hdr0[1]) * GRID_SCALE_FACTOR
        fdx = _parse_float(hdr1[0]) * GRID_SCALE_FACTOR
        fdy = _parse_float(hdr1[1]) * GRID_SCALE_FACTOR
        nx = int(hdr1[2])
        ny = int(hdr1[3])

        li = 2
        while li < len(lines):
            line = lines[li]
            if not line.startswith("F"):
                break
            frame = int(re.sub(r"[^0-9]", "", line) or 0)
            li += 2  # skip one line after the Frame header (reference reads & drops it)
            fld = Field2D(min_x=minx, min_y=miny, dx=fdx, dy=fdy, nx=nx, ny=ny)
            data = np.zeros((ny, nx, 2), dtype=F32)
            vals: List[float] = []
            while len(vals) < nx * ny * 2 and li < len(lines):
                vals.extend(_parse_float(t) for t in lines[li].split())
                li += 1
            arr = np.asarray(vals[: nx * ny * 2], dtype=F32).reshape(ny, nx, 2)
            data[:] = arr
            fld.data = data
            self.frames[frame].field = fld
            li += 1  # trailing line after block

    # ------------------------------------------------- border velocities
    def _compute_border_velocities(self, frame: int) -> None:
        """Reference Grid2D.cpp:375-393 (f32 arithmetic)."""
        frames = self.frames
        nf = len(frames)
        nxt = (frame + 1) % nf
        m = F32(1.0 / frames[frame].duration)
        for i, shp in enumerate(frames[frame].shapes):
            dst = frames[nxt].shapes[i]
            if not shp.active:
                dst.velocities = ((dst.points - shp.points) * m).astype(F32)
            else:
                dst.velocities = (dst.velocities + (shp.points - dst.points) * m).astype(F32)

    # --------------------------------------------------------------- init
    def _init(self, align: bool) -> None:
        """BBox (2% padding) -> dims -> points to grid coords.

        Reference Grid2D.cpp:197-229 and Geometry.h:463-479.
        """
        pmin = np.full(2, np.inf, dtype=np.float64)
        pmax = np.full(2, -np.inf, dtype=np.float64)
        for fr in self.frames:
            for shp in fr.shapes:
                pmin = np.minimum(pmin, shp.points.min(axis=0))
                pmax = np.maximum(pmax, shp.points.max(axis=0))
        w = (pmax - pmin).astype(F32)
        pminf = pmin.astype(F32) - w * F32(BBOX_PADDING)
        pmaxf = pmax.astype(F32) + w * F32(BBOX_PADDING)
        self.bbox_min, self.bbox_max = pminf, pmaxf

        import math
        self.dimx = int(math.ceil(float(pmaxf[0] - pminf[0]) / self.dx)) + 1
        self.dimy = int(math.ceil(float(pmaxf[1] - pminf[1]) / self.dy)) + 1
        if align:
            from .types import align_by_32
            self.dimx = align_by_32(self.dimx)
            self.dimy = align_by_32(self.dimy)

        scale = np.array([1.0 / F32(self.dx), 1.0 / F32(self.dy)], dtype=F32)
        for fr in self.frames:
            for shp in fr.shapes:
                # reference divides by dx (f32): (p - pmin) / dx
                shp.points = ((shp.points - pminf) / np.array([F32(self.dx), F32(self.dy)], dtype=F32)).astype(F32)
        del scale

    # ----------------------------------------------------- frame timing
    def _cumdur(self) -> np.ndarray:
        a = np.zeros(len(self.frames) + 1, dtype=np.float64)
        for i, fr in enumerate(self.frames):
            a[i + 1] = a[i] + fr.duration
        return a

    def cycle_length(self) -> float:
        return float(sum(fr.duration for fr in self.frames))

    def num_frames(self) -> int:
        return len(self.frames)

    def frame_at(self, time: float) -> int:
        """Reference Grid2D.cpp:493-506."""
        a = self._cumdur()
        r = np.fmod(time, a[-1])
        frame = 0
        for i in range(1, len(self.frames)):
            if a[i] < r:
                frame = i
        return frame

    def layer_time(self, t: float) -> float:
        a = self._cumdur()
        r = np.fmod(t, a[-1])
        frame = self.frame_at(t)
        return float(a[frame + 1] - r)

    def frame_substep(self, time: float):
        """Frame index + interpolation substep for a wall time (Grid2D.cpp:463-478)."""
        a = self._cumdur()
        r = np.fmod(time, a[-1])
        frame = 0
        for i in range(1, len(self.frames)):
            if a[i] < r:
                frame = i
        substep = (r - a[frame]) / (a[frame + 1] - a[frame])
        return frame, float(substep)

    # ------------------------------------------------------ interpolation
    def compute_subframe(self, frame: int, substep: float) -> Frame2D:
        """Linear blend between frame and frame+1 (Grid2D.cpp:396-454), f32."""
        nf = len(self.frames)
        f0 = self.frames[frame % nf]
        f1 = self.frames[(frame + 1) % nf]
        s = F32(substep)
        isub = F32(1.0 - substep)
        shapes = []
        for s0, s1 in zip(f0.shapes, f1.shapes):
            pts = (s0.points * isub + s1.points * s).astype(F32)
            vel = (s0.velocities * isub + s1.velocities * s).astype(F32)
            shapes.append(Shape2D(points=pts, velocities=vel, active=s0.active))
        fld = Field2D()
        if f0.field.correlate(f1.field):
            fld = Field2D(min_x=f0.field.min_x, min_y=f0.field.min_y,
                          dx=f0.field.dx, dy=f0.field.dy, nx=f0.field.nx, ny=f0.field.ny)
            if f0.field.data is not None:
                d0 = f0.field.data.astype(np.float64)
                d1 = f1.field.data.astype(np.float64)
                nz0 = (d0[..., 0] != 0) | (d0[..., 1] != 0)
                nz1 = (d1[..., 0] != 0) | (d1[..., 1] != 0)
                both = (nz0 & nz1)[..., None]
                fld.data = np.where(both, d0 * (1.0 - substep) + d1 * substep, 0.0).astype(F32)
        return Frame2D(shapes=shapes, duration=0.0, field=fld)

    def is_static(self) -> bool:
        """True when geometry never changes between steps (single frame)."""
        return len(self.frames) == 1
