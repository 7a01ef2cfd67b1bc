"""3D grid construction: dense cell-type / BC arrays from three scene kinds.

Replicates the reference's Grid3D voxelization semantics
(src/FluidSolver3D/Grid3D.cpp) with dense NumPy arrays:

* ``extrude 2D``   — animated 2D mask extended in depth with a free-surface
  top and a paraboloid-perturbed bottom (Prepare2D, :608-665),
* ``Shape3D``      — triangle-mesh rasterization by dominant-axis scanline
  projection + edge sealing + 6-neighbour flood fill (:690-898),
* ``SeaNetCDF``    — bathymetry thresholding, boundary derivation, inflow/
  outflow valve planes (:966-1075).

The device solvers never see geometry — only these arrays.
"""
from __future__ import annotations

import numpy as np

from ..core.scene3d import Scene3D, Frame3D, Bathymetry
from ..core.types import NodeType, BCtype, COMP_EPS
from .raster2d import Grid2D

F32 = np.float32

try:
    from scipy import ndimage as _ndi
except Exception:  # pragma: no cover
    _ndi = None


def flood_fill_outside_3d(types: np.ndarray) -> None:
    """6-connectivity wave from (0,0,0) over IN cells -> OUT (Grid3D.cpp:811-852)."""
    from . import native as _native
    if _native.flood_fill_3d(types):
        return
    mask = types == NodeType.IN
    if _ndi is not None:
        st = _ndi.generate_binary_structure(3, 1)
        labels, _ = _ndi.label(mask, structure=st)
        comp = labels[0, 0, 0]
        if comp > 0:
            types[labels == comp] = NodeType.OUT
    else:
        reach = np.zeros_like(mask)
        if mask[0, 0, 0]:
            reach[0, 0, 0] = True
            while True:
                grown = reach.copy()
                for ax in range(3):
                    grown |= np.roll(reach, 1, ax) | np.roll(reach, -1, ax)
                grown &= mask
                # roll wraps; strip wrap contamination at faces
                if (grown == reach).all():
                    break
                reach = grown
            types[reach] = NodeType.OUT
    types[0, 0, 0] = NodeType.OUT


class Grid3D:
    """Dense 3D grid with per-cell (type, bc_vel, bc_temp, v, T)."""

    def __init__(self, dimx: int, dimy: int, dimz: int, dx: float, dy: float,
                 dz: float, base_T: float):
        self.dimx, self.dimy, self.dimz = dimx, dimy, dimz
        self.dx, self.dy, self.dz = dx, dy, dz
        self.base_T = base_T
        shape = (dimx, dimy, dimz)
        self.types = np.full(shape, NodeType.OUT, dtype=np.int8)
        self.bc_vel = np.full(shape, BCtype.NOSLIP, dtype=np.int8)
        self.bc_temp = np.full(shape, BCtype.NOSLIP, dtype=np.int8)
        self.vel = np.zeros(shape + (3,), dtype=F32)
        self.T = np.zeros(shape, dtype=F32)

    def _set_bound(self, mask, bc_vel, bc_temp, v, T) -> None:
        """Vectorized Node::SetBound (Grid3D.h:79-88): sets type=BOUND too."""
        self.types[mask] = NodeType.BOUND
        self.bc_vel[mask] = bc_vel
        self.bc_temp[mask] = bc_temp
        self.vel[mask] = v
        self.T[mask] = T

    # ---------------------------------------------------------- extrusion
    @staticmethod
    def from_extruded_2d(grid2d: Grid2D, depth: float, depth_var: float,
                         dz: float, base_T: float, align: bool = False) -> "Grid3D":
        """Allocate the extruded grid (reference LoadFromFile, Grid3D.cpp:498-513)."""
        import math
        active_dimz = int(math.ceil(depth / dz)) + 1
        dimz = active_dimz
        if align:
            from ..core.types import align_by_32
            dimz = align_by_32(active_dimz)
        g = Grid3D(grid2d.dimx, grid2d.dimy, dimz, grid2d.dx, grid2d.dy, dz, base_T)
        g.active_dimz = active_dimz
        g.depth_var = depth_var
        g.grid2d = grid2d
        return g

    def prepare_extruded(self, time: float) -> None:
        """Reference Prepare2D (Grid3D.cpp:608-665), fully vectorized."""
        g2 = self.grid2d
        g2.prepare(time)
        nx, ny, nz = self.dimx, self.dimy, self.dimz
        adz = self.active_dimz
        bT = F32(self.base_T)

        # memset(0): everything starts as IN with zero data (NODE_IN == 0)
        self.types.fill(NodeType.IN)
        self.bc_vel.fill(BCtype.NOSLIP)
        self.bc_temp.fill(BCtype.NOSLIP)
        self.vel.fill(0.0)
        self.T.fill(0.0)

        t2 = g2.cur_types                       # (nx, ny)
        out2 = t2 == NodeType.OUT
        kk = np.arange(nz)

        # columns outside the 2D mask are fully OUT
        col3 = np.broadcast_to(out2[:, :, None], (nx, ny, nz))
        self.types[col3] = NodeType.OUT

        ncol = ~out2                             # non-OUT 2D columns
        # top: k >= active_dimz-1 is OUT; k == active_dimz-2 is free-surface
        top_out = ncol[:, :, None] & (kk >= adz - 1)[None, None, :]
        self.types[top_out] = NodeType.OUT
        surf = ncol[:, :, None] & (kk == adz - 2)[None, None, :]
        self._set_bound(surf, BCtype.NOSLIP, BCtype.FREE, 0.0, bT)

        # bottom: paraboloid perturbation (Grid3D.cpp:632-641)
        height = max(adz - 2 - 2, 0)
        ii = np.arange(nx)[:, None]
        jj = np.arange(ny)[None, :]
        x = -1.0 + 2.0 * ii / nx
        y = -1.0 + 2.0 * jj / ny
        z = 1.0 - (x * x + y * y) * 0.5
        bottom = 1 + (self.depth_var * z * height).astype(np.int64)  # (nx, ny)

        k0 = ncol[:, :, None] & (kk == 0)[None, None, :]
        self.types[k0] = NodeType.OUT
        bot = ncol[:, :, None] & (kk[None, None, :] >= 1) & \
            (kk[None, None, :] <= bottom[:, :, None])
        self._set_bound(bot, BCtype.NOSLIP, BCtype.FREE, 0.0, bT)

        # middle band [bottom+1, adz-2) per 2D type
        mid = ncol[:, :, None] & (kk[None, None, :] > bottom[:, :, None]) & \
            (kk < adz - 2)[None, None, :]

        b2 = t2 == NodeType.BOUND
        v2 = t2 == NodeType.VALVE
        in2 = t2 == NodeType.IN
        vel2 = g2.cur_vel                         # (nx, ny, 2)
        T2 = g2.cur_T

        m_b = mid & b2[:, :, None]
        self.types[m_b] = NodeType.BOUND
        self.bc_vel[m_b] = BCtype.NOSLIP
        self.bc_temp[m_b] = BCtype.FREE
        vel3 = np.concatenate([vel2, np.zeros_like(T2)[..., None]], axis=-1)
        self.vel[m_b] = np.broadcast_to(vel3[:, :, None, :], (nx, ny, nz, 3))[m_b]
        self.T[m_b] = np.broadcast_to(T2[:, :, None], (nx, ny, nz))[m_b]

        zero_v2 = (vel2[..., 0] == 0) & (vel2[..., 1] == 0)
        for stagnant, bcv, bct in ((True, BCtype.FREE, BCtype.FREE),
                                   (False, BCtype.NOSLIP, BCtype.NOSLIP)):
            sel2 = v2 & (zero_v2 if stagnant else ~zero_v2)
            m_v = mid & sel2[:, :, None]
            self.types[m_v] = NodeType.VALVE
            self.bc_vel[m_v] = bcv
            self.bc_temp[m_v] = bct
            self.vel[m_v] = np.broadcast_to(vel3[:, :, None, :], (nx, ny, nz, 3))[m_v]
            self.T[m_v] = np.broadcast_to(T2[:, :, None], (nx, ny, nz))[m_v]

        m_in = mid & in2[:, :, None]
        self.types[m_in] = NodeType.IN
        self.T[m_in] = bT

    # -------------------------------------------------------- 3D polygons
    @staticmethod
    def from_scene3d(scene: Scene3D, dx: float, dy: float, dz: float,
                     base_T: float) -> "Grid3D":
        g = Grid3D(scene.dimx, scene.dimy, scene.dimz, dx, dy, dz, base_T)
        g.scene3d = scene
        return g

    def _project_point(self, axis: int, i: int, j: int, tx: float, ty: float,
                       n, d: float) -> None:
        """ProjectPointOnPolygon (Grid3D.cpp:690-708)."""
        if axis == 0:
            k = int((-d - (tx * n[1] + ty * n[2])) / n[0])
            if 0 <= k < self.dimx and 0 <= i < self.dimy and 0 <= j < self.dimz:
                self.types[k, i, j] = NodeType.BOUND
        elif axis == 1:
            k = int((-d - (tx * n[0] + ty * n[2])) / n[1])
            if 0 <= k < self.dimy and 0 <= i < self.dimx and 0 <= j < self.dimz:
                self.types[i, k, j] = NodeType.BOUND
        else:
            k = int((-d - (tx * n[0] + ty * n[1])) / n[2])
            if 0 <= k < self.dimz and 0 <= i < self.dimx and 0 <= j < self.dimy:
                self.types[i, j, k] = NodeType.BOUND

    def _raster_polygon(self, p1, p2, p3) -> None:
        """Scanline rasterization with back-projection (Grid3D.cpp:710-788)."""
        p1 = np.asarray(p1, dtype=F32)
        p2 = np.asarray(p2, dtype=F32)
        p3 = np.asarray(p3, dtype=F32)
        if (np.abs(p1 - p2) < COMP_EPS).all() and (np.abs(p1 - p3) < COMP_EPS).all():
            return
        n = np.cross((p2 - p1).astype(F32), (p3 - p1).astype(F32)).astype(F32)
        ln = F32(np.sqrt(np.float32(n[0]*n[0] + n[1]*n[1] + n[2]*n[2])))
        n = (n * (F32(1.0) / ln)).astype(F32)
        d = F32(-(p1[0]*n[0] + p1[1]*n[1] + p1[2]*n[2]))

        # dominant axis: separate ifs in the reference -> last match wins
        maxv = max(abs(float(n[0])), abs(float(n[1])), abs(float(n[2])))
        axis = 0
        for a in (0, 1, 2):
            if abs(maxv - abs(float(n[a]))) < COMP_EPS:
                axis = a
        proj = {0: (1, 2), 1: (0, 2), 2: (0, 1)}[axis]
        pp = [np.array([p[proj[0]], p[proj[1]]], dtype=F32) for p in (p1, p2, p3)]
        pp1, pp2, pp3 = pp
        if pp3[1] < pp2[1]:
            pp2, pp3 = pp3, pp2
        if pp1[1] > pp2[1]:
            pp1, pp2 = pp2, pp1
        if pp3[1] < pp2[1]:
            pp2, pp3 = pp3, pp2

        def horizon(a, b, p):
            ry = p[1]
            if abs(float(a[1] - b[1])) < COMP_EPS:
                rx = p[0]
            else:
                rx = a[0] + (b[0] - a[0]) * (ry - a[1]) / (b[1] - a[1])
            return np.array([rx, ry], dtype=F32)

        mid = horizon(pp1, pp3, pp2)
        dir1 = mid - pp1
        dir2 = pp3 - mid
        steps1 = int(max(abs(float(dir1[0])), abs(float(dir1[1])))) + 1
        steps2 = int(max(abs(float(dir2[0])), abs(float(dir2[1])))) + 1
        dp1 = (dir1 / F32(steps1)).astype(F32)
        dp2 = (dir2 / F32(steps2)).astype(F32)

        p = pp1.copy()
        di = 1 if mid[0] < pp2[0] else -1
        guard = 8 * (self.dimx + self.dimy + self.dimz)

        while p[1] < mid[1]:
            j = int(p[1])
            last_i = int(horizon(pp1, pp2, p)[0])
            i = int(p[0])
            cnt = 0
            while i != last_i + di and cnt < guard:
                self._project_point(axis, i, j, F32(i), F32(p[1]), n, d)
                i += di
                cnt += 1
            p = (p + dp1).astype(F32)
        while p[1] < pp3[1]:
            j = int(p[1])
            last_i = int(horizon(pp2, pp3, p)[0])
            i = int(p[0])
            cnt = 0
            while i != last_i + di and cnt < guard:
                self._project_point(axis, i, j, F32(i), F32(p[1]), n, d)
                i += di
                cnt += 1
            p = (p + dp2).astype(F32)

    def _raster_line3d(self, p1, p2) -> None:
        """Edge sealing (Grid3D.cpp:790-809)."""
        p1 = np.asarray(p1, dtype=F32)
        p2 = np.asarray(p2, dtype=F32)
        direction = (p2 - p1).astype(F32)
        steps = int(max(abs(float(direction[0])), abs(float(direction[1])),
                        abs(float(direction[2])))) + 1
        dp = (direction / F32(steps)).astype(F32)
        p = p1.copy()
        for _ in range(steps + 1):
            x, y, z = int(p[0]), int(p[1]), int(p[2])
            if 0 <= x < self.dimx and 0 <= y < self.dimy and 0 <= z < self.dimz:
                self.types[x, y, z] = NodeType.BOUND
            p = (p + dp).astype(F32)

    def build_from_frame(self, frame: Frame3D) -> None:
        """Reference Build (Grid3D.cpp:854-898)."""
        self.types.fill(NodeType.IN)
        for sh in frame.shapes:
            if sh.active:
                continue
            for tri in sh.indices:
                v = sh.vertices
                self._raster_polygon(v[tri[0]], v[tri[1]], v[tri[2]])
                self._raster_line3d(v[tri[0]], v[tri[1]])
                self._raster_line3d(v[tri[0]], v[tri[2]])
                self._raster_line3d(v[tri[2]], v[tri[1]])
        flood_fill_outside_3d(self.types)
        inout = (self.types == NodeType.IN) | (self.types == NodeType.OUT)
        self.bc_vel[inout] = BCtype.NOSLIP
        self.bc_temp[inout] = BCtype.NOSLIP
        self.vel[inout] = 0.0
        self.T[inout] = F32(self.base_T)

    def prepare_shape3d(self, time: float) -> None:
        frame, substep = self.scene3d.frame_substep(time)
        self.build_from_frame(self.scene3d.compute_subframe(frame, F32(substep)))

    # --------------------------------------------------------- bathymetry
    @staticmethod
    def from_bathymetry(bathy: Bathymetry, dx: float, dy: float, dz: float,
                        base_T: float, bc_in_vel, bc_in_T: float,
                        align: bool = False) -> "Grid3D":
        import math
        pmin, pmax = bathy.bbox(dz)
        dimx = int(math.ceil(float(pmax[0] - pmin[0]) / dx)) + 1
        dimy = int(math.ceil(float(pmax[1] - pmin[1]) / dy)) + 1
        dimz = int(math.ceil(float(pmax[2] - pmin[2]) / dz)) + 1
        if align:
            from ..core.types import align_by_32
            dimx, dimy, dimz = map(align_by_32, (dimx, dimy, dimz))
        g = Grid3D(dimx, dimy, dimz, dx, dy, dz, base_T)
        g.bathy = bathy
        g.bbox_min, g.bbox_max = pmin, pmax
        g.bc_in_vel = np.asarray(bc_in_vel, dtype=F32)
        g.bc_in_T = bc_in_T
        return g

    def prepare_bathymetry(self, time: float) -> None:
        """Reference Prepare3D_NetCDF (Grid3D.cpp:966-1075)."""
        nx, ny, nz = self.dimx, self.dimy, self.dimz
        bT = F32(self.base_T)
        self.types.fill(NodeType.OUT)
        self.bc_vel.fill(BCtype.NOSLIP)
        self.bc_temp.fill(BCtype.NOSLIP)
        self.vel.fill(0.0)
        self.T.fill(bT)

        dinfo = self.bathy.depth
        di = (np.arange(nx) * dinfo.shape[0]) // nx
        dj = (np.arange(ny) * dinfo.shape[1]) // ny
        z = dinfo[np.ix_(di, dj)].astype(np.float64)   # (nx, ny)
        sea = z < 0.0
        bound_k = (nz * z / float(self.bbox_min[2])).astype(np.int64)
        kk = np.arange(nz)[None, None, :]
        in3 = sea[:, :, None] & (kk >= 1) & (kk < bound_k[:, :, None])
        self.types[in3] = NodeType.IN

        def neigh_any(types, code):
            m = np.zeros((nx, ny, nz), dtype=bool)
            t = types == code
            m[1:, :, :] |= t[:-1, :, :]
            m[:-1, :, :] |= t[1:, :, :]
            m[:, 1:, :] |= t[:, :-1, :]
            m[:, :-1, :] |= t[:, 1:, :]
            m[:, :, 1:] |= t[:, :, :-1]
            m[:, :, :-1] |= t[:, :, 1:]
            return m

        interior = np.zeros((nx, ny, nz), dtype=bool)
        interior[1:-1, 1:-1, 1:-1] = True

        is_in = self.types == NodeType.IN
        to_bound = interior & is_in & neigh_any(self.types, NodeType.OUT)
        self._set_bound(to_bound, BCtype.NOSLIP, BCtype.NOSLIP, 0.0, bT)

        is_out = self.types == NodeType.OUT
        to_bound2 = interior & is_out & neigh_any(self.types, NodeType.BOUND)
        self._set_bound(to_bound2, BCtype.NOSLIP, BCtype.NOSLIP, 0.0, bT)

        # valve planes at j = dimy-1 and i = dimx-1 (Grid3D.cpp:1037-1074):
        # upper half of the water column flows in, lower half flows out
        for plane in ("y", "x"):
            if plane == "y":
                sl = self.types[:, ny - 1, :]    # (nx, nz)
            else:
                sl = self.types[nx - 1, :, :]    # (ny, nz)
            is_in_sl = sl == NodeType.IN
            any_in = is_in_sl.any(axis=1)
            start = np.argmax(is_in_sl, axis=1)
            end = nz - 1 - np.argmax(is_in_sl[:, ::-1], axis=1)
            half = (start + end) // 2
            kz = np.arange(nz)[None, :]
            upper = is_in_sl & (kz < half[:, None]) & any_in[:, None]
            lower = is_in_sl & (kz >= half[:, None]) & any_in[:, None]
            vin = self.bc_in_vel
            tin = F32(self.bc_in_T)
            for msl, v, t in ((upper, vin, tin), (lower, -vin, F32(2.0) - tin)):
                if plane == "y":
                    m = np.zeros((nx, ny, nz), dtype=bool)
                    m[:, ny - 1, :] = msl
                else:
                    m = np.zeros((nx, ny, nz), dtype=bool)
                    m[nx - 1, :, :] = msl
                self.types[m] = NodeType.VALVE
                self.bc_vel[m] = BCtype.NOSLIP
                self.bc_temp[m] = BCtype.NOSLIP
                self.vel[m] = v
                self.T[m] = t

    # -------------------------------------------------------------- stats
    def fluid_volume(self):
        n_in = int((self.types == NodeType.IN).sum())
        return n_in, n_in * self.dx * self.dy * self.dz
