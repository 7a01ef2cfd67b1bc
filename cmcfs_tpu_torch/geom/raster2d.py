"""2D scene rasterization into dense cell-type / BC arrays.

Host-side preprocessing replicating the reference's per-step grid rebuild
(reference: src/FluidSolver2D/Grid2D.cpp:109-266, 396-478): moving polyline
rasterization with slip/no-slip velocity decomposition, outside flood fill,
and velocity-source field rasterization.  Output is a set of dense NumPy
arrays; the device solvers consume these as masks — no segment lists exist
anywhere in this framework.
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from ..core.scene2d import Scene2D, Frame2D, Field2D
from ..core.types import NodeType, BCtype

F32 = np.float32

try:
    from scipy import ndimage as _ndi
except Exception:  # pragma: no cover
    _ndi = None

_FOUR_CONN = np.array([[0, 1, 0], [1, 1, 1], [0, 1, 0]], dtype=bool)


def flood_fill_outside(types: np.ndarray) -> None:
    """Mark the IN-connected component containing (0,0) as OUT, in place.

    Equivalent reachable set to the reference's BFS wave (Grid2D.cpp:156-195),
    4-connectivity.  The seed cell is always marked OUT (reference does
    SetType(0,0,color) unconditionally).
    """
    from . import native as _native
    if _native.flood_fill_2d(types):
        return
    mask = types == NodeType.IN
    if _ndi is not None:
        labels, _ = _ndi.label(mask, structure=_FOUR_CONN)
        comp = labels[0, 0]
        if comp > 0:
            types[labels == comp] = NodeType.OUT
    else:  # frontier-dilation fallback
        reach = np.zeros_like(mask)
        if mask[0, 0]:
            reach[0, 0] = True
            while True:
                grown = reach.copy()
                grown[1:, :] |= reach[:-1, :]
                grown[:-1, :] |= reach[1:, :]
                grown[:, 1:] |= reach[:, :-1]
                grown[:, :-1] |= reach[:, 1:]
                grown &= mask
                if (grown == reach).all():
                    break
                reach = grown
            types[reach] = NodeType.OUT
    types[0, 0] = NodeType.OUT


class Grid2D:
    """Dense 2D grid: cell types + per-cell BC data, rebuilt per frame.

    Mirrors reference Grid2D (src/FluidSolver2D/Grid2D.h:51-105).  ``cur_*``
    arrays are the rasterized state; ``next_*`` hold the solver's velocity
    feedback used by the slip boundary blend (SetGridBoundaries /
    GetBounfVelocity coupling, Grid2D.cpp:85-107 + Solver2D.cpp:65-73).
    """

    def __init__(self, scene: Scene2D, start_T: float, bc_noslip: bool, bc_strength: float):
        self.scene = scene
        self.dimx = scene.dimx
        self.dimy = scene.dimy
        self.dx = scene.dx
        self.dy = scene.dy
        self.start_T = start_T
        self.bc_noslip = bc_noslip
        self.bc_strength = bc_strength

        shape = (self.dimx, self.dimy)
        self.cur_types = np.full(shape, NodeType.OUT, dtype=np.int8)
        self.cur_bct = np.full(shape, BCtype.NOSLIP, dtype=np.int8)
        self.cur_vel = np.zeros(shape + (2,), dtype=F32)
        self.cur_T = np.zeros(shape, dtype=F32)

        # feedback field (reference nextData, initialized OUT/zero Grid2D.cpp:211-218)
        self.next_types = np.full(shape, NodeType.OUT, dtype=np.int8)
        self.next_vel = np.zeros(shape + (2,), dtype=F32)

        self._static_built = False

    # ------------------------------------------------------------ raster
    def _bound_velocity_field(self) -> np.ndarray:
        """3x3 average of next_vel over non-OUT cells (Grid2D.cpp:85-107)."""
        ok = (self.next_types != NodeType.OUT).astype(F32)
        v = self.next_vel * ok[..., None]
        ksum = np.zeros_like(v)
        kcnt = np.zeros_like(ok)
        padv = np.pad(v, ((1, 1), (1, 1), (0, 0)))
        padc = np.pad(ok, ((1, 1), (1, 1)))
        for di in range(3):
            for dj in range(3):
                ksum += padv[di:di + self.dimx, dj:dj + self.dimy]
                kcnt += padc[di:di + self.dimx, dj:dj + self.dimy]
        out = np.zeros_like(ksum)
        nz = kcnt > 0
        out[nz] = ksum[nz] / kcnt[nz][..., None]
        return out.astype(F32)

    def _raster_line(self, p1, p2, v1, v2, color: int, bv_field: Optional[np.ndarray]) -> None:
        """Reference Grid2D.cpp:109-141 (f32 step arithmetic, truncation)."""
        ox = F32(p2[0] - p1[0])
        oy = F32(p2[1] - p1[1])
        steps = int(max(abs(float(ox)), abs(float(oy)))) + 1
        dp = np.array([ox / steps, oy / steps], dtype=F32)
        dv = np.array([(v2[0] - v1[0]) / steps, (v2[1] - v1[1]) / steps], dtype=F32)

        t = np.arange(steps + 1, dtype=F32)[:, None]
        # incremental accumulation in the reference; cumulative-sum form keeps
        # identical trajectory to within one f32 ulp per axis — we reproduce
        # the exact serial accumulation instead to stay bit-identical.
        p = np.empty((steps + 1, 2), dtype=F32)
        v = np.empty((steps + 1, 2), dtype=F32)
        p[0] = np.asarray(p1, dtype=F32)
        v[0] = np.asarray(v1, dtype=F32)
        for s in range(1, steps + 1):
            p[s] = p[s - 1] + dp
            v[s] = v[s - 1] + dv
        del t

        xs = p[:, 0].astype(np.int32)
        ys = p[:, 1].astype(np.int32)

        if self.bc_noslip or bv_field is None:
            vals = v
        else:
            o = np.array([ox, oy], dtype=F32)
            oo = o[0] * o[0] + o[1] * o[1]
            # tangent/normal split of the shape velocity
            lv = (v[:, 0] * o[0] + v[:, 1] * o[1]) / oo
            vt = lv[:, None] * o[None, :]
            vn = v - vt
            # tangent part of the local fluid velocity
            bv = bv_field[xs, ys]
            lb = (bv[:, 0] * o[0] + bv[:, 1] * o[1]) / oo
            bt = lb[:, None] * o[None, :]
            s = F32(self.bc_strength)
            vals = (vn + bt * s + vt * (F32(1.0) - s)).astype(F32)

        # sequential write order preserved (later points overwrite earlier)
        self.cur_types[xs, ys] = color
        self.cur_bct[xs, ys] = BCtype.NOSLIP
        self.cur_vel[xs, ys] = vals
        self.cur_T[xs, ys] = F32(self.start_T)

    def _raster_field(self, field: Field2D) -> None:
        """Reference Grid2D.cpp:143-154 + Field2D::GetVelocity (Geometry.h:284-301)."""
        if field.nx == 0 or field.data is None:
            return
        ii, jj = np.meshgrid(np.arange(1, self.dimx - 1), np.arange(1, self.dimy - 1),
                             indexing="ij")
        x = float(self.scene.bbox_min[0]) + ii * self.dx
        y = float(self.scene.bbox_min[1]) + jj * self.dy
        tx = (x - field.min_x) / field.dx
        ty = (y - field.min_y) / field.dy
        valid = (tx >= 0) & (ty >= 0) & (tx < field.nx - 1) & (ty < field.ny - 1) & (x != 0)
        itx = np.clip(tx.astype(np.int32), 0, field.nx - 1)
        ity = np.clip(ty.astype(np.int32), 0, field.ny - 1)
        vel = field.data[ity, itx]     # data stored (ny, nx, 2) = [t = itx + ity*Nx]
        vel = np.where(valid[..., None], vel, 0.0).astype(F32)
        nz = (vel[..., 0] != 0) | (vel[..., 1] != 0)
        gi = ii[nz]
        gj = jj[nz]
        self.cur_types[gi, gj] = NodeType.BOUND
        self.cur_bct[gi, gj] = BCtype.NOSLIP
        self.cur_vel[gi, gj] = vel[nz]
        self.cur_T[gi, gj] = F32(self.start_T)

    def _raster_shape(self, shp, color, bv_field) -> None:
        from . import native as _native
        if _native.raster_polyline(self.cur_types, self.cur_bct, self.cur_vel,
                                   self.cur_T, shp.points, shp.velocities,
                                   color, self.bc_noslip, self.bc_strength,
                                   self.start_T, bv_field):
            return
        for i in range(len(shp.points) - 1):
            self._raster_line(shp.points[i], shp.points[i + 1],
                              shp.velocities[i], shp.velocities[i + 1],
                              color, bv_field)

    def build(self, frame: Frame2D) -> None:
        """Reference Grid2D::Build (Grid2D.cpp:231-266)."""
        self.cur_types.fill(NodeType.IN)
        bv_field = None if self.bc_noslip else self._bound_velocity_field()

        for shp in frame.shapes:          # VALVE pass: active shapes
            if shp.active:
                self._raster_shape(shp, NodeType.VALVE, bv_field)
        for shp in frame.shapes:          # BOUND pass: passive shapes
            if not shp.active:
                self._raster_shape(shp, NodeType.BOUND, bv_field)

        flood_fill_outside(self.cur_types)
        self._raster_field(frame.field)

        inout = (self.cur_types == NodeType.IN) | (self.cur_types == NodeType.OUT)
        self.cur_bct[inout] = BCtype.NOSLIP
        self.cur_vel[inout] = 0.0
        self.cur_T[inout] = F32(self.start_T)

    # ----------------------------------------------------------- prepare
    def prepare(self, time: float) -> None:
        """Per-step rebuild (Grid2D.cpp:463-478).  Static scenes are cached.

        Note: the reference rebuilds single-frame scenes every step by
        blending the frame with itself, p*(1-s) + p*s, whose result varies
        by ulps with the substep.  The cache instead builds once at the
        canonical substep 0 — deterministic across runs and resume points
        (within one print quantum of the reference's jittering geometry).
        """
        if self.scene.is_static() and self.bc_noslip:
            if not self._static_built:
                self._static_built = True
                self.build(self.scene.compute_subframe(0, 0.0))
            return
        frame, substep = self.scene.frame_substep(time)
        self.build(self.scene.compute_subframe(frame, substep))

    def prepare_frame(self, frame: int, substep: float) -> None:
        self.build(self.scene.compute_subframe(frame % self.scene.num_frames(), substep))

    # ---------------------------------------------------------- feedback
    def set_field_data(self, u: np.ndarray, v: np.ndarray) -> None:
        """Solver writes its velocity back (reference SetGridBoundaries)."""
        self.next_types = self.cur_types.copy()
        self.next_vel = np.stack([u, v], axis=-1).astype(F32)

    # -------------------------------------------------------------- dumps
    def ascii_mask(self) -> str:
        """ASCII art of the mask (reference Grid2D::OutputText, Grid2D.cpp:524-546)."""
        chars = {NodeType.IN: " ", NodeType.OUT: ".", NodeType.BOUND: "#", NodeType.VALVE: "+"}
        rows = []
        for i in range(self.dimx):
            rows.append("".join(chars[NodeType(t)] for t in self.cur_types[i]))
        return "grid view:\n%i %i\n" % (self.dimx, self.dimy) + "\n".join(rows) + "\n"
