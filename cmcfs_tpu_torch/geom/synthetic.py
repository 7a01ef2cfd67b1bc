"""Synthetic benchmark grids (no scene files needed).

A driven box cavity: 1-cell OUT border (like the reference's bbox padding),
1-cell NOSLIP BOUND shell, a moving-lid VALVE plane injecting momentum, IN
interior.  Matches the structure the reference's extruded box_pipe case
produces, at any requested size — used by bench.py and the graft entry.
"""
from __future__ import annotations

import numpy as np

from ..core.types import NodeType, BCtype
from .grid3d import Grid3D

F32 = np.float32


def lid_cavity_3d(nx: int, ny: int, nz: int, dx: float = 0.01,
                  lid_velocity: float = 0.5, base_T: float = 1.0) -> Grid3D:
    g = Grid3D(nx, ny, nz, dx, dx, dx, base_T)
    g.types.fill(NodeType.OUT)
    g.types[1:-1, 1:-1, 1:-1] = NodeType.BOUND
    g.types[2:-2, 2:-2, 2:-2] = NodeType.IN
    g.bc_vel.fill(BCtype.NOSLIP)
    g.bc_temp.fill(BCtype.NOSLIP)
    g.vel.fill(0.0)
    g.T.fill(F32(base_T))

    # moving lid: the top BOUND plane becomes a VALVE with tangential velocity
    lid = np.zeros_like(g.types, dtype=bool)
    lid[2:-2, 2:-2, -2] = True
    g.types[lid] = NodeType.VALVE
    g.vel[lid] = np.array([lid_velocity, 0.0, 0.0], dtype=F32)
    # warm temperature gradient so the T equation does real work
    g.T[lid] = F32(base_T * 1.1)

    g.bbox_min = np.zeros(3, dtype=F32)
    g.bbox_max = np.array([nx * dx, ny * dx, nz * dx], dtype=F32)
    g.num_frames = 1
    g.cycle_len = 1.0
    return g


def lid_cavity_2d(nx: int, ny: int, dx: float = 0.01, lid_velocity: float = 0.5,
                  base_T: float = 1.0):
    """2D analogue used by the 2D benchmarks (bypasses scene building)."""
    from .raster2d import Grid2D
    from ..core.scene2d import Scene2D

    sc = Scene2D()
    sc.dimx, sc.dimy = nx, ny
    sc.dx = sc.dy = dx
    sc.bbox_min = np.zeros(2, dtype=F32)
    sc.bbox_max = np.array([nx * dx, ny * dx], dtype=F32)
    sc.frames = []
    g = Grid2D.__new__(Grid2D)
    g.scene = sc
    g.dimx, g.dimy = nx, ny
    g.dx = g.dy = dx
    g.start_T = base_T
    g.bc_noslip = True
    g.bc_strength = 0.0
    g._static_built = True
    g.cur_types = np.full((nx, ny), NodeType.OUT, dtype=np.int8)
    g.cur_types[1:-1, 1:-1] = NodeType.BOUND
    g.cur_types[2:-2, 2:-2] = NodeType.IN
    g.cur_bct = np.full((nx, ny), BCtype.NOSLIP, dtype=np.int8)
    g.cur_vel = np.zeros((nx, ny, 2), dtype=F32)
    g.cur_T = np.full((nx, ny), F32(base_T), dtype=F32)
    g.cur_types[2:-2, ny - 2] = NodeType.VALVE
    g.cur_vel[2:-2, ny - 2] = np.array([lid_velocity, 0.0], dtype=F32)
    g.next_types = np.full((nx, ny), NodeType.OUT, dtype=np.int8)
    g.next_vel = np.zeros((nx, ny, 2), dtype=F32)
    return g
