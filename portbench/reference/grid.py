"""The plain grid derivation: cell types, boundary conditions and values,
line classes, from a configuration's own description.

NumPy only.  It follows the semantics of the cmc-fluid-solver reference
that the measured program ports (node types and boundary values as
Grid3D.h:73-88 holds them, the 3D multi-run segment scan of
Grid3D.cpp:47-127) in plain array code, so that the grid the program's
set-up builds can be held against it cell by cell.

Codes: node types IN 0, OUT 1, BOUND 2, VALVE 3; BCs NOSLIP 0, FREE 1;
row classes IDENTITY 0, BC0 1, BC1 2, INTERIOR 3.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np

IN, OUT, BOUND, VALVE = 0, 1, 2, 3
NOSLIP, FREE = 0, 1
IDENTITY, BC0, BC1, INTERIOR = 0, 1, 2, 3

F32 = np.float32


class Grid(NamedTuple):
    types: np.ndarray      # (nx, ny, nz) int8
    bc_vel: np.ndarray     # int8
    bc_temp: np.ndarray    # int8
    vel: np.ndarray        # (nx, ny, nz, 3) float32
    T: np.ndarray          # float32
    dx: float
    dy: float
    dz: float


class Params(NamedTuple):
    """The four physical coefficients, each rounded to float32."""
    v_T: float
    v_vis: float
    t_vis: float
    t_phi: float


def normalized(Re: float, Pr: float, lam: float) -> Params:
    """Coefficients from (Re, Pr, lambda), Geometry.h:545-552."""
    return Params(float(F32(1.0)), float(F32(1.0 / Re)),
                  float(F32(1.0 / (Re * Pr))),
                  float(F32((lam - 1.0) / (lam * Re))))


def lid_cavity_grid(shape: tuple, dx: float, lid_velocity: float,
                    base_T: float, lid_T: float, baffle: bool) -> Grid:
    """The lid-driven cavity: an OUT border, a no-slip wall shell, the top
    wall plane (the last Z plane of the shell) a valve moving along X at
    ``lid_velocity`` with the temperature ``lid_T``.  With ``baffle``, a
    one-cell wall at mid-X, free in temperature, pierced by a two-cell
    slot of fluid along Y."""
    nx, ny, nz = shape
    types = np.full(shape, OUT, dtype=np.int8)
    types[1:-1, 1:-1, 1:-1] = BOUND
    types[2:-2, 2:-2, 2:-2] = IN
    bcv = np.full(shape, NOSLIP, dtype=np.int8)
    bct = np.full(shape, NOSLIP, dtype=np.int8)
    vel = np.zeros(shape + (3,), dtype=F32)
    T = np.full(shape, F32(base_T), dtype=F32)
    lid = np.zeros(shape, dtype=bool)
    lid[2:-2, 2:-2, -2] = True
    types[lid] = VALVE
    vel[lid] = np.array([lid_velocity, 0.0, 0.0], dtype=F32)
    T[lid] = F32(lid_T)
    if baffle:
        mid = nx // 2
        types[mid, 2:-2, 2:-2] = BOUND
        types[mid, ny // 2 - 1:ny // 2 + 1, 2:-2] = IN
        wall = np.zeros(shape, dtype=bool)
        wall[mid, 2:-2, 2:-2] = True
        bct[wall & (types == BOUND)] = FREE
    return Grid(types, bcv, bct, vel, T, dx, dx, dx)


def _classes_last_axis(t: np.ndarray):
    """(cls_a, cls_b | None, take_b | None) of the lines along the last
    axis: maximal IN runs, each with a start endpoint before it and an end
    endpoint after it; a run that reaches the line's end is never closed
    and dropped; an IN cell at position 0 is never a run interior; a cell
    that ends one run and starts the next is a dual: END role in pass A,
    START role in pass B, and pass B's value wins on that cell and on the
    segment that starts there (Grid3D.cpp:47-127)."""
    n = t.shape[-1]
    is_in = t == IN
    reach_end = np.zeros_like(is_in)
    reach_end[..., -1] = is_in[..., -1]
    for p in range(n - 2, -1, -1):
        reach_end[..., p] = is_in[..., p] & reach_end[..., p + 1]
    run = is_in & ~reach_end
    starts_run = np.zeros_like(run)
    starts_run[..., :-1] = run[..., 1:]
    after_in = np.zeros_like(is_in)
    after_in[..., 1:] = is_in[..., :-1]
    not_in = ~is_in
    not_in[..., 0] = True
    start = starts_run & not_in
    end = ~is_in & after_in
    end[..., :2] = False
    cls_a = np.zeros(t.shape, dtype=np.int8)
    cls_a[run] = INTERIOR
    cls_a[..., 0] = IDENTITY
    cls_a[start] = BC0
    cls_a[end] = BC1
    dual = start & end
    if not dual.any():
        return cls_a, None, None
    cls_b = cls_a.copy()
    cls_b[dual] = BC0
    take = dual.copy()
    for p in range(1, n):
        take[..., p] |= take[..., p - 1] & run[..., p]
    take[..., 1:] |= take[..., :-1] & end[..., 1:]
    return cls_a, cls_b, take


def line_classes(g: Grid) -> list:
    """Per axis (cls_a, cls_b | None, take_b | None).  A pass B whose dual
    cells are all Dirichlet in velocity and in temperature solves the
    same rows as pass A there, so it is dropped."""
    out = []
    for ax in range(3):
        a, b, tb = (None if c is None else np.moveaxis(c, -1, ax)
                    for c in _classes_last_axis(np.moveaxis(g.types, ax,
                                                            -1)))
        if b is not None:
            dual = a != b
            if (g.bc_vel[dual] != FREE).all() and (g.bc_temp[dual]
                                                   != FREE).all():
                b = tb = None
        out.append((a, b, tb))
    return out


def merge_ok(g: Grid, classes: list) -> tuple:
    """Per axis: the interior rows are exactly the IN cells."""
    is_in = g.types == IN
    return tuple(bool(np.array_equal(a == INTERIOR, is_in))
                 for a, _, _ in classes)


def initial_state(g: Grid) -> np.ndarray:
    """The stacked (4, nx, ny, nz) u, v, w, T a run starts from: every
    cell's grid values (TimeLayer3D.h:734-781)."""
    return np.stack([g.vel[..., 0], g.vel[..., 1], g.vel[..., 2],
                     g.T]).astype(F32)
