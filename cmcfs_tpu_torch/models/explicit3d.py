"""3D explicit Euler step (port of cmcfs_tpu/models/explicit3d.py).

The reference declares a 3D Explicit scheme and never implements it
(FluidSolver3D.cpp:179); cmcfs_tpu's scheme is the 3D form of the 2D one
(ExplicitSolver2D.cpp:54-151): an explicit update of u, v, w and T on
NODE_IN cells with advection, the temperature-gradient forcing of the ADI
scheme, viscosity and dissipation heating, ``num_global`` fixed rounds,
temp re-averaged each round.  PyTorch ops in cmcfs_tpu's order of
operations; no kernel backs it (cmcfs_tpu computes it in XLA ops).
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.types import NodeType
from ..ops import stencil
from .adi3d import ParamsArgs3D
from .common3d import GridArrays3D, State3D

_F = np.float32


def _explicit_update(cur: State3D, temp: State3D, pa: ParamsArgs3D, dt):
    """cmcfs_tpu's _explicit_update (explicit3d.py:27-53): the explicit
    right-hand sides on temp, added to cur."""
    dx, dy, dz = pa.dx, pa.dy, pa.dz
    dt = _F(dt)
    u, v, w, T = temp

    def grad(f):
        return (stencil.d1(f, dx, 0), stencil.d1(f, dy, 1),
                stencil.d1(f, dz, 2))

    def lap(f):
        return (stencil.d2(f, dx, 0) + stencil.d2(f, dy, 1)
                + stencil.d2(f, dz, 2))

    def advect(fx, fy, fz):
        return u * fx + v * fy + w * fz

    ux, uy, uz = grad(u)
    vx, vy, vz = grad(v)
    wx, wy, wz = grad(w)
    tx, ty, tz = grad(T)
    diss = (stencil.diss_x_3d(u, v, w, dx, dy, dz)
            + stencil.diss_y_3d(u, v, w, dx, dy, dz)
            + stencil.diss_z_3d(u, v, w, dx, dy, dz))

    nu = cur.u + dt * (-advect(ux, uy, uz) - pa.v_T * tx + pa.v_vis * lap(u))
    nv = cur.v + dt * (-advect(vx, vy, vz) - pa.v_T * ty + pa.v_vis * lap(v))
    nw = cur.w + dt * (-advect(wx, wy, wz) - pa.v_T * tz + pa.v_vis * lap(w))
    nT = cur.T + dt * (-advect(tx, ty, tz) + pa.t_vis * lap(T)
                       + pa.t_phi * diss)
    return State3D(nu, nv, nw, nT)


def explicit_timestep_3d(cur: State3D, nxt_prev: State3D, ga: GridArrays3D,
                         dt, num_global: int, num_local: int,
                         pa: ParamsArgs3D, compute_error: bool = True):
    """One step (explicit3d.py:56-72): returns (new_cur, err), ``err`` a
    0-d float32 tensor, or -1.0 when ``compute_error`` is False.
    ``nxt_prev`` is the persistent next layer; its BOUND/VALVE cells are
    re-seeded from ``cur``.  ``num_local`` is unused, as in cmcfs_tpu."""
    types = ga.types
    is_in = types == NodeType.IN
    is_bv = (types == NodeType.BOUND) | (types == NodeType.VALVE)
    nxt = State3D(*(torch.where(is_bv, c, n) for c, n in zip(cur, nxt_prev)))
    temp = cur
    for _ in range(num_global):
        sol = _explicit_update(cur, temp, pa, dt)
        nxt = State3D(*(torch.where(is_in, s, n) for n, s in zip(nxt, sol)))
        temp = State3D(*(torch.where(is_in, (t + n) / 2.0, t)
                         for t, n in zip(temp, nxt)))
    if compute_error:
        err = stencil.div_error_3d(nxt.u, nxt.v, nxt.w, types,
                                   pa.dx, pa.dy, pa.dz)
    else:
        err = torch.tensor(-1.0, dtype=torch.float32)
    return nxt, err
