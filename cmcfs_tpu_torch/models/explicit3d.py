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
from .common3d import (GridArrays3D, State3D, exchange_states,
                       finish_step, is_bv)

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


def explicit_timestep_3d(cur, nxt_prev, ga: GridArrays3D, dt,
                         num_global: int, num_local: int, pa: ParamsArgs3D,
                         compute_error: bool = True, plan=None):
    """One step (explicit3d.py:56-72): returns (new_cur, err), ``err`` a
    0-d float32 tensor, or -1.0 when ``compute_error`` is False.
    ``nxt_prev`` is the persistent next layer; its BOUND/VALVE cells are
    re-seeded from ``cur``.  ``num_local`` is unused, as in cmcfs_tpu.

    ``plan`` (``parallel.mesh.ShardingPlan``) splits X over its shards, as
    the ADI step does: ``cur`` and ``nxt_prev`` are the plan's X slabs of
    the stacked (4, nx, ny, nz) state, ``ga`` the grid's ShardedGrid, and
    the new state comes back as slabs.  The stencils read one plane past
    each cell, so temp's halos are exchanged before each update and the
    new state's before the error; every owned cell then reads what it
    reads on one device, and the fields equal the single device's bit
    for bit (the error up to the order of its sums)."""
    if plan is None:
        curs, nxts, gas = [cur], [nxt_prev], [ga]
    else:
        curs, nxts = ([State3D(*s.unbind(0)) for s in st]
                      for st in (cur, nxt_prev))
        gas = list(ga.x)
    is_in = [g.types == NodeType.IN for g in gas]
    nxts = [State3D(*(torch.where(is_bv(g), c, n) for c, n in zip(cs, ns)))
            for g, cs, ns in zip(gas, curs, nxts)]
    temps = list(curs)
    for _ in range(num_global):
        if plan is not None:
            exchange_states(plan, temps)
        for i, (c, t, m) in enumerate(zip(curs, temps, is_in)):
            sol = _explicit_update(c, t, pa, dt)
            nxts[i] = State3D(*(torch.where(m, s, n)
                                for n, s in zip(nxts[i], sol)))
            temps[i] = State3D(*(torch.where(m, (a + n) / 2.0, a)
                                 for a, n in zip(t, nxts[i])))
    return finish_step(nxts, ga, pa, compute_error, plan)

