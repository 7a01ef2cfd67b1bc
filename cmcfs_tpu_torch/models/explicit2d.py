"""2D explicit Euler step (port of cmcfs_tpu/models/explicit2d.py; the
reference is src/FluidSolver2D/ExplicitSolver2D.cpp).

Per global iteration: an explicit update of u, v and T on NODE_IN cells
with advection, temperature-gradient forcing, viscosity and dissipation
heating (SolveU/V/T :54-109), then temp <- (temp + next)/2 on IN cells;
the loop runs while (it < num_global) or (div error > 0.1), at most
MAX_GLOBAL_ITERS + 2 times, on the host as ``adi2d``'s does: the error is
read once a global iteration past ``num_global``.  PyTorch ops in
cmcfs_tpu's order of operations.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.types import NodeType
from ..ops import stencil
from .adi2d import ParamsArgs
from .common2d import GridArrays2D, State2D, clear_outer

ERR_THRESHOLD = 0.1        # reference ExplicitSolver2D.h:21
MAX_GLOBAL_ITERS = 100

_F = np.float32


def _explicit_update(cur: State2D, temp: State2D, pa: ParamsArgs, dt):
    """cmcfs_tpu's _explicit_update (explicit2d.py:26-40)."""
    dx, dy = pa.dx, pa.dy
    dt = _F(dt)
    u, v, T = temp
    ux = stencil.d1(u, dx, 0); uy = stencil.d1(u, dy, 1)
    vx = stencil.d1(v, dx, 0); vy = stencil.d1(v, dy, 1)
    tx = stencil.d1(T, dx, 0); ty = stencil.d1(T, dy, 1)
    uxx = stencil.d2(u, dx, 0); uyy = stencil.d2(u, dy, 1)
    vxx = stencil.d2(v, dx, 0); vyy = stencil.d2(v, dy, 1)
    txx = stencil.d2(T, dx, 0); tyy = stencil.d2(T, dy, 1)
    diss = (stencil.diss_x_2d(u, v, dx, dy) + stencil.diss_y_2d(u, v, dx, dy))

    nu = cur.u + dt * (-u * ux - v * uy - pa.v_T * tx
                       + pa.v_vis * (uxx + uyy))
    nv = cur.v + dt * (-u * vx - v * vy - pa.v_T * ty
                       + pa.v_vis * (vxx + vyy))
    nT = cur.T + dt * (-u * tx - v * ty + pa.t_vis * (txx + tyy)
                       + pa.t_phi * diss)
    return State2D(nu, nv, nT)


def global_loop(cur: State2D, nxt0: State2D, ga: GridArrays2D, pa, num_global,
                threshold: float, solve):
    """cmcfs_tpu's global while loop (explicit2d.py:55-69, stable2d.py
    :199-215) on the host: ``solve(temp, nxt) -> nxt`` once a global
    iteration, then the error and temp's re-average on IN cells; err is
    read only once ``it >= num_global``.  Returns (clear_outer(nxt), err,
    iterations)."""
    is_in = ga.types == NodeType.IN
    temp, nxt = cur, nxt0
    err = stencil.div_error_2d(nxt.u, nxt.v, ga.types, pa.dx, pa.dy)
    it = 0
    while it < MAX_GLOBAL_ITERS + 2:
        if it >= num_global and not float(err) > threshold:
            break
        nxt = solve(temp, nxt)
        err = stencil.div_error_2d(nxt.u, nxt.v, ga.types, pa.dx, pa.dy)
        temp = State2D(*(torch.where(is_in, (t + n) / 2.0, t)
                         for t, n in zip(temp, nxt)))
        it += 1
    return clear_outer(nxt, ga, pa.start_T), err, it


def explicit_timestep_2d(cur: State2D, nxt0: State2D, ga: GridArrays2D, dt,
                         num_global: int, num_local: int, pa: ParamsArgs):
    """One reference TimeStep (ExplicitSolver2D.cpp:111-151): returns
    (new_cur, err, iterations).  ``nxt0`` is the persistent next layer
    (the scheme overwrites only its IN cells).  The reference's
    ``num_local`` loop recomputes the same update, so one evaluation is
    exact (cmcfs_tpu's reading, explicit2d.py:6-8)."""
    is_in = ga.types == NodeType.IN

    def solve(temp, nxt):
        sol = _explicit_update(cur, temp, pa, dt)
        return State2D(*(torch.where(is_in, s, n) for n, s in zip(nxt, sol)))

    return global_loop(cur, nxt0, ga, pa, num_global, ERR_THRESHOLD, solve)
