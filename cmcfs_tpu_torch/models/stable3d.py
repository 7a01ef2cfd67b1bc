"""3D Chorin projection ("Stable") step (port of cmcfs_tpu/models/stable3d.py).

The reference declares a 3D Stable scheme and never implements it
(FluidSolver3D.cpp:180); cmcfs_tpu's is the 3D form of the 2D projection
solver (StableSolver2D.cpp): an explicit advect + diffuse of u, v and w,
then a pressure Poisson solve by red-black Gauss-Seidel with reflective
picks on BOUND/VALVE cells, then proj = w - grad(q).  T rides along.
PyTorch ops in cmcfs_tpu's order of operations; the Poisson loop is
``models/poisson.py``'s, which reads its convergence on the host once
every ``check_every`` iterations.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.types import NodeType
from ..ops import stencil
from . import poisson
from .adi3d import ParamsArgs3D
from .common3d import GridArrays3D, State3D

_F = np.float32


def _advect_diffuse(cur: State3D, temp: State3D, pa: ParamsArgs3D, dt):
    """cmcfs_tpu's _advect_diffuse (stable3d.py:26-37)."""
    dx, dy, dz = pa.dx, pa.dy, pa.dz
    dt = _F(dt)
    u, v, w, _ = temp

    def upd(f, base):
        fx = stencil.d1(f, dx, 0)
        fy = stencil.d1(f, dy, 1)
        fz = stencil.d1(f, dz, 2)
        lap = (stencil.d2(f, dx, 0) + stencil.d2(f, dy, 1)
               + stencil.d2(f, dz, 2))
        return base + dt * (-u * fx - v * fy - w * fz + pa.v_vis * lap)

    return upd(u, cur.u), upd(v, cur.v), upd(w, cur.w)


class PoissonMasks3D:
    """What stays constant over a step's projections: the red and black
    masks, the six reflective pick masks ``is_bnd & ~nb_in[t]`` (t = axis
    0 shift +1, -1, axis 1 ..., stable3d.py:62-71) and the weights."""

    def __init__(self, ga: GridArrays3D, pa: ParamsArgs3D):
        types = ga.types
        self.is_in = types == NodeType.IN
        is_bnd = (types == NodeType.BOUND) | (types == NodeType.VALVE)
        active = self.is_in | is_bnd
        nx, ny, nz = types.shape
        dev = types.device
        par = (torch.arange(nx, device=dev)[:, None, None]
               + torch.arange(ny, device=dev)[None, :, None]
               + torch.arange(nz, device=dev)[None, None, :]) % 2
        self.red = (par == 0) & active
        self.black = (par == 1) & active
        self.picks = [is_bnd & ~torch.roll(self.is_in, sh, ax)
                      for ax in range(3) for sh in (1, -1)]
        dx2, dy2, dz2 = pa.dx * pa.dx, pa.dy * pa.dy, pa.dz * pa.dz
        self.dx2, self.dy2, self.dz2 = dx2, dy2, dz2
        self.denom = _F(2.0) * (dy2 * dz2 + dx2 * dz2 + dx2 * dy2)
        self.w_ax = (dy2 * dz2, dy2 * dz2, dx2 * dz2, dx2 * dz2, dx2 * dy2,
                     dx2 * dy2)


def _poisson_project(wu, wv, ww, ga: GridArrays3D, pa: ParamsArgs3D,
                     masks: PoissonMasks3D | None = None,
                     check_every: int = poisson.CHECK_EVERY):
    """cmcfs_tpu's _poisson_project (stable3d.py:40-101): returns
    ((pu, pv, pw), iterations)."""
    m = masks or PoissonMasks3D(ga, pa)
    div = torch.where(m.is_in,
                      stencil.d1(wu, pa.dx, 0) + stencil.d1(wv, pa.dy, 1)
                      + stencil.d1(ww, pa.dz, 2), 0.0)
    rhs = div * (m.dx2 * m.dy2 * m.dz2)

    def gs_value(q):
        qs = [torch.roll(q, sh, ax) for ax in range(3) for sh in (1, -1)]
        # reflective picks on boundary cells; Python's sum, from 0
        picks = [torch.where(m.picks[t], qs[t + 1 if t % 2 == 0 else t - 1],
                             qs[t]) for t in range(6)]
        s = sum(p * w for p, w in zip(picks, m.w_ax))
        return stencil.over(s - rhs, m.denom)

    q, iters = poisson.iterate(
        poisson.redblack_sweep(gs_value, m.red, m.black),
        torch.zeros_like(wu), check_every=check_every)
    return ((wu - stencil.d1(q, pa.dx, 0), wv - stencil.d1(q, pa.dy, 1),
             ww - stencil.d1(q, pa.dz, 2)), iters)


def stable_timestep_3d(cur: State3D, nxt_prev: State3D, ga: GridArrays3D,
                       dt, num_global: int, num_local: int,
                       pa: ParamsArgs3D, compute_error: bool = True,
                       check_every: int = poisson.CHECK_EVERY):
    """One step (stable3d.py:103-126): returns (new_cur, err, iters), err
    a 0-d float32 tensor (-1.0 when ``compute_error`` is False), iters the
    Poisson iteration count of each global iteration.  ``num_local`` is
    unused, as in cmcfs_tpu."""
    m = PoissonMasks3D(ga, pa)
    is_in = m.is_in
    is_bv = (ga.types == NodeType.BOUND) | (ga.types == NodeType.VALVE)
    nxt = State3D(*(torch.where(is_bv, c, n) for c, n in zip(cur, nxt_prev)))
    temp = cur
    iters = []
    for _ in range(num_global):
        wu, wv, ww = _advect_diffuse(cur, temp, pa, dt)
        wu = torch.where(is_in, wu, cur.u)
        wv = torch.where(is_in, wv, cur.v)
        ww = torch.where(is_in, ww, cur.w)
        (pu, pv, pw), its = _poisson_project(wu, wv, ww, ga, pa, m,
                                             check_every)
        iters.append(its)
        nxt = State3D(u=torch.where(is_in, pu, nxt.u),
                      v=torch.where(is_in, pv, nxt.v),
                      w=torch.where(is_in, pw, nxt.w), T=nxt.T)
        temp = State3D(*(torch.where(is_in, (t + n) / 2.0, t)
                         for t, n in zip(temp, nxt)))
    if compute_error:
        err = stencil.div_error_3d(nxt.u, nxt.v, nxt.w, ga.types,
                                   pa.dx, pa.dy, pa.dz)
    else:
        err = torch.tensor(-1.0, dtype=torch.float32)
    return nxt, err, iters
