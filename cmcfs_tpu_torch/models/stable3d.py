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
from .common3d import (GridArrays3D, State3D, exchange_states,
                       finish_step, is_bv)

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
    0 shift +1, -1, axis 1 ..., stable3d.py:62-71) and the weights.

    On an X slab (``slab``: the grid's arrays of one shard, its halo
    planes the neighbours' planes) a cell's colour follows its X index in
    the grid, ``x0`` + its index in the slab, and the halo planes take no
    colour: a half sweep updates the planes the shard owns.  The picks
    roll ``is_in`` across the cut onto the halo planes, which hold the
    neighbours' types, so an owned cell's picks are the grid's."""

    def __init__(self, ga: GridArrays3D, pa: ParamsArgs3D, x0: int = 0,
                 slab: bool = False):
        types = ga.types
        self.is_in = types == NodeType.IN
        is_bnd = (types == NodeType.BOUND) | (types == NodeType.VALVE)
        active = self.is_in | is_bnd
        if slab:
            active = active.clone()
            active[0] = active[-1] = False
        nx, ny, nz = types.shape
        dev = types.device
        par = (torch.arange(x0, x0 + nx, device=dev)[:, None, None]
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


def _gs_value(wu, wv, ww, m: PoissonMasks3D, pa: ParamsArgs3D):
    """The Gauss-Seidel value of every cell as a function of q, on the
    divergence of (wu, wv, ww) (stable3d.py:49-82)."""
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

    return gs_value


def _projected(wu, wv, ww, q, pa: ParamsArgs3D):
    """proj = w - grad(q) (stable3d.py:98-101)."""
    return (wu - stencil.d1(q, pa.dx, 0), wv - stencil.d1(q, pa.dy, 1),
            ww - stencil.d1(q, pa.dz, 2))


def _poisson_project(wu, wv, ww, ga: GridArrays3D, pa: ParamsArgs3D,
                     masks: PoissonMasks3D | None = None,
                     check_every: int = poisson.CHECK_EVERY):
    """cmcfs_tpu's _poisson_project (stable3d.py:40-101): returns
    ((pu, pv, pw), iterations)."""
    m = masks or PoissonMasks3D(ga, pa)
    gs_value = _gs_value(wu, wv, ww, m, pa)
    q, iters = poisson.iterate(
        poisson.redblack_sweep(gs_value, m.red, m.black),
        torch.zeros_like(wu), check_every=check_every)
    return _projected(wu, wv, ww, q, pa), iters


def _poisson_project_split(ws: list, ms: list, pa: ParamsArgs3D, plan,
                           check_every: int = poisson.CHECK_EVERY):
    """``_poisson_project`` over the X slabs of ``plan``: ``ws`` one (wu,
    wv, ww) a shard, ``ms`` its slab's masks.  The halos of ws are filled
    before the divergence, q's before each half sweep and before the
    gradient; each half sweep runs on every shard, and the loop stops on
    the max of the shards' errors (``plan.all_max``).  Returns (one (pu,
    pv, pw) a shard, iterations)."""
    exchange_states(plan, ws)
    gss = [_gs_value(*w, m, pa) for w, m in zip(ws, ms)]

    def sweep(qs, gos):
        errs = []
        for colour in ("red", "black"):
            plan.exchange(qs, -3)
            halves = [poisson.half_sweep(gs, q, getattr(m, colour) & go)
                      for gs, q, m, go in zip(gss, qs, ms, gos)]
            qs = [h[0] for h in halves]
            errs.append([h[1] for h in halves])
        return qs, [torch.maximum(a, b) for a, b in zip(*errs)]

    qs, iters = poisson.iterate(sweep, [torch.zeros_like(w[0]) for w in ws],
                                check_every=check_every,
                                all_max=plan.all_max)
    plan.exchange(qs, -3)
    return [_projected(*w, q, pa) for w, q in zip(ws, qs)], iters


def stable_timestep_3d(cur, nxt_prev, ga, dt, num_global: int,
                       num_local: int, pa: ParamsArgs3D,
                       compute_error: bool = True,
                       check_every: int = poisson.CHECK_EVERY, plan=None):
    """One step (stable3d.py:103-126): returns (new_cur, err, iters), err
    a 0-d float32 tensor (-1.0 when ``compute_error`` is False), iters the
    Poisson iteration count of each global iteration.  ``num_local`` is
    unused, as in cmcfs_tpu.

    ``plan``: the X split, as ``explicit3d.explicit_timestep_3d`` takes
    it.  temp's halos are filled before each advect-diffuse, and the
    projection runs over the slabs (``_poisson_project_split``), coloured
    by the grid's own X index, so the fields and the Poisson counts equal
    the single device's bit for bit."""
    if plan is None:
        curs, nxts, gas = [cur], [nxt_prev], [ga]
        ms = [PoissonMasks3D(ga, pa)]
    else:
        curs, nxts = ([State3D(*s.unbind(0)) for s in st]
                      for st in (cur, nxt_prev))
        gas = list(ga.x)
        ms = [PoissonMasks3D(g, pa, x0, slab=True)
              for g, x0 in zip(gas, ga.x0)]
    is_in = [m.is_in for m in ms]
    nxts = [State3D(*(torch.where(is_bv(g), c, n) for c, n in zip(cs, ns)))
            for g, cs, ns in zip(gas, curs, nxts)]
    temps = list(curs)
    iters = []
    for _ in range(num_global):
        if plan is not None:
            exchange_states(plan, temps)
        ws = []
        for c, t, m in zip(curs, temps, is_in):
            wu, wv, ww = _advect_diffuse(c, t, pa, dt)
            ws.append((torch.where(m, wu, c.u), torch.where(m, wv, c.v),
                       torch.where(m, ww, c.w)))
        if plan is None:
            proj, its = _poisson_project(*ws[0], ga, pa, ms[0], check_every)
            projs = [proj]
        else:
            projs, its = _poisson_project_split(ws, ms, pa, plan,
                                                check_every)
        iters.append(its)
        for i, ((pu, pv, pw), m) in enumerate(zip(projs, is_in)):
            n = nxts[i]
            nxts[i] = State3D(u=torch.where(m, pu, n.u),
                              v=torch.where(m, pv, n.v),
                              w=torch.where(m, pw, n.w), T=n.T)
            temps[i] = State3D(*(torch.where(m, (t + x) / 2.0, t)
                                 for t, x in zip(temps[i], nxts[i])))
    nxt, err = finish_step(nxts, ga, pa, compute_error, plan)
    return nxt, err, iters
