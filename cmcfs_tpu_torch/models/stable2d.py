"""2D Chorin projection ("Stable Fluids") step (port of
cmcfs_tpu/models/stable2d.py; the reference is
src/FluidSolver2D/StableSolver2D.cpp).

An explicit advect + diffuse of u and v into w (:56-82), a pressure
Poisson solve with reflective Neumann picks on boundary cells (:84-151),
then proj = w - grad(q) (:156-163); T rides along.  Two Poisson modes, as
in cmcfs_tpu:

* ``redblack``: red-black Gauss-Seidel half sweeps, on ``models/poisson.py``'s
  loop (the host reads the convergence once every ``check_every``
  iterations);
* ``sequential``: the reference's exact order (cmcfs_tpu's
  ``_project_sequential``): one Jacobi-equivalent pass over the boundary
  cells, then the inner cells by anti-diagonal waves (i + j = k), each
  reading new values at (i-1, j) and (i, j-1).  cmcfs_tpu computes every
  wave over the whole field, O(n^3) a sweep; here each wave updates only
  its own cells, gathered by index lists built once a step, O(n^2)
  a sweep, with the same arithmetic a cell.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.types import NodeType
from ..ops import stencil
from . import poisson
from .adi2d import ParamsArgs
from .common2d import GridArrays2D, State2D
from .explicit2d import global_loop

DIV_ERR_THRESHOLD = 0.1        # reference StableSolver2D.h:23

_F = np.float32


def _advect_diffuse(cur: State2D, temp: State2D, pa: ParamsArgs, dt):
    """SolveU/SolveV (StableSolver2D.cpp:56-82), no temperature forcing
    (cmcfs_tpu's stable2d.py:45-56)."""
    dx, dy = pa.dx, pa.dy
    dt = _F(dt)
    u, v, _ = temp
    ux = stencil.d1(u, dx, 0); uy = stencil.d1(u, dy, 1)
    vx = stencil.d1(v, dx, 0); vy = stencil.d1(v, dy, 1)
    uxx = stencil.d2(u, dx, 0); uyy = stencil.d2(u, dy, 1)
    vxx = stencil.d2(v, dx, 0); vyy = stencil.d2(v, dy, 1)
    nu = cur.u + dt * (-u * ux - v * uy + pa.v_vis * (uxx + uyy))
    nv = cur.v + dt * (-u * vx - v * vy + pa.v_vis * (vxx + vyy))
    return nu, nv


class _Poisson2D:
    """A projection's constants (stable2d.py:62-97): masks, reflective
    picks, weights and the right-hand side."""

    def __init__(self, wu, wv, ga: GridArrays2D, pa: ParamsArgs):
        types = ga.types
        self.is_in = types == NodeType.IN
        self.is_bnd = (types == NodeType.BOUND) | (types == NodeType.VALVE)
        active = self.is_in | self.is_bnd
        self.dx2, self.dy2 = pa.dx * pa.dx, pa.dy * pa.dy
        self.rcp = _F(0.5) / (self.dx2 + self.dy2)
        div = torch.where(self.is_in, stencil.d1(wu, pa.dx, 0)
                          + stencil.d1(wv, pa.dy, 1), 0.0)
        self.rhs = div * (self.dx2 * self.dy2)
        dimx, dimy = types.shape
        dev = types.device
        par = (torch.arange(dimx, device=dev)[:, None]
               + torch.arange(dimy, device=dev)[None, :]) % 2
        self.red = (par == 0) & active
        self.black = (par == 1) & active
        # (i-1, j), (i+1, j), (i, j-1), (i, j+1) not IN, on boundary cells
        self.pick_w, self.pick_e, self.pick_s, self.pick_n = (
            self.is_bnd & ~torch.roll(self.is_in, sh, ax)
            for ax, sh in ((0, 1), (0, -1), (1, 1), (1, -1)))

    def gs_value(self, q):
        """The Gauss-Seidel value of every cell from q (stable2d.py
        :88-97)."""
        qw = torch.roll(q, 1, 0)
        qe = torch.roll(q, -1, 0)
        qs = torch.roll(q, 1, 1)
        qn = torch.roll(q, -1, 1)
        i0 = torch.where(self.pick_w, qe, qw)
        i1 = torch.where(self.pick_e, qw, qe)
        j0 = torch.where(self.pick_s, qn, qs)
        j1 = torch.where(self.pick_n, qs, qn)
        return self.rcp * ((i0 + i1) * self.dy2 + (j0 + j1) * self.dx2
                           - self.rhs)


class WaveIndex:
    """The inner cells of a grid by anti-diagonal wave (i + j = k), built
    once a step: ``nb`` (5, cells) holds each cell's flat index and those
    of (i-1, j), (i+1, j), (i, j-1), (i, j+1), wrapping as ``torch.roll``
    does, the cells in wave order; ``waves`` the (start, end) of each
    non-empty wave; ``keys`` the cells' places in the reference's
    (boundary-lex, inner-lex) processing order, -1 elsewhere."""

    def __init__(self, ga: GridArrays2D):
        types = ga.types.cpu().numpy()
        dimx, dimy = types.shape
        dev = ga.types.device
        ii, jj = np.meshgrid(np.arange(dimx), np.arange(dimy), indexing="ij")
        inner = types == NodeType.IN
        i, j = ii[inner], jj[inner]
        order = np.argsort(i + j, kind="stable")
        i, j = i[order], j[order]
        nb = np.stack([i * dimy + j, (i - 1) % dimx * dimy + j,
                       (i + 1) % dimx * dimy + j, i * dimy + (j - 1) % dimy,
                       i * dimy + (j + 1) % dimy])
        self.nb = torch.tensor(nb, dtype=torch.int64, device=dev)
        bounds = np.searchsorted(i + j, np.arange(dimx + dimy), side="left")
        self.waves = [(int(a), int(b)) for a, b in zip(bounds[:-1], bounds[1:])
                      if b > a]
        is_bnd = (ga.types == NodeType.BOUND) | (ga.types == NodeType.VALVE)
        lex = torch.arange(dimx * dimy, device=dev).reshape(dimx, dimy)
        self.keys = torch.where(is_bnd, lex,
                                torch.where(ga.types == NodeType.IN,
                                            lex + dimx * dimy, -1))


class SequentialSweep:
    """One reference-order sweep (stable2d.py:128-187) as
    ``poisson.iterate``'s ``sweep(q, go) -> (q, err)``: the boundary pass
    over the whole field, then the inner cells wave by wave, each wave's
    cells gathered by ``WaveIndex``.  Inner cells are never boundary
    cells, so their picks are their neighbours, and a wave's cells are not
    neighbours of each other: gathering a wave before writing it equals
    the whole-field form.  The error is cmcfs_tpu's closed form of the C
    max-chain: the max over the cells after the last NaN in processing
    order."""

    def __init__(self, p: _Poisson2D, w: WaveIndex):
        self.p, self.w = p, w
        self.rhs_in = p.rhs.reshape(-1)[w.nb[0]]

    def __call__(self, q, go):
        p, nb, keys = self.p, self.w.nb, self.w.keys
        qb_new = p.gs_value(q)
        rel_b = torch.abs((qb_new - q) / qb_new)     # raw C semantics
        q0 = torch.where(p.is_bnd, qb_new, q)
        qf = q0.reshape(-1).clone()
        for a, b in self.w.waves:
            g = qf[nb[:, a:b]]
            qf[nb[0, a:b]] = p.rcp * ((g[1] + g[2]) * p.dy2
                                      + (g[3] + g[4]) * p.dx2
                                      - self.rhs_in[a:b])
        q1 = qf.reshape(q.shape)
        rel = torch.where(p.is_bnd, rel_b,
                          torch.where(p.is_in, torch.abs((q1 - q0) / q1), 0.0))
        nan_keys = torch.where(torch.isnan(rel) & (keys >= 0), keys, -1)
        sel = keys > torch.amax(nan_keys)
        err = torch.where(torch.any(sel),
                          torch.amax(torch.where(sel, rel, -float("inf"))),
                          float("nan"))
        if go is not None:
            q1 = torch.where(go, q1, q)
        return q1, err


def _poisson_project(wu, wv, ga: GridArrays2D, pa: ParamsArgs,
                     mode: str = "redblack", waves: WaveIndex | None = None,
                     check_every: int = poisson.CHECK_EVERY):
    """Pressure Poisson (reference Project, :84-164; cmcfs_tpu's
    stable2d.py:58-126): returns ((pu, pv), iterations).  ``waves``: the
    grid's ``WaveIndex`` for ``sequential`` (built here when None)."""
    p = _Poisson2D(wu, wv, ga, pa)
    if mode == "sequential":
        sweep = SequentialSweep(p, waves or WaveIndex(ga))
        q, err = sweep(torch.zeros_like(wu), None)    # do-while: >= 1 sweep
        q, iters = poisson.iterate(sweep, q, 1, float(err), check_every)
    else:
        q, iters = poisson.iterate(
            poisson.redblack_sweep(p.gs_value, p.red, p.black),
            torch.zeros_like(wu), check_every=check_every)
    return ((wu - stencil.d1(q, pa.dx, 0), wv - stencil.d1(q, pa.dy, 1)),
            iters)


def stable_timestep_2d(cur: State2D, nxt0: State2D, ga: GridArrays2D, dt,
                       num_global: int, num_local: int, pa: ParamsArgs,
                       mode: str = "redblack",
                       check_every: int = poisson.CHECK_EVERY):
    """One reference TimeStep (StableSolver2D.cpp:190-234; cmcfs_tpu's
    stable2d.py:189-218): returns (new_cur, err, iterations,
    poisson_iters), the last the Poisson iteration count of each global
    iteration."""
    is_in = ga.types == NodeType.IN
    waves = WaveIndex(ga) if mode == "sequential" else None
    poisson_iters = []

    def solve(temp, nxt):
        wu_full, wv_full = _advect_diffuse(cur, temp, pa, dt)
        # next_w = cur, updated on IN cells only (:202-206)
        wu = torch.where(is_in, wu_full, cur.u)
        wv = torch.where(is_in, wv_full, cur.v)
        (pu, pv), its = _poisson_project(wu, wv, ga, pa, mode, waves,
                                         check_every)
        poisson_iters.append(its)
        return State2D(u=torch.where(is_in, pu, nxt.u),
                       v=torch.where(is_in, pv, nxt.v), T=nxt.T)

    nxt, err, it = global_loop(cur, nxt0, ga, pa, num_global,
                               DIV_ERR_THRESHOLD, solve)
    return nxt, err, it, poisson_iters
