"""Stateful 3D solvers (port of cmcfs_tpu/models/solver3d.py).

The reference implements only ADI for 3D (FluidSolver3D.cpp:177-190);
cmcfs_tpu adds Explicit and Stable (models/explicit3d.py,
models/stable3d.py), and so does the port.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.params import FluidParams
from ..core.types import NodeType
from ..device import get_device
from ..geom.grid3d import Grid3D
from . import adi3d, explicit3d, stable3d
from .common3d import (State3D, get_layer, grid_arrays, init_state,
                       merge_ok, shard_grid, update_boundaries, update_slabs)


class SolverError(RuntimeError):
    """Raised where the reference would print and exit(1)."""


class AdiSolver3D:
    name = "ADI"

    def __init__(self, backend: str = "auto", exact: bool = True,
                 device="cuda"):
        self.device = get_device(device)
        self.backend = adi3d.resolve_backend(backend)
        self.exact = exact
        self.last_err = 0.0

    def init(self, grid: Grid3D, params: FluidParams) -> None:
        self.grid = grid
        self.params = params
        self.ga = grid_arrays(grid, self.device)
        self.merge_ok = merge_ok(self.ga)
        self.cur = init_state(grid, self.device)
        self.next = self.cur
        self.pa = adi3d.make_params(params, grid.dx, grid.dy, grid.dz)
        self.plan = None

    def set_plan(self, plan, nblockz: int = 0,
                 balance: str | None = None) -> None:
        """Split X over ``plan``'s shards (``parallel.mesh.ShardingPlan``,
        the GPUplan analogue; ref solver3d.py:61-110): the state and the
        grid's arrays become X slabs, one a shard.  The cuts are
        cmcfs_tpu's: it pads X to a multiple of the shard count with inert
        OUT planes and splits evenly, the planes at the end, or with
        ``balance`` (EVEN_X, EVEN_SEGMENTS, EVEN_VOLUME: the reference's
        SplitSegments_X, Grid3D.cpp:148-235) where
        ``parallel.balance.plan_padding`` puts them so that the even cuts
        carry near-equal work.  ``padded_types`` keeps that layout; the
        port cuts there without storing the padding planes, since a plane
        added at the grid's end changes what its last plane reads, and
        its X lines' classes, where that plane holds IN cells.
        ``nblockz``: as ``set_blocking`` sets it; 0 keeps the plan's."""
        cur, nxt = self.state()
        g = self.grid
        dimx = g.dimx
        if balance:
            from ..parallel import balance as bal
            ins = bal.plan_padding(np.asarray(g.types), plan.n,
                                   policy=balance)
        else:
            ins = [dimx] * ((-dimx) % plan.n)
        self.padded_types = np.insert(np.asarray(g.types), ins,
                                      NodeType.OUT, axis=0)
        # shard i owns padded planes [i*s, (i+1)*s): the grid's planes
        # among them, the -1 entries the padding
        planes = np.insert(np.arange(dimx), ins, -1).reshape(plan.n, -1)
        cuts = [int((p >= 0).sum()) for p in planes]
        if min(cuts) < 1:
            raise SolverError(f"{dimx} X planes are too few for {plan.n} "
                              f"shards (cuts {cuts})")
        self.x_cuts = cuts
        self.ga = shard_grid(
            g.types, g.bc_vel, g.bc_temp,
            (g.vel[..., 0], g.vel[..., 1], g.vel[..., 2], g.T), plan, cuts,
            shape=self.padded_types.shape)
        self.plan = plan
        self.device = plan.devices[0]
        self.set_state(cur, nxt)
        if nblockz:
            self.set_blocking(nblockz)

    def set_blocking(self, nblockz: int) -> None:
        """Give the plan ``nblockz`` (``blocking nBlockZ``): > 1 sends a
        fallback X direction through the Z-blocked wavefront X sweep
        (``adi3d.x_direction``), 0 and 1 keep the reshard.  The cuts and
        the state stay as they are, so a run may change it between steps;
        the one place that sets it."""
        from ..parallel.mesh import ShardingPlan
        self.plan = ShardingPlan(self.plan.devices, nblockz)

    def state(self):
        """(cur, next) as State3D of the whole grid, under a plan gathered
        from the shards onto the first one's device."""
        if self.plan is None:
            return self.cur, self.next
        return tuple(State3D(*self.plan.gather(slabs, -3).unbind(0))
                     for slabs in (self.cur, self.next))

    def set_state(self, cur, nxt) -> None:
        """Take (cur, next) of the whole grid (tensors or host arrays), as
        a resumed checkpoint gives them; under a plan split over it."""
        def dev(f):
            return torch.as_tensor(f, dtype=torch.float32,
                                   device=self.device)

        if self.plan is None:
            self.cur = State3D(*(dev(f) for f in cur))
            self.next = State3D(*(dev(f) for f in nxt))
        else:
            self.cur, self.next = (
                self.plan.split(torch.stack([dev(f) for f in st]), -3,
                                self.x_cuts) for st in (cur, nxt))

    def dispatch_report(self, num_local: int) -> dict:
        """Which implementation each direction runs (the reference's
        OutputSegmentsInfo analogue, AdiSolver3D.cpp:270-284)."""
        if self.plan is None:
            shape = tuple(self.ga.types.shape)
            duals = tuple(c is not None for c in self.ga.cls_b)
        else:
            shape, duals = self.ga.shape, self.ga.duals
        return adi3d.dispatch_report(shape, duals, self.backend, num_local,
                                     self.merge_ok, self.plan)

    def update_boundaries(self) -> None:
        # the reference also re-seeds next's BOUND/VALVE cells
        # (Solver3D.cpp:28-34)
        if self.plan is None:
            self.cur = update_boundaries(self.cur, self.ga)
            self.next = update_boundaries(self.next, self.ga)
        else:
            self.cur = update_slabs(self.cur, self.ga)
            self.next = update_slabs(self.next, self.ga)

    def _step(self, dt, num_global, num_local, compute_error):
        return adi3d.adi_timestep_3d(
            self.cur, self.next, self.ga, dt, num_global, num_local, self.pa,
            backend=self.backend, exact=self.exact,
            compute_error=compute_error, merge_ok=self.merge_ok,
            plan=self.plan)

    def time_step(self, dt: float, num_global: int, num_local: int,
                  compute_error: bool = True) -> None:
        nxt, err = self._step(dt, num_global, num_local, compute_error)
        if compute_error:
            self.last_err = float(err)
            if not (self.last_err <= adi3d.ERR_THRESHOLD):   # NaN-safe
                raise SolverError(f"Error is too big! {self.last_err}")
        # pointer swap (AdiSolver3D.cpp:387-390)
        self.next = self.cur
        self.cur = nxt

    def time_step_profiled(self, dt: float, num_global: int, num_local: int,
                           prof) -> None:
        """One step with each part timed into ``prof`` under the
        reference's event names (adi3d.adi_timestep_3d_profiled; ref
        solver3d.py:170-187): the same kernels and result as
        ``time_step``.  One device only, as in cmcfs_tpu."""
        if self.plan is not None:
            raise SolverError("profiled mode is single-device (run without "
                              "shards)")
        nxt, err = adi3d.adi_timestep_3d_profiled(
            self.cur, self.next, self.ga, dt, num_global, num_local, self.pa,
            prof, backend=self.backend, exact=self.exact,
            merge_ok=self.merge_ok)
        self.last_err = err
        if not (self.last_err <= adi3d.ERR_THRESHOLD):   # NaN-safe
            raise SolverError(f"Error is too big! {self.last_err}")
        self.next = self.cur
        self.cur = nxt

    def get_layer(self, outdimx: int, outdimy: int, outdimz: int):
        """The ``next`` layer, which after the swap holds the PRE-step state:
        the reference's GetLayer off-by-one, kept (PARITY.md:16-17).  The
        MISSING_VALUE clear applies only to the returned host copy."""
        types = (self.ga.types if self.plan is None
                 else torch.as_tensor(self.grid.types))
        return get_layer(self.state()[1], types, outdimx, outdimy, outdimz)


def _whole_step_profiled(self, dt: float, num_global: int, num_local: int,
                         prof) -> None:
    """``time_step_profiled`` of the Explicit and Stable solvers: the whole
    step as one ``TimeStep`` section, since these schemes have no direction
    solves (cmcfs_tpu's Explicit and Stable solvers inherit the ADI
    profiled step, and run ADI under ``profile``)."""
    with prof.section("TimeStep"):
        self.time_step(dt, num_global, num_local)


class ExplicitSolver3D(AdiSolver3D):
    """The ADI solver's lifecycle, error gate, swap and X split
    (``set_plan``, as cmcfs_tpu's schemes inherit it and run sharded
    through GSPMD) with the explicit step (ref solver3d.py:221-251)."""
    name = "Explicit"
    time_step_profiled = _whole_step_profiled

    def _step(self, dt, num_global, num_local, compute_error):
        return explicit3d.explicit_timestep_3d(
            self.cur, self.next, self.ga, dt, num_global, num_local, self.pa,
            compute_error=compute_error, plan=self.plan)


class StableSolver3D(AdiSolver3D):
    """As ``ExplicitSolver3D``, with the projected step (ref
    solver3d.py:221-251)."""
    name = "Stable"
    time_step_profiled = _whole_step_profiled
    last_poisson_iters = ()

    def _step(self, dt, num_global, num_local, compute_error):
        # the Poisson iteration count of each global iteration: a
        # diagnostic, not an output
        nxt, err, self.last_poisson_iters = stable3d.stable_timestep_3d(
            self.cur, self.next, self.ga, dt, num_global, num_local, self.pa,
            compute_error=compute_error, plan=self.plan)
        return nxt, err


def make_solver_3d(name: str, backend: str = "auto", exact: bool = True,
                   device="cuda"):
    """``ADI``, ``Explicit`` or ``Stable`` (KeyError otherwise); the
    backend picks the ADI solver's kernels and is checked for all three,
    as cmcfs_tpu's solvers take it."""
    return {"ADI": AdiSolver3D, "Explicit": ExplicitSolver3D,
            "Stable": StableSolver3D}[name](backend=backend, exact=exact,
                                            device=device)
