"""Stateful 3D solvers (port of cmcfs_tpu/models/solver3d.py).

The reference implements only ADI for 3D (FluidSolver3D.cpp:177-190);
cmcfs_tpu adds Explicit and Stable (models/explicit3d.py,
models/stable3d.py), and so does the port.
"""
from __future__ import annotations

from ..core.params import FluidParams
from ..device import get_device
from ..geom.grid3d import Grid3D
from . import adi3d, explicit3d, stable3d
from .common3d import (get_layer, grid_arrays, init_state, merge_ok,
                       update_boundaries)


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

    def dispatch_report(self, num_local: int) -> dict:
        """Which implementation each direction runs (the reference's
        OutputSegmentsInfo analogue, AdiSolver3D.cpp:270-284)."""
        return adi3d.dispatch_report(
            tuple(self.ga.types.shape),
            tuple(c is not None for c in self.ga.cls_b), self.backend,
            num_local, self.merge_ok)

    def update_boundaries(self) -> None:
        # the reference also re-seeds next's BOUND/VALVE cells
        # (Solver3D.cpp:28-34)
        self.cur = update_boundaries(self.cur, self.ga)
        self.next = update_boundaries(self.next, self.ga)

    def _step(self, dt, num_global, num_local, compute_error):
        return adi3d.adi_timestep_3d(
            self.cur, self.next, self.ga, dt, num_global, num_local, self.pa,
            backend=self.backend, exact=self.exact,
            compute_error=compute_error, merge_ok=self.merge_ok)

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
        ``time_step``."""
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
        return get_layer(self.next, self.ga, outdimx, outdimy, outdimz)


def _whole_step_profiled(self, dt: float, num_global: int, num_local: int,
                         prof) -> None:
    """``time_step_profiled`` of the Explicit and Stable solvers: the whole
    step as one ``TimeStep`` section, since these schemes have no direction
    solves (cmcfs_tpu's Explicit and Stable solvers inherit the ADI
    profiled step, and run ADI under ``profile``)."""
    with prof.section("TimeStep"):
        self.time_step(dt, num_global, num_local)


class ExplicitSolver3D(AdiSolver3D):
    """The ADI solver's lifecycle, error gate and swap with the explicit
    step (ref solver3d.py:221-251)."""
    name = "Explicit"
    time_step_profiled = _whole_step_profiled

    def _step(self, dt, num_global, num_local, compute_error):
        return explicit3d.explicit_timestep_3d(
            self.cur, self.next, self.ga, dt, num_global, num_local, self.pa,
            compute_error=compute_error)


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
            compute_error=compute_error)
        return nxt, err


def make_solver_3d(name: str, backend: str = "auto", exact: bool = True,
                   device="cuda"):
    """``ADI``, ``Explicit`` or ``Stable`` (KeyError otherwise); the
    backend picks the ADI solver's kernels and is checked for all three,
    as cmcfs_tpu's solvers take it."""
    return {"ADI": AdiSolver3D, "Explicit": ExplicitSolver3D,
            "Stable": StableSolver3D}[name](backend=backend, exact=exact,
                                            device=device)
