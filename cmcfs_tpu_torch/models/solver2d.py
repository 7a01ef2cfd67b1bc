"""Stateful 2D solvers (port of cmcfs_tpu/models/solver2d.py).

Mirrors the reference Solver2D lifecycle (Init / UpdateBoundaries /
TimeStep / SetGridBoundaries / GetLayer / SetLayer,
src/FluidSolver2D/Solver2D.h) for its three schemes: ADI, Explicit and
Stable.
"""
from __future__ import annotations

import torch

from ..core.params import FluidParams
from ..device import get_device
from ..geom.raster2d import Grid2D
from . import adi2d, explicit2d, stable2d
from .common2d import (State2D, get_layer, host_arrays, init_state,
                       update_boundaries, upload)


class SolverError(RuntimeError):
    """Raised where the reference would print and exit(1)."""


class Solver2DBase:
    name = "base"

    def __init__(self, backend: str = "auto", exact: bool = True,
                 device="cuda"):
        self.device = get_device(device)
        self.backend = backend
        self.exact = exact
        self.last_err = 0.0
        self.last_iters = 0

    def init(self, grid: Grid2D, params: FluidParams) -> None:
        self.grid = grid
        self.params = params
        self.refresh_grid()
        self.cur = init_state(grid, self.device)
        self.next = self.cur
        self.pa = adi2d.make_params(params, grid.dx, grid.dy, grid.start_T)

    def refresh_grid(self) -> None:
        """Line classes on the host and the upload, after a host-side
        ``grid.prepare`` rebuild; ``stream_ok`` is decided on the host."""
        host = host_arrays(self.grid)
        self.stream_ok = adi2d.stream_ok_2d(host)
        self.ga = upload(host, self.device)

    def update_boundaries(self) -> None:
        self.cur = update_boundaries(self.cur, self.ga)
        self.next = update_boundaries(self.next, self.ga)

    def set_grid_boundaries(self) -> None:
        self.grid.set_field_data(self.cur.u.cpu().numpy(),
                                 self.cur.v.cpu().numpy())

    def get_layer(self, outdimx: int, outdimy: int):
        return get_layer(self.next, outdimx, outdimy)

    def set_layer(self, u, v, T) -> None:
        """Restore a checkpointed layer (reference Solver2D::SetLayer)."""
        self.cur = State2D(*(torch.as_tensor(f, dtype=torch.float32,
                                             device=self.device)
                             for f in (u, v, T)))

    def time_step(self, dt: float, num_global: int, num_local: int) -> None:
        """One step of the scheme (``_step``) and the reference's blow-up
        check: exit(1) past MAX_GLOBAL_ITERS global iterations or an error
        over ten times the scheme's threshold."""
        nxt, err, it = self._step(dt, num_global, num_local)
        self.last_err = float(err)
        self.last_iters = it
        if it > adi2d.MAX_GLOBAL_ITERS:
            raise SolverError("Exceeded max number of iterations "
                              f"({adi2d.MAX_GLOBAL_ITERS})")
        if not (self.last_err <= self.threshold * 10):   # NaN-safe
            raise SolverError(f"Error is too big! {self.last_err}")
        self.next = nxt
        self.cur = nxt


class AdiSolver2D(Solver2DBase):
    name = "ADI"
    threshold = adi2d.ERR_THRESHOLD

    def __init__(self, backend: str = "auto", exact: bool = True,
                 device="cuda"):
        # ``auto`` is fused_dma, the TPU's 2D default, on every device
        super().__init__(adi2d.resolve_backend(backend), exact, device)

    def dispatch_report(self) -> dict:
        """Which path each direction runs ({"X"|"Y": ...})."""
        return adi2d.dispatch_report_2d(tuple(self.ga.types.shape),
                                        self.backend, self.stream_ok)

    def _step(self, dt, num_global, num_local):
        return adi2d.adi_timestep_2d(
            self.cur, self.ga, dt, num_global, num_local, self.pa,
            backend=self.backend, exact=self.exact, stream_ok=self.stream_ok)


class ExplicitSolver2D(Solver2DBase):
    name = "Explicit"
    threshold = explicit2d.ERR_THRESHOLD

    def _step(self, dt, num_global, num_local):
        return explicit2d.explicit_timestep_2d(
            self.cur, self.next, self.ga, dt, num_global, num_local, self.pa)


class StableSolver2D(Solver2DBase):
    name = "Stable"
    threshold = stable2d.DIV_ERR_THRESHOLD
    last_poisson_iters = ()

    def _step(self, dt, num_global, num_local):
        # backend "sequential" selects the reference-exact Gauss-Seidel
        # order (stable2d.SequentialSweep); any other is red-black.  The
        # Poisson iteration counts are a diagnostic, not an output
        mode = "sequential" if self.backend == "sequential" else "redblack"
        nxt, err, it, self.last_poisson_iters = stable2d.stable_timestep_2d(
            self.cur, self.next, self.ga, dt, num_global, num_local, self.pa,
            mode=mode)
        return nxt, err, it


def make_solver(name: str, backend: str = "auto", exact: bool = True,
                device="cuda") -> Solver2DBase:
    """``ADI``, ``Explicit`` or ``Stable`` (KeyError otherwise)."""
    return {"ADI": AdiSolver2D, "Explicit": ExplicitSolver2D,
            "Stable": StableSolver2D}[name](backend=backend, exact=exact,
                                            device=device)
