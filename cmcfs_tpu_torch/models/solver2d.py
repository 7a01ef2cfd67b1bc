"""Stateful 2D solver (port of cmcfs_tpu/models/solver2d.py, ADI only).

Mirrors the reference Solver2D lifecycle (Init / UpdateBoundaries /
TimeStep / SetGridBoundaries / GetLayer, src/FluidSolver2D/Solver2D.h).
cmcfs_tpu's Explicit and Stable 2D schemes are not ported yet (ROADMAP
A4) and raise here.
"""
from __future__ import annotations

from ..core.params import FluidParams
from ..device import get_device
from ..geom.raster2d import Grid2D
from . import adi2d
from .common2d import (get_layer, host_arrays, init_state, update_boundaries,
                       upload)


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

    def _check(self, err: float, iters: int, threshold: float) -> None:
        if iters > adi2d.MAX_GLOBAL_ITERS:
            raise SolverError("Exceeded max number of iterations "
                              f"({adi2d.MAX_GLOBAL_ITERS})")
        if not (err <= threshold * 10):          # NaN-safe
            raise SolverError(f"Error is too big! {err}")

    def time_step(self, dt: float, num_global: int, num_local: int) -> None:
        raise NotImplementedError


class AdiSolver2D(Solver2DBase):
    name = "ADI"

    def __init__(self, backend: str = "auto", exact: bool = True,
                 device="cuda"):
        # ``auto`` is fused_dma, the TPU's 2D default, on every device
        super().__init__(adi2d.resolve_backend(backend), exact, device)

    def dispatch_report(self) -> dict:
        """Which path each direction runs ({"X"|"Y": ...})."""
        return adi2d.dispatch_report_2d(tuple(self.ga.types.shape),
                                        self.backend, self.stream_ok)

    def time_step(self, dt: float, num_global: int, num_local: int) -> None:
        nxt, err, it = adi2d.adi_timestep_2d(
            self.cur, self.ga, dt, num_global, num_local, self.pa,
            backend=self.backend, exact=self.exact, stream_ok=self.stream_ok)
        self.last_err = float(err)
        self.last_iters = it
        self._check(self.last_err, self.last_iters, adi2d.ERR_THRESHOLD)
        self.next = nxt
        self.cur = nxt


def make_solver(name: str, backend: str = "auto", exact: bool = True,
                device="cuda") -> Solver2DBase:
    if name in ("Explicit", "Stable"):
        raise NotImplementedError(
            f"2D solver {name!r} is not ported yet (ROADMAP A4)")
    if name != "ADI":
        raise KeyError(name)
    return AdiSolver2D(backend=backend, exact=exact, device=device)
