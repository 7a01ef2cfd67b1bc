"""cmcfs_tpu_torch's 3D ADI solver driven as its command line's loop drives
it, and held against the plain reference; shared by the kinds whose
configuration is a 3D grid run by ADI.

A kind's ``build`` makes the port's ``Grid3D`` and ``FluidParams`` its own
way and hands them here, with the time step, the iteration counts and
``reference``: a function that works out the grid
(``reference.grid.Grid``), the coefficients, the time step and the
iteration counts again from the configuration alone.

Set-up: ``make_solver_3d("ADI", backend, exact=True)`` and ``solver.init``
on the first card, and with ``shards`` > 1 the X split over the cell's
cards, ``solver.set_plan(make_x_mesh(shards, devices=devices),
nblockz=nblockz)``, as ``cli3d.run_case`` makes them; then the seeded
state: the grid's values plus an N(0, ``NOISE``) perturbation of the IN
cells' u, v, w and T, made from the seed on the first card and handed
over by ``AdiSolver3D.set_state``, which splits it under a plan.  A step
is ``cli3d.run_case``'s: ``update_boundaries()``, then ``time_step(dt,
num_global, num_local, compute_error=(i % 10 == 0))`` with the divergence
gate.  The control runs the port's bf16 payload mode (``fused_bf16``) in
place of the traffic's backend.

The comparison (``judge``): the grid the port derived (types, BCs,
values, line classes, pass B, each axis's path; under a plan the X slabs'
owned planes joined), the seeded start, the first warm-up step from it,
and one step of the window drawn among the error steps, from the state
the port held before it (under a plan gathered from the shards).
"""
from __future__ import annotations

import gc
import time
import types

import numpy as np
import torch

# cli3d.run_case checks the divergence error on every tenth step
ERR_EVERY = 10
# the scale of the seed's perturbation of the IN cells
NOISE = 0.01
CONTROL_BACKEND = "fused_bf16"
# the fields of the port's grid arrays that check.grid_differing reads
GRID_FIELDS = ("types", "bc_vel", "bc_temp", "val_u", "val_v", "val_w",
               "val_T", "cls_a", "cls_b", "take_b")


def noise(seed: int, shape, device):
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    return NOISE * torch.randn((4,) + tuple(shape), generator=gen,
                               device=device, dtype=torch.float32)


def host_grid(parts, halo: int):
    """The fields ``GRID_FIELDS`` of the whole grid on the host, from the
    port's grid arrays: one ``GridArrays3D`` (``halo`` 0), or a plan's X
    slabs, whose owned planes (``halo`` planes in from each X end) are
    joined in order."""
    def join(ts):
        if ts[0] is None:
            return None
        return torch.cat([t[halo:t.shape[0] - halo].cpu() for t in ts])

    out = {}
    for name in GRID_FIELDS:
        f = [getattr(p, name) for p in parts]
        out[name] = (tuple(join(ax) for ax in zip(*f))
                     if isinstance(f[0], tuple) else join(f))
    return types.SimpleNamespace(**out)


class Case:
    """One cell's solver, its seeded state and what the comparison needs."""

    spans = ("update_boundaries", "time_step")
    warmup_steps = 2
    # the traced stretch starts one error period into the window
    trace_from = 2 + ERR_EVERY

    def __init__(self, grid, params, dt: float, num_global: int,
                 num_local: int, backend: str, devices, seed: int,
                 control: bool, reference, shards: int = 1,
                 nblockz: int = 0):
        from cmcfs_tpu_torch.core.types import NodeType
        from cmcfs_tpu_torch.models.solver3d import (SolverError,
                                                     make_solver_3d)

        device = devices[0]
        t0 = time.perf_counter()
        if device.type == "cuda":
            from cmcfs_tpu_torch.kernels.build import load_library
            load_library()
        t1 = time.perf_counter()
        self.failures = (SolverError,)
        self.device, self.seed, self.reference = device, seed, reference
        self.backend = CONTROL_BACKEND if control else backend
        self.dt, self.ng, self.nl = dt, num_global, num_local
        self.wavefront = shards > 1 and nblockz > 1
        s = make_solver_3d("ADI", backend=self.backend, exact=True,
                           device=device)
        s.init(grid, params)
        t2 = time.perf_counter()
        self.solver = s
        self.shape = tuple(s.ga.types.shape)
        self.cells = int(np.prod(self.shape))
        init4 = torch.stack(tuple(s.cur))
        x0 = torch.where(s.ga.types == NodeType.IN,
                         init4 + noise(seed, self.shape, device), init4)
        del init4
        if shards > 1:
            from cmcfs_tpu_torch.parallel.mesh import make_x_mesh
            s.set_plan(make_x_mesh(shards, devices=devices),
                       nblockz=nblockz)
        s.set_state(list(x0), list(x0))
        self.first_in = x0.cpu()
        # where the case's set-up goes (printed beside set_up)
        self.phases = {"library": t1 - t0, "solver_init": t2 - t1,
                       "state": time.perf_counter() - t2}
        self.first_out, self.first_err = None, float("nan")

    def label(self) -> str:
        return f"backend {self.backend}, {self.shape}"

    def step(self, i: int, traced: bool = False) -> None:
        s = self.solver
        err = i % ERR_EVERY == 0
        if traced:
            with torch.profiler.record_function("update_boundaries"):
                s.update_boundaries()
            with torch.profiler.record_function("time_step"):
                s.time_step(self.dt, self.ng, self.nl, compute_error=err)
        else:
            s.update_boundaries()
            s.time_step(self.dt, self.ng, self.nl, compute_error=err)

    def warm_up(self) -> None:
        """An error step, which the comparison checks, and one without."""
        self.step(0)
        self.first_out = torch.stack(tuple(self.solver.state()[0])).cpu()
        self.first_err = self.solver.last_err
        self.step(1)

    def checkable(self, i: int) -> bool:
        return i % ERR_EVERY == 0

    def hold(self):
        """Before a checkable step: the state it starts from."""
        return (self.solver.cur, self.solver.next)

    def held(self, pre):
        """After it: the sample the comparison may take."""
        return (pre, self.solver.cur, self.solver.last_err)

    def release(self, sample) -> None:
        """Keep host copies of what the comparison reads and free the
        port's state, so that the reference runs in the memory it
        leaves."""
        s = self.solver
        if s.plan is None:
            self.ga_host = host_grid([s.ga], 0)
        else:
            self.ga_host = host_grid(s.ga.x, 1)
        self.dirs_port = s.dispatch_report(self.nl)["dirs"]

        def whole(st):
            if s.plan is None:
                return torch.stack(tuple(st))
            return s.plan.gather(list(st), -3)

        self.window = None
        if sample is not None:
            (pre_cur, pre_next), out, err = sample
            self.window = ([whole(t) for t in (pre_cur, pre_next, out)],
                           err)
        del self.solver, s, sample
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def judge(self, limits: dict, failed: int):
        """The reference's grid, initial state and two steps against the
        port's: (checks, work), work being what the byte counts read
        (each axis's line length, path and duals)."""
        from portbench import check
        from portbench.reference import adi as radi
        from portbench.reference import grid as rgrid

        device = self.device
        radi.tf32_off()
        g, p, dt, ng, nl = self.reference()
        classes = rgrid.line_classes(g)
        duals = tuple(b is not None for _, b, _ in classes)
        dirs = radi.paths(g.types.shape, rgrid.merge_ok(g, classes), duals,
                          nl)
        checks = {"grid_cells_differing": {
            "value": check.grid_differing(self.ga_host, self.dirs_port, g,
                                          classes, dirs),
            "limit": 0}}
        ar = radi.Arrays(g, classes, device)
        init4 = torch.as_tensor(rgrid.initial_state(g), device=device)
        x0 = torch.where(ar.types == rgrid.IN,
                         init4 + noise(self.seed, g.types.shape, device),
                         init4)
        del init4
        checks["start_state_gap"] = {
            "value": check.abs_gap(self.first_in, x0), "limit": 0.0}

        def step(cur4, nxt4):
            cur4 = radi.update_boundaries(cur4.to(device), ar)
            nxt4 = radi.update_boundaries(nxt4.to(device), ar)
            new, err = radi.step(cur4, nxt4, ar, p, dt, ng, nl, dirs,
                                 exact=True)
            return new, float(err)

        win = self.window
        for tag, state, out, err in (
                ("first", (x0, x0) if self.first_out is not None else None,
                 self.first_out, self.first_err),
                ("window", None if win is None else win[0][:2],
                 None if win is None else win[0][2],
                 None if win is None else win[1])):
            gap = egap = None
            if state is not None:
                new, ref_err = step(*state)
                gap = check.state_gap(out, new)
                egap = check.err_gap(err, ref_err)
                del new
            checks[f"{tag}_step_gap"] = {"value": gap,
                                         "limit": limits["step_gap"]}
            checks[f"{tag}_err_gap"] = {"value": egap,
                                        "limit": limits["err_gap"]}
        checks["steps_failed"] = {"value": failed, "limit": 0}
        work = {"ng": ng, "nl": nl, "backend": self.backend,
                "wavefront": self.wavefront, "axes": [
            {"n": int(g.types.shape[ax]), "pair": dirs[ax] == "pair",
             "dual": duals[ax]} for ax in range(3)]}
        return checks, work
