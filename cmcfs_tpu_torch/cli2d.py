"""FluidSolver2D command line on the PyTorch + CUDA port.

Usage (grammar of reference src/FluidSolver2D/FluidSolver2D.cpp:22-159):
    python -m cmcfs_tpu_torch.cli2d <proj_file>
    python -m cmcfs_tpu_torch.cli2d <input> <output> <config> [flags]
    python -m cmcfs_tpu_torch.cli2d <input> <field> <output> <config> [flags]

Flags: ``align`` (32-align grid dims), ``CSV`` (section table as CSV),
``quiet``, ``backend
auto|fused_dma|fused|fused_full|fused_nl|fused_bf16|scan|pallas|pcr``
(``auto`` is ``fused_dma``; under ``solver Stable``, ``sequential`` selects
the reference's exact Gauss-Seidel order), ``checkpoint <path>`` (the
state as ``<path>.npz`` and ``<path>.lastlayer.txt`` at each output step),
``resume <path.npz>``.  The config's ``solver`` line picks ADI, Explicit
or Stable.  The run needs a CUDA device.  Each step runs Prepare (host
geometry rebuild, line classes and upload), UpdateBoundaries, TimeStep,
SetGridBoundaries and, every ``out_time_steps``, Output; the section
table's times end in a device synchronize.
"""
from __future__ import annotations

import sys

import torch

from .core.config import Config
from .core.params import FluidParams
from .core.scene2d import Scene2D
from .geom.raster2d import Grid2D
from .io import writers
from .io.checkpoint import (load_checkpoint, save_checkpoint,
                            save_last_layer_txt)
from .io.project import find_file, load_project
from .models.common2d import State2D
from .models.solver2d import make_solver
from .utils.profiler import Profiler
from .utils.timer import CpuTimer, print_time_step_info


def run_case(input_path: str, field_path: str, output_path: str,
             config_path: str, align: bool = False, csv: bool = False,
             backend: str = "auto", quiet: bool = False,
             max_steps: int | None = None, collect_errs: bool = False,
             checkpoint: str | None = None, resume: str | None = None,
             device="cuda"):
    """Run one case end to end (cmcfs_tpu/cli2d.py:27-174); returns
    (solver, errs, sections), the last the run's ``Profiler``."""
    cfg = Config.load(config_path)
    params = FluidParams.physical(cfg.viscosity, cfg.density,
                                  cfg.R_specific, cfg.k, cfg.cv)
    scene = Scene2D.load(input_path, field_path, dx=cfg.dx, dy=cfg.dy,
                         align=align)
    grid = Grid2D(scene, start_T=cfg.baseT, bc_noslip=cfg.bc_noslip,
                  bc_strength=cfg.bc_strength)
    if not quiet:
        print("dx,dy,dimx,dimy,bc_noslip")
        print(f"{cfg.dx:f},{cfg.dy:f},{grid.dimx},{grid.dimy},"
              f"{int(cfg.bc_noslip)}")
    grid.prepare_frame(0, 0.0)

    solver = make_solver(cfg.solver, backend=backend, device=device)
    solver.init(grid, params)

    frames = scene.num_frames()
    length = scene.cycle_length()
    dt = length / (frames * cfg.time_steps)
    finaltime = length * cfg.cycles
    if not quiet:
        print(f"dt = {dt:f}")
        if solver.name == "ADI":
            print(f"dispatch: backend={solver.backend} "
                  f"pcr={solver.backend == 'pcr'} "
                  f"dirs={solver.dispatch_report()}")

    t_resume = 0.0
    if resume:
        step0, t_resume, fields = load_checkpoint(resume)
        solver.set_layer(fields["u"], fields["v"], fields["T"])
        if "nu" in fields:
            solver.next = State2D(*(torch.as_tensor(fields[k],
                                                    device=solver.device)
                                    for k in ("nu", "nv", "nT")))
        else:
            solver.next = solver.cur
        if not quiet:
            print(f"Resuming from step {step0}, t={t_resume:f}")

    # the reference writes the CDL header unconditionally, even in MultiVox
    # mode (FluidSolver2D.cpp:88)
    writers.output_netcdf_header_2d(output_path, grid.scene.bbox_min,
                                    grid.scene.bbox_max,
                                    dt * cfg.out_time_steps, finaltime,
                                    cfg.outdimx, cfg.outdimy)
    cur_out = output_path

    prof = Profiler(device=solver.device)
    timer = CpuTimer()
    timer.start()
    errs = []
    lastframe = -1
    currentcycle = 0
    t = dt
    i = 0
    nsteps = 0
    while t_resume and t <= t_resume + dt * 0.5:
        # fast-forward the frame and output bookkeeping to the resume point
        currentframe = scene.frame_at(t)
        if currentframe != lastframe:
            if currentframe == 0:
                currentcycle += 1
            lastframe = currentframe
            i = 0
        t += dt
        i += 1
    while t < finaltime:
        currentframe = scene.frame_at(t)
        layer_time = scene.layer_time(t)
        if currentframe != lastframe:
            if currentframe == 0:
                currentcycle += 1
                if cfg.out_fmt == "MultiVox":
                    # the reference suffixes every cycle incl. the first
                    # (FluidSolver2D.cpp:106-114: currentcycle > 0)
                    stem, dot, ext = output_path.rpartition(".")
                    cur_out = (f"{stem}_{currentcycle}{dot}{ext}" if dot
                               else f"{output_path}_{currentcycle}")
                    writers.output_multivox_header(
                        cur_out, grid.scene.bbox_min, grid.scene.bbox_max,
                        cfg.outdimx, cfg.outdimy)
            if cfg.out_fmt == "MultiVox":
                writers.output_multivox_frame_marker(cur_out, currentframe)
            lastframe = currentframe
            i = 0

        with prof.section("Prepare"):
            grid.prepare(t)
            solver.refresh_grid()
        with prof.section("UpdateBoundaries"):
            solver.update_boundaries()
        with prof.section("TimeStep"):
            solver.time_step(dt, cfg.num_global, cfg.num_local)
        with prof.section("SetGridBoundaries"):
            solver.set_grid_boundaries()
        if collect_errs:
            errs.append(solver.last_err)

        timer.stop()
        if not quiet:
            print(f"\rerr = {solver.last_err:.4f},", end="")
            print_time_step_info(currentframe, i, t, finaltime,
                                 timer.elapsed_sec())

        if i % cfg.out_time_steps == 0:
            dur = min(dt * cfg.out_time_steps, layer_time)
            with prof.section("Output"):
                u, v, T = solver.get_layer(cfg.outdimx, cfg.outdimy)
                if cfg.out_fmt == "MultiVox":
                    writers.output_multivox(cur_out, u, v, dur)
                else:
                    finish = (i + cfg.out_time_steps >= cfg.time_steps
                              and currentframe == frames - 1
                              and currentcycle == cfg.cycles)
                    writers.output_netcdf_2d_u(output_path, u, finish)
        if checkpoint and i % cfg.out_time_steps == 0:
            cur = [f.cpu().numpy() for f in solver.cur]
            nxt = [f.cpu().numpy() for f in solver.next]
            save_checkpoint(checkpoint, nsteps, t,
                            **dict(zip(("u", "v", "T"), cur)),
                            **dict(zip(("nu", "nv", "nT"), nxt)))
            save_last_layer_txt(checkpoint + ".lastlayer.txt", currentframe,
                                *cur)
        t += dt
        i += 1
        nsteps += 1
        if max_steps is not None and nsteps >= max_steps:
            break

    if not quiet:
        print()
        print(prof.report(csv=csv))
    return solver, errs, prof


def main(argv=None, device="cuda") -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    flags = {"align": False, "CSV": False, "quiet": False}
    backend = "auto"
    extras = {}
    rest = []
    i = 0
    while i < len(argv):
        arg = argv[i]
        if arg in flags:
            flags[arg] = True
        elif arg == "backend" and i + 1 < len(argv):
            backend = argv[i + 1]
            i += 1
        elif arg in ("checkpoint", "resume") and i + 1 < len(argv):
            extras[arg] = argv[i + 1]
            i += 1
        else:
            rest.append(arg)
        i += 1

    if len(rest) == 1:
        input_path, field_path, output_path, config_path = \
            load_project(rest[0])
    elif len(rest) >= 4:
        input_path = find_file(rest[0])
        field_path = find_file(rest[1])
        output_path = rest[2]
        config_path = find_file(rest[3])
    elif len(rest) == 3:
        input_path = find_file(rest[0])
        field_path = ""
        output_path = rest[1]
        config_path = find_file(rest[2])
    else:
        print(__doc__)
        return 2

    run_case(input_path, field_path, output_path, config_path,
             align=flags["align"], csv=flags["CSV"], backend=backend,
             quiet=flags["quiet"], checkpoint=extras.get("checkpoint"),
             resume=extras.get("resume"), device=device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
