"""FluidSolver3D command line on the PyTorch + CUDA port.

Usage (grammar of reference src/FluidSolver3D/FluidSolver3D.cpp:26-51):
    python -m cmcfs_tpu_torch.cli3d <input> <output_base> <config> [flags]

Flags: ``align``, ``CSV`` (section table as CSV), ``quiet``, ``backend
auto|fused_nl|fused_pcr|fused_bf16|fused_pcr_bf16|fused_full|fused_dma|fused|
scan|pallas|pcr``; ``dump_grid`` (the mask as a BMP stack, one file a Z
slice, in ``<output_base>_grid_3d/``); ``profile`` (each part of the ADI
step timed on its own: CopyLayer, SolveSegments_Z/Y/X, MergeLayer,
EvalDivError); ``checkpoint <path>`` (the state as ``<path>.npz`` at each
output step) and ``resume <path.npz>`` (continue from one, appending to
the NetCDF file); ``carried`` (accepted: the port runs the per-step
loop).  The config's ``solver`` line picks ADI, Explicit or Stable.
``transpose`` and ``decompose`` are accepted and have no effect, as in
cmcfs_tpu.  ``shards N`` (or ``GPU N``, the reference's grammar) splits X
over the first N cards, and exits with status 2 naming the visible count
when fewer are visible; ``balance EVEN_X|EVEN_SEGMENTS|EVEN_VOLUME``
moves the split's cuts where cmcfs_tpu's padding puts them
(``parallel/balance.py``); ``blocking [nBlockZ]`` solves the X direction
by the Z-blocked wavefront across the shards where X takes the fallback
path (a pair X direction is left as it is, as in cmcfs_tpu; no number,
or 1, keeps the reshard).  Explicit and Stable split as ADI does.  The
run needs a CUDA device.  cmcfs_tpu's multi-host flags (``hosts``,
``rank``, ``coordinator``, ``orbax``) exit with status 2 and name their
ROADMAP item.
"""
from __future__ import annotations

import os
import sys
import time

import numpy as np

from .core.config import Config
from .core.params import FluidParams
from .core.scene2d import Scene2D
from .core.scene3d import Bathymetry, Scene3D
from .geom.grid3d import Grid3D
from .geom.raster2d import Grid2D
from .io import writers
from .io.checkpoint import load_checkpoint, save_checkpoint
from .io.image import mask_to_bmp_stack
from .io.project import find_file
from .models.solver3d import make_solver_3d
from .parallel.mesh import make_x_mesh
from .utils.profiler import Profiler
from .utils.timer import CpuTimer, print_time_step_info

# cmcfs_tpu CLI flags the port does not have yet, and where they are queued
UNPORTED_FLAGS = {
    "hosts": "multi-host runs (ROADMAP A8 part 3)",
    "rank": "multi-host runs (ROADMAP A8 part 3)",
    "coordinator": "multi-host runs (ROADMAP A8 part 3)",
    "orbax": "the orbax checkpoint tier, which snapshots sharded arrays "
             "(ROADMAP A8 part 3)",
}

# what cmcfs_tpu prints when its carried-state loop cannot engage
# (cli3d.py:210-213); the port keeps no carried layout (ROADMAP "Not
# ported") and always runs the per-step loop
CARRIED_NOTE = ("carried: cannot engage on this dispatch — "
                "running the per-step loop")


BF16_STEP_WARN_THRESHOLD = 200


def bf16_horizon_warning(backend: str, total_steps: int) -> str | None:
    """Guardrail for the bf16 payload backends, which part from the
    float32 ones by their per-step rounding: a warning for runs of more than
    BF16_STEP_WARN_THRESHOLD steps, else None (cmcfs_tpu/cli3d.py:41-56;
    the drift figure is cmcfs_tpu's measurement, RESULTS.md)."""
    if (backend not in ("fused_bf16", "fused_pcr_bf16")
            or total_steps <= BF16_STEP_WARN_THRESHOLD):
        return None
    return (f"WARNING: backend {backend} over {total_steps} steps: bf16 "
            f"storage drift accumulates (~19% of max|u| by step 100 on a "
            f"developing flow, RESULTS.md); this mode is for bounded-horizon/"
            f"visualization runs — use fused_full for long trajectories")


def build_grid(cfg: Config, input_path: str, align: bool = False) -> Grid3D:
    """Host grid build, as cmcfs_tpu.cli3d.build_grid (cli3d.py:63-98)."""
    if cfg.in_fmt == "Shape3D":
        scene = Scene3D.load(input_path, cfg.dx, cfg.dy, cfg.dz, align=align)
        grid = Grid3D.from_scene3d(scene, cfg.dx, cfg.dy, cfg.dz, cfg.baseT)
        grid.prepare_shape3d(0.0)
        grid.bbox_min, grid.bbox_max = scene.bbox_min, scene.bbox_max
        grid.num_frames = scene.num_frames()
        grid.cycle_len = (cfg.frame_time if cfg.frame_time > 0
                          else scene.cycle_length())
    elif cfg.in_fmt == "Shape2D":
        scene2 = Scene2D.load(input_path, dx=cfg.dx, dy=cfg.dy, align=align)
        g2 = Grid2D(scene2, start_T=cfg.baseT, bc_noslip=True, bc_strength=0.0)
        grid = Grid3D.from_extruded_2d(g2, cfg.depth, cfg.depth_var, cfg.dz,
                                       cfg.baseT, align=align)
        grid.prepare_extruded(0.0)
        grid.bbox_min = np.array([scene2.bbox_min[0], scene2.bbox_min[1],
                                  -cfg.depth], dtype=np.float32)
        grid.bbox_max = np.array([scene2.bbox_max[0], scene2.bbox_max[1], 0.0],
                                 dtype=np.float32)
        grid.num_frames = scene2.num_frames()
        grid.cycle_len = scene2.cycle_length()
    else:  # SeaNetCDF
        bathy = Bathymetry.load(input_path)
        grid = Grid3D.from_bathymetry(bathy, cfg.dx, cfg.dy, cfg.dz, cfg.baseT,
                                      cfg.bc_inV, cfg.bc_inT, align=align)
        grid.prepare_bathymetry(0.0)
        grid.num_frames = 1
        grid.cycle_len = cfg.frame_time
    return grid


def load_case(input_path: str, config_path: str, align: bool = False):
    """Parse the config and build the host grid: (cfg, params, grid)."""
    cfg = Config.load(config_path)
    return cfg, FluidParams.from_config(cfg), build_grid(cfg, input_path,
                                                         align=align)


def run_case(input_path: str, output_base: str, config_path: str,
             align: bool = False, csv: bool = False, backend: str = "auto",
             quiet: bool = False, dump_grid: bool = False,
             max_steps: int | None = None, collect_errs: bool = False,
             checkpoint: str | None = None, resume: str | None = None,
             profile: bool = False, carried: bool = False, device="cuda",
             shards: int = 1, balance: str | None = None, devices=None,
             nblockz: int = 0):
    """Run one case end to end (cmcfs_tpu/cli3d.py:101-334); returns
    (solver, errs).  ``shards`` > 1 splits X over that many shards
    (``parallel.mesh.make_x_mesh``): the first cards, ``devices`` when
    given (an explicit list, e.g. ``["cuda:0"] * 4`` to run four shards on
    one card), or CPU shards with ``device="cpu"``; ``nblockz`` > 1 then
    solves a fallback X direction by the Z-blocked wavefront."""
    t0 = time.perf_counter()
    cfg, params, grid = load_case(input_path, config_path, align=align)
    build_s = time.perf_counter() - t0
    n_in, volume = grid.fluid_volume()
    if not quiet:
        print(f"Grid = {grid.dimx} x {grid.dimy} x {grid.dimz} "
              f"(host build {build_s:.2f} s)")
        print(f"NODE_IN points = {n_in} of total "
              f"{grid.dimx * grid.dimy * grid.dimz}, volume = {volume:f}")
    if dump_grid:
        mask_to_bmp_stack(grid.types, output_base + "_grid_3d")

    solver = make_solver_3d(cfg.solver, backend=backend, device=device)
    solver.init(grid, params)
    if shards > 1:
        solver.set_plan(make_x_mesh(shards, devices=devices, device=device),
                        nblockz=nblockz, balance=balance)

    frames = grid.num_frames
    length = grid.cycle_len
    dt = length / (frames * cfg.time_steps)
    finaltime = length * cfg.cycles

    total_steps = int(round(finaltime / dt))
    if max_steps is not None:
        total_steps = min(total_steps, max_steps)
    warn = bf16_horizon_warning(backend, total_steps)
    if warn:
        print(warn, file=sys.stderr)

    depths = getattr(grid, "bathy", None)
    out_path = output_base + "_res.nc"
    # resuming appends to the existing output (the reference appends
    # records, IO.h:350-388)
    nc = writers.NetCDF3DOutput(
        out_path, grid.bbox_min, grid.bbox_max,
        dt * cfg.out_time_steps, finaltime, cfg.outdimx, cfg.outdimy,
        cfg.outdimz, cfg.out_vars, xy_degree_units=cfg.in_fmt == "SeaNetCDF",
        depths=None if depths is None else depths.depth,
        append=bool(resume) and os.path.exists(out_path))

    if not quiet and solver.name == "ADI":
        rep = solver.dispatch_report(cfg.num_local)
        print(f"dispatch: backend={rep['backend']} pad={rep['pad']} "
              f"pcr={rep['pcr']} bf16={rep['bf16']} dirs={rep['dirs']} "
              f"shards={shards}")

    prof = Profiler(device=solver.device)
    timer = CpuTimer()
    timer.start()
    errs = []
    out_layer = 0
    t = dt
    i = 0
    nsteps = 0
    if resume:
        step0, t_ck, fields = load_checkpoint(resume)
        solver.set_state([fields[k] for k in ("u", "v", "w", "T")],
                         [fields[k] for k in ("nu", "nv", "nw", "nT")])
        while t <= t_ck + dt * 0.5:
            t += dt
            i += 1
            if (i - 1) % cfg.out_time_steps == 0:
                out_layer += 1
        if not quiet:
            print(f"Resuming from step {step0}, t={t_ck:f}")
    if carried and solver.name == "ADI" and not profile and not quiet:
        print(CARRIED_NOTE, file=sys.stderr)

    while t < finaltime:
        compute_err = (i % 10 == 0) or (t + dt >= finaltime)
        with prof.section("UpdateBoundaries"):
            solver.update_boundaries()
        if profile:
            # each part of the step timed on its own (the reference's
            # PROFILE_ENABLE event table, Profiler.h:44-134)
            solver.time_step_profiled(dt, cfg.num_global, cfg.num_local,
                                      prof)
        else:
            with prof.section("TimeStep"):
                solver.time_step(dt, cfg.num_global, cfg.num_local,
                                 compute_err)
        if collect_errs:
            errs.append(solver.last_err)
        timer.stop()
        if not quiet:
            print(f"\rerr = {solver.last_err:.8f},", end="")
            print_time_step_info(0, i, t, finaltime, timer.elapsed_sec())
        if i % cfg.out_time_steps == 0:
            with prof.section("Output"):
                u, v, w, T = solver.get_layer(cfg.outdimx, cfg.outdimy,
                                              cfg.outdimz)
                nc.write_layer(out_layer, u, v, w, T)
            out_layer += 1
        if checkpoint and i % cfg.out_time_steps == 0:
            cur, nxt = ([f.cpu().numpy() for f in st]
                        for st in solver.state())
            save_checkpoint(checkpoint, nsteps, t,
                            **dict(zip(("u", "v", "w", "T"), cur)),
                            **dict(zip(("nu", "nv", "nw", "nT"), nxt)))
        t += dt
        i += 1
        nsteps += 1
        if max_steps is not None and nsteps >= max_steps:
            break
    if not quiet:
        print()
        print(prof.report(csv=csv))
    return solver, errs


def main(argv=None, device="cuda") -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    flags = {"align": False, "CSV": False, "quiet": False, "dump_grid": False,
             "profile": False, "carried": False}
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
        elif arg in ("checkpoint", "resume", "shards",
                     "balance") and i + 1 < len(argv):
            extras[arg] = argv[i + 1]
            i += 1
        elif arg == "GPU":
            # the reference's grammar, GPU [n] (FluidSolver3D.cpp:26-41): n
            # cards are n shards
            if i + 1 < len(argv) and argv[i + 1].isdigit():
                extras.setdefault("shards", argv[i + 1])
                i += 1
        elif arg == "blocking":
            # the reference's grammar, blocking [nBlockZ]
            # (FluidSolver3D.cpp:43-51); no number leaves the reshard
            if i + 1 < len(argv) and argv[i + 1].isdigit():
                extras["nblockz"] = argv[i + 1]
                i += 1
        elif arg in UNPORTED_FLAGS:
            print(f"flag {arg!r} is not supported by the PyTorch port yet: "
                  f"{UNPORTED_FLAGS[arg]}", file=sys.stderr)
            return 2
        elif arg in ("transpose", "decompose"):
            pass  # no effect, as in cmcfs_tpu (layout is the port's own)
        else:
            rest.append(arg)
        i += 1
    if len(rest) < 3:
        print(__doc__)
        return 2
    shards = int(extras.get("shards", 1))
    devices = None
    if shards > 1:
        try:
            devices = make_x_mesh(shards, device=device).devices
        except ValueError as e:
            print(f"shards {shards}: {e}", file=sys.stderr)
            return 2
    run_case(find_file(rest[0]), rest[1], find_file(rest[2]),
             align=flags["align"], csv=flags["CSV"], backend=backend,
             quiet=flags["quiet"], dump_grid=flags["dump_grid"],
             checkpoint=extras.get("checkpoint"), resume=extras.get("resume"),
             profile=flags["profile"], carried=flags["carried"],
             device=device, shards=shards, balance=extras.get("balance"),
             devices=devices, nblockz=int(extras.get("nblockz", 0)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
