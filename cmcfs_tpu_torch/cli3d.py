"""FluidSolver3D command line on the PyTorch + CUDA port.

Usage (grammar of reference src/FluidSolver3D/FluidSolver3D.cpp:26-51):
    python -m cmcfs_tpu_torch.cli3d <input> <output_base> <config> [flags]

Flags: ``align``, ``CSV`` (section table as CSV), ``quiet``, ``backend
auto|fused_nl|fused_pcr|fused_bf16|fused_pcr_bf16|fused_full|fused_dma|fused|
scan|pallas|pcr``;
``transpose`` and ``decompose`` are accepted and have no effect, as in
cmcfs_tpu.  The run needs a CUDA device.
Flags of cmcfs_tpu's CLI that the port does not have yet exit with
status 2 and name their ROADMAP item.
"""
from __future__ import annotations

import contextlib
import sys
import time

import numpy as np
import torch

from .core.config import Config
from .core.params import FluidParams
from .core.scene2d import Scene2D
from .core.scene3d import Bathymetry, Scene3D
from .geom.grid3d import Grid3D
from .geom.raster2d import Grid2D
from .io import writers
from .io.project import find_file
from .models.solver3d import make_solver_3d
from .utils.timer import CpuTimer, print_time_step_info

# cmcfs_tpu CLI flags the port does not have yet, and where they are queued
UNPORTED_FLAGS = {
    "GPU": "multi-GPU runs (ROADMAP A8)",
    "shards": "multi-GPU runs (ROADMAP A8)",
    "blocking": "the Z-blocked wavefront X sweep (ROADMAP A8)",
    "balance": "multi-GPU load balancing (ROADMAP A8)",
    "hosts": "multi-host runs (ROADMAP A8)",
    "rank": "multi-host runs (ROADMAP A8)",
    "coordinator": "multi-host runs (ROADMAP A8)",
    "checkpoint": "checkpoint/resume (ROADMAP A5)",
    "resume": "checkpoint/resume (ROADMAP A5)",
    "orbax": "the orbax checkpoint tier (ROADMAP A5)",
    "carried": "the carried-state loop (ROADMAP A5)",
    "profile": "the per-direction profiled step (ROADMAP A5)",
    "dump_grid": "the BMP mask dump (ROADMAP A5)",
}


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


class SectionTimer:
    """Named wall-clock sections (count / total / average ms), each closed
    by a device synchronize so queued kernels count where they ran."""

    def __init__(self, device: torch.device):
        self.device = device
        self.events: dict[str, list] = {}
        self._wall0 = time.perf_counter()

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    @contextlib.contextmanager
    def section(self, name: str):
        self._sync()
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self._sync()
            ev = self.events.setdefault(name, [0, 0.0])
            ev[0] += 1
            ev[1] += time.perf_counter() - t0

    def report(self, csv: bool = False) -> str:
        rows = sorted(self.events.items(), key=lambda kv: -kv[1][1])
        wall = time.perf_counter() - self._wall0
        if csv:
            out = ["event,count,total_ms,avg_ms"]
            out += [f"{k},{c},{t * 1e3:.3f},{t * 1e3 / max(c, 1):.3f}"
                    for k, (c, t) in rows]
            out.append(f"overall_sec,,{wall:.3f},")
        else:
            out = [f"{'event':<24}{'count':>8}{'total ms':>14}{'avg ms':>12}"]
            out += [f"{k:<24}{c:>8}{t * 1e3:>14.3f}{t * 1e3 / max(c, 1):>12.3f}"
                    for k, (c, t) in rows]
            out.append(f"overall: {wall:.3f} sec")
        return "\n".join(out)


def run_case(input_path: str, output_base: str, config_path: str,
             align: bool = False, csv: bool = False, backend: str = "auto",
             quiet: bool = False, max_steps: int | None = None,
             collect_errs: bool = False, device="cuda"):
    """Run one case end to end; returns (solver, errs)."""
    t0 = time.perf_counter()
    cfg, params, grid = load_case(input_path, config_path, align=align)
    build_s = time.perf_counter() - t0
    n_in, volume = grid.fluid_volume()
    if not quiet:
        print(f"Grid = {grid.dimx} x {grid.dimy} x {grid.dimz} "
              f"(host build {build_s:.2f} s)")
        print(f"NODE_IN points = {n_in} of total "
              f"{grid.dimx * grid.dimy * grid.dimz}, volume = {volume:f}")

    solver = make_solver_3d(cfg.solver, backend=backend, device=device)
    solver.init(grid, params)

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
    nc = writers.NetCDF3DOutput(
        output_base + "_res.nc", grid.bbox_min, grid.bbox_max,
        dt * cfg.out_time_steps, finaltime, cfg.outdimx, cfg.outdimy,
        cfg.outdimz, cfg.out_vars, xy_degree_units=cfg.in_fmt == "SeaNetCDF",
        depths=None if depths is None else depths.depth)

    if not quiet:
        rep = solver.dispatch_report(cfg.num_local)
        print(f"dispatch: backend={rep['backend']} pad={rep['pad']} "
              f"pcr={rep['pcr']} bf16={rep['bf16']} dirs={rep['dirs']}")

    prof = SectionTimer(solver.device)
    timer = CpuTimer()
    timer.start()
    errs = []
    out_layer = 0
    t = dt
    i = 0
    nsteps = 0
    while t < finaltime:
        compute_err = (i % 10 == 0) or (t + dt >= finaltime)
        with prof.section("UpdateBoundaries"):
            solver.update_boundaries()
        with prof.section("TimeStep"):
            solver.time_step(dt, cfg.num_global, cfg.num_local, compute_err)
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
        t += dt
        i += 1
        nsteps += 1
        if max_steps is not None and nsteps >= max_steps:
            break
    if not quiet:
        print()
        print(prof.report(csv=csv))
    return solver, errs


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    flags = {"align": False, "CSV": False, "quiet": False}
    backend = "auto"
    rest = []
    i = 0
    while i < len(argv):
        arg = argv[i]
        if arg in flags:
            flags[arg] = True
        elif arg == "backend" and i + 1 < len(argv):
            backend = argv[i + 1]
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
    run_case(find_file(rest[0]), rest[1], find_file(rest[2]),
             align=flags["align"], csv=flags["CSV"], backend=backend,
             quiet=flags["quiet"])
    return 0


if __name__ == "__main__":
    sys.exit(main())
