"""Where a 3D ADI step's device time goes, by kernel, on one GPU.

    python -m cmcfs_tpu_torch.profile3d [--dx 0.00409] [--num-local 2]
        [--backend auto] [--steps 3] [--inexact] [--baffle N] [--shards N]
        [--cards] [--blocking NB]

Builds the extruded bench box (``scripts/gen_box_case.gen``; dx 0.00409
is 256^3, 0.0027267 is ``bench --case 3d384``'s 383^3) with num_global=4,
or with ``--baffle N`` the N^3 lid cavity with the FREE baffle
(``geom.baffle``: X on the pair kernel's dual form; normalized parameters
Re 200, Pr 0.72, lambda 1.4, dt 0.01, as ``chip_smoke.py`` runs it),
with ``--shards N`` split over X into N shards on the one card (the
MGPU_EMU analogue, ``devices=["cuda:0"] * N``; with ``--cards``, over the
first N cards; with ``--blocking NB``, a fallback X direction on the
Z-blocked wavefront, whose carry kernels then appear by name), runs one
warm-up step,
then profiles ``--steps`` steps with ``torch.profiler`` and prints: the
dispatch, ms/step (host clock, device synchronised), the device time of
each kernel (total, launches, share), and the device's busy share of the
profiled window (the union of kernel intervals over the span from the
first to the last recorded event).
Needs a CUDA device; it never runs on the CPU.
"""
from __future__ import annotations

import argparse
import os
import sys
import tempfile
import time

import torch

from . import cli3d
from .models.solver3d import AdiSolver3D


def _kernel_events(prof):
    """(name, start_us, end_us, device) of every device kernel the profiler
    saw."""
    out = []
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            out.append((e.name, e.time_range.start, e.time_range.end,
                        e.device_index))
    return out


def _busy_us(intervals) -> float:
    """Length of the union of [start, end) intervals."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--dx", type=float, default=0.00409)
    ap.add_argument("--num-local", type=int, default=2)
    ap.add_argument("--backend", default="auto")
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--inexact", action="store_true",
                    help="reciprocal Thomas (exact=False)")
    ap.add_argument("--baffle", type=int, default=0,
                    help="the N^3 lid cavity with the FREE baffle")
    ap.add_argument("--shards", type=int, default=1,
                    help="split X into N shards on cuda:0")
    ap.add_argument("--cards", action="store_true",
                    help="put the shards on cuda:0..N-1")
    ap.add_argument("--blocking", type=int, default=0,
                    help="nBlockZ of the wavefront X sweep under --shards")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile3d needs a CUDA device", file=sys.stderr)
        return 1
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(0, root)
    from scripts.gen_box_case import gen

    num_global, num_local = 4, args.num_local
    solver = AdiSolver3D(backend=args.backend, exact=not args.inexact)
    if args.baffle:
        from .core.params import FluidParams
        from .geom.baffle import free_baffled
        grid = free_baffled(args.baffle, args.baffle, args.baffle)
        solver.init(grid, FluidParams.normalized(200.0, 0.72, 1.4))
        dt = 0.01
    else:
        work = tempfile.mkdtemp(prefix="cmcfs_profile_")
        data, cfgp = gen(work, dx=args.dx, time_steps=4,
                         num_global=num_global, num_local=num_local)
        cfg, params, grid = cli3d.load_case(data, cfgp)
        solver.init(grid, params)
        dt = grid.cycle_len / (grid.num_frames * cfg.time_steps)
    if args.shards > 1:
        from .parallel.mesh import make_x_mesh
        solver.set_plan(make_x_mesh(args.shards) if args.cards else
                        make_x_mesh(devices=["cuda:0"] * args.shards),
                        nblockz=args.blocking)
    rep = solver.dispatch_report(num_local)
    ga = solver.ga if solver.plan is None else solver.ga.x[0]
    print(f"grid {grid.dimx}x{grid.dimy}x{grid.dimz}, ng={num_global} "
          f"nl={num_local}, exact={solver.exact}; dispatch: "
          f"backend={rep['backend']} pad={rep['pad']} pcr={rep['pcr']} "
          f"bf16={rep['bf16']} dirs={rep['dirs']}; dual planes "
          f"{[f is not None for f in ga.dual_flags]}; shards {args.shards}, "
          f"blocking {args.blocking}")

    def step():
        solver.update_boundaries()
        solver.time_step(dt, num_global, num_local, compute_error=False)

    return profile_steps(step, args.steps)


# the port's own kernels (kernels/csrc/*.cu); every other device kernel is
# PyTorch's (the RHS build, folds, merges and copies around them)
PORT_KERNELS = ("pair_sweep_iter_kernel", "line_sweep_kernel",
                "tridiag_rows_kernel", "pcr_sweep_iter_kernel",
                "carry_fwd_kernel", "carry_bwd_kernel")


def profile_steps(step, steps: int) -> int:
    """Run ``step`` once to warm up, then ``steps`` times under
    ``torch.profiler``; print ms/step, the device time of each kernel and
    the device's busy share.  Returns 1 if no device kernel was seen."""
    step()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            step()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    print(f"{wall / steps * 1e3:.2f} ms/step over {steps} profiled "
          f"steps; peak device memory "
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    kernels = _kernel_events(prof)
    if not kernels:
        print("the profiler recorded no device kernels", file=sys.stderr)
        return 1
    by_name: dict[str, list] = {}
    for name, s, e, _ in kernels:
        ent = by_name.setdefault(name, [0, 0.0])
        ent[0] += 1
        ent[1] += e - s
    total = sum(t for _, t in by_name.values())
    # the profiler names them "(anonymous namespace)::<kernel>(<args>)",
    # templates "...::<kernel><4, false, true, 64, 8>(<args>)"
    ours = sum(t for name, (_, t) in by_name.items()
               if any(k + c in name for k in PORT_KERNELS for c in "(<"))
    span = (max(e.time_range.end for e in prof.events())
            - min(e.time_range.start for e in prof.events()))
    busy = _busy_us([(s, e) for _, s, e, _ in kernels])
    print(f"device kernel time {total / 1e3:.2f} ms; busy {busy / 1e3:.2f} "
          f"of {span / 1e3:.2f} ms profiled ({100 * busy / span:.1f} %); "
          f"the port's kernels {100 * ours / total:.1f} % of kernel time")
    devices = sorted({d for *_, d in kernels})
    if len(devices) > 1:
        per = {d: _busy_us([(s, e) for _, s, e, k in kernels if k == d])
               for d in devices}
        print("busy by device: " + "; ".join(
            f"cuda:{d} {t / 1e3:.2f} ms" for d, t in per.items()))
    print(f"{'ms':>10}{'launches':>10}{'share':>8}  kernel")
    for name, (n, t) in sorted(by_name.items(), key=lambda kv: -kv[1][1]):
        print(f"{t / 1e3:>10.3f}{n:>10}{100 * t / total:>7.1f}%  {name[:90]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
