"""Where a 2D ADI step's device time goes, by kernel, on one GPU.

    python -m cmcfs_tpu_torch.profile2d [--n 1024] [--backend fused_nl]
        [--steps 10] [--exact]

Runs ``bench.py run_bench_2d``'s configuration at n x n (``--n 1024`` is
``bench --case 2d1024``, 2048 is 2d2048): the lid cavity
(``geom/synthetic.lid_cavity_2d``, dx 0.001), the physical parameters
``FluidParams.physical(0.05, 1000, 461.495, 0.6, 4200)``, dt 0.0005, ng=2
nl=1, ``exact=False`` unless ``--exact``.  One warm-up step, then
``--steps`` steps under ``torch.profiler``; prints the dispatch, ms/step
(host clock, device synchronised), the device time of each kernel (total,
launches, share), the port's kernels' share and the device's busy share
of the profiled window, as ``profile3d`` does.  Needs a CUDA device; it
never runs on the CPU.
"""
from __future__ import annotations

import argparse
import sys

import torch

from .core.params import FluidParams
from .geom.synthetic import lid_cavity_2d
from .models import adi2d
from .models import common2d as c2
from .profile3d import profile_steps

DT = 0.0005
NUM_GLOBAL, NUM_LOCAL = 2, 1


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=1024)
    ap.add_argument("--backend", default="fused_nl")
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--exact", action="store_true",
                    help="two divisions a row (default: reciprocal)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile2d needs a CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    g = lid_cavity_2d(args.n, args.n, dx=0.001)
    ga = c2.grid_arrays(g, dev)
    so = adi2d.stream_ok_2d(ga)
    params = FluidParams.physical(0.05, 1000.0, 461.495, 0.6, 4200.0)
    pa = adi2d.make_params(params, g.dx, g.dy, 1.0)
    rep = adi2d.dispatch_report_2d((args.n, args.n), args.backend, so)
    print(f"grid {args.n}x{args.n}, ng={NUM_GLOBAL} nl={NUM_LOCAL}, "
          f"exact={args.exact}; dispatch: backend={args.backend} "
          f"stream_ok={so} dirs={rep}")
    state = [c2.init_state(g, dev)]
    iters = []

    def step():
        cur, _, it = adi2d.adi_timestep_2d(
            state[0], ga, DT, NUM_GLOBAL, NUM_LOCAL, pa, backend=args.backend,
            exact=args.exact, stream_ok=so)
        state[0] = cur
        iters.append(it)

    rc = profile_steps(step, args.steps)
    print(f"global iterations per step {iters}")
    return rc


if __name__ == "__main__":
    sys.exit(main())
