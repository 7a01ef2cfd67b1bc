"""Backend cross-check: run one 3D case on two backends and diff the results.

    python -m cmcfs_tpu_torch.verify <input> <config> [A B] [align] [steps N]
                                     [shards N]

Runs the case end to end through ``cli3d.run_case`` on backends A and B
(default: ``scan``, the exact-order row path, against ``auto``, the
card's pair kernels), then compares the NetCDF output records variable by
variable and the divergence-error sequences; a record whose largest
difference reaches 1e-5 of its largest value fails the check (port of
cmcfs_tpu/verify.py).  Exits 0 when every record agrees, 1 otherwise.
``shards N`` runs side B split over N cards (cmcfs_tpu's multi-device
arm), and exits 2 naming the visible count when fewer are visible.  The
runs need a CUDA device.
"""
from __future__ import annotations

import sys
import tempfile

import numpy as np


def verify_3d(input_path: str, config_path: str, be_a: str, be_b: str,
              align: bool = False, max_steps: int | None = None,
              device="cuda", shards: int = 1, devices=None) -> int:
    """Side B runs split over ``shards`` shards (``cli3d.run_case``'s
    ``devices``, ``device``); each side writes its own file, so A and B
    may name one backend."""
    from .cli3d import run_case
    from .io.netcdf3 import NetCDF3Reader

    tmp = tempfile.mkdtemp(prefix="cmcfs_verify_")
    outs = []
    errs = []
    for side, be in (("a", be_a), ("b", be_b)):
        base = f"{tmp}/{side}_{be}"
        _, e = run_case(input_path, base, config_path, align=align,
                        backend=be, quiet=True, collect_errs=True,
                        max_steps=max_steps, device=device,
                        shards=shards if side == "b" else 1,
                        devices=devices if side == "b" else None)
        outs.append(base + "_res.nc")
        errs.append(e)
    ra = NetCDF3Reader(outs[0])
    rb = NetCDF3Reader(outs[1])
    worst = 0.0
    rc = 0
    for var in "uvwT":
        a = ra.read(var)
        b = rb.read(var)
        if a.shape != b.shape:
            print(f"{var}: record shape mismatch {a.shape} vs {b.shape}")
            rc = 1
            continue
        for rec in range(len(a)):
            real = a[rec] < 9e4
            if not (real == (b[rec] < 9e4)).all():
                print(f"{var} rec {rec}: MISSING masks differ")
                rc = 1
                continue
            scale = max(np.abs(a[rec][real]).max(), 1e-30)
            rel = float(np.abs(a[rec] - b[rec])[real].max() / scale)
            worst = max(worst, rel)
            mark = "" if rel < 1e-5 else "   <-- above 1e-5"
            print(f"{var} rec {rec}: rel diff {rel:.3e}{mark}")
            if rel >= 1e-5:
                rc = 1
    ed = max((abs(x - y) for x, y in zip(*errs)), default=0.0)
    print(f"div-err sequence max |diff| = {ed:.3e}")
    b_name = be_b if shards == 1 else f"{be_b} on {shards} shards"
    print(f"worst relative field diff   = {worst:.3e}  "
          f"[{be_a} vs {b_name}] -> {'OK' if rc == 0 else 'MISMATCH'}")
    return rc


def main(argv=None, device="cuda") -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    align = False
    max_steps = None
    shards = 1
    rest = []
    i = 0
    while i < len(argv):
        if argv[i] == "align":
            align = True
        elif argv[i] == "shards" and i + 1 < len(argv):
            shards = int(argv[i + 1])
            i += 1
        elif argv[i] == "steps" and i + 1 < len(argv):
            max_steps = int(argv[i + 1])
            i += 1
        else:
            rest.append(argv[i])
        i += 1
    if len(rest) < 2:
        print(__doc__)
        return 2
    devices = None
    if shards > 1:
        from .parallel.mesh import make_x_mesh
        try:
            devices = make_x_mesh(shards, device=device).devices
        except ValueError as e:
            print(f"shards {shards}: {e}", file=sys.stderr)
            return 2
    be_a = rest[2] if len(rest) > 2 else "scan"
    be_b = rest[3] if len(rest) > 3 else "auto"
    return verify_3d(rest[0], rest[1], be_a, be_b, align=align,
                     max_steps=max_steps, device=device, shards=shards,
                     devices=devices)


if __name__ == "__main__":
    sys.exit(main())
