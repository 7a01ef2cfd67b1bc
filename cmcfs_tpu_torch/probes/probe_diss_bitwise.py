"""In-kernel dissipation probe: does a CUDA kernel's diss_x equal the plain
PyTorch stencil bit for bit, with and without nvcc's FMA contraction?

Port of ``scripts/probe_diss_bitwise.py`` as ``kernels/csrc/probe_diss.cu``.
diss = 2*ux*ux + vx*vx + wx*wx + vx*uy + wx*uz on an (n0, n1, n2) field,
with central differences (f[i+1] - f[i-1]) * inv2h along axes 0, 1, 2 whose
edge neighbours are clamped, inv2h = 1/(2h) for the script's spacings
h = (0.00409, 0.0037, 0.0041).  Two builds of the kernel: ``rounded``
(every product and sum rounded in the plain order, as the production
kernels round) and ``contracted`` (the plain C++ expression, FMAs).  Each
is held against the plain version, then compared, as the script compares
its kernel, with the port's ``ops.stencil.diss_x_3d`` on interior cells
(``compare_interior``: bitwise, mismatch fraction, max relative error),
at the script's (128, 8, 128) slab and at 256^3.

    python -m cmcfs_tpu_torch.probes.probe_diss_bitwise [--n 128]
        [--reps 20] [--device cuda|cpu]

``diss`` launches the kernel on CUDA tensors and runs ``diss_ref``, the
plain PyTorch version, on CPU tensors.
"""
from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from ..kernels.build import LaunchCounter
from ..ops.stencil import diss_x_3d
from . import common

launches = LaunchCounter()
H = (0.00409, 0.0037, 0.0041)
CUBE = (256, 256, 256)


def inv2h(h=H) -> np.ndarray:
    """The script's scal: float32 1/(2h) of each spacing."""
    return np.array([1.0 / (2 * x) for x in h], dtype=np.float32)


def _fields(u, v, w):
    u, v, w = (common.as_f32(x) for x in (u, v, w))
    dev = common.check_tensors("probe_diss_bitwise", u, v, w)
    if u.dim() != 3 or not u.shape == v.shape == w.shape:
        raise ValueError(f"u, v, w must be one 3D shape, got {tuple(u.shape)}"
                         f", {tuple(v.shape)}, {tuple(w.shape)}")
    return u, v, w, dev


def diss(u, v, w, scal, rounded: bool = True) -> torch.Tensor:
    """diss_x of (u, v, w) with ``scal`` = (1/(2hx), 1/(2hy), 1/(2hz))."""
    u, v, w, dev = _fields(u, v, w)
    if dev.type == "cpu":
        return diss_ref(u, v, w, scal)
    out = torch.empty_like(u)
    sx, sy, sz = (float(x) for x in np.asarray(scal, dtype=np.float32))
    common.launch("cmcfs_probe_diss", dev, u.data_ptr(), v.data_ptr(),
                  w.data_ptr(), out.data_ptr(), *u.shape, sx, sy, sz,
                  int(rounded))
    launches.count += 1
    return out


def _d(f: torch.Tensor, axis: int, inv: float) -> torch.Tensor:
    n = f.shape[axis]
    fp = torch.cat((f.narrow(axis, 1, n - 1), f.narrow(axis, n - 1, 1)), axis)
    fm = torch.cat((f.narrow(axis, 0, 1), f.narrow(axis, 0, n - 1)), axis)
    return (fp - fm) * inv


def diss_ref(u, v, w, scal) -> torch.Tensor:
    """Plain PyTorch version of ``diss``: the script's kernel expression,
    every operation rounded."""
    u, v, w, _ = _fields(u, v, w)
    sx, sy, sz = (float(x) for x in np.asarray(scal, dtype=np.float32))
    ux, vx, wx = _d(u, 0, sx), _d(v, 0, sx), _d(w, 0, sx)
    uy, uz = _d(u, 1, sy), _d(u, 2, sz)
    return 2 * ux * ux + vx * vx + wx * wx + vx * uy + wx * uz


def compare_interior(got, want) -> tuple[bool, float, float]:
    """(bitwise, mismatch fraction, max relative error) of got against want
    on the cells off every edge, as the script reports them."""
    g = common.as_f32(got)[1:-1, 1:-1, 1:-1]
    w = common.as_f32(want)[1:-1, 1:-1, 1:-1]
    same = g.view(torch.int32) == w.view(torch.int32)
    rel = (g - w).abs() / w.abs().clamp_min(1e-20)
    frac = float((~same).sum()) / same.numel()
    return bool(same.all()), frac, float(rel.max())


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(
        prog="python -m cmcfs_tpu_torch.probes.probe_diss_bitwise",
        description="in-kernel diss_x against the plain stencil, bit for "
                    "bit")
    ap.add_argument("--n", type=int, default=128)
    ap.add_argument("--reps", type=int, default=20)
    common.add_common_args(ap)
    return ap.parse_args(argv)


def run(args) -> list[common.Row]:
    dev, gen = common.device_and_generator(args)
    scal = inv2h()
    rows = []
    for shape in ((args.n, 8, 128), CUBE):
        u, v, w = (common.uniform(shape, -1.0, 1.0, gen, dev)
                   for _ in range(3))
        cells = u.numel()
        want = diss_x_3d(u, v, w, *H)
        for build, rounded in (("rounded", True), ("contracted", False)):
            row = common.measure(
                f"{build}@{'x'.join(map(str, shape))}",
                lambda: diss(u, v, w, scal, rounded),
                lambda: diss_ref(u, v, w, scal), args.reps, dev,
                nbytes=16 * cells, rel_tol=0.0 if rounded else 1e-6,
                flops=20 * cells)
            same, frac, rel = compare_interior(diss(u, v, w, scal, rounded),
                                               want)
            row.note = (f"vs stencil.diss_x_3d: bitwise={same} "
                        f"mismatch_frac={frac:.2e} max_rel={rel:.3e}")
            rows.append(row)
    return rows


def main(argv=None) -> int:
    args = parse_args(argv)
    rows = run(args)
    common.print_table("probe_diss_bitwise: in-kernel diss_x, interior cells",
                       rows, torch.device(args.device))
    return 0 if all(r.ok for r in rows) else 1


if __name__ == "__main__":
    sys.exit(main())
