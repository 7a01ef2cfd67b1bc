"""Row-cost probe: what one serial row step of a Thomas-like carried chain
costs on the card.

Port of ``scripts/probe_rowcost.py`` as ``kernels/csrc/probe_rowcost.cu``.
Along the n rows of each block of an (n*nb, sub, lanes) float32 array,
o[p] = (d[p] - o[p-1]*a[p]) * r[p], o[-1] = 0.  One thread carries one
chain (b, s, l), or K chains of one block interleaved (the wide variants),
so all chains of the launch run at once and each thread walks its rows
serially.  The variants (``VARIANTS``): the script's ``base`` (8, 128),
``noload`` (a, r, d of row 0 only, n dependent steps, only row 0 of each
block written), ``wide_j`` (16, 128), ``wide_l`` (8, 256), ``wide4``
(8, 512), same cells in all; and two of the card's own: ``strided``
(base's chains on a chain-major copy, ``chain_major``: the Y sweeps'
layout) and ``base_fma`` (base with nvcc's mul-sub contraction, pricing
the explicit rounding of the others).  ``--chains`` runs base and strided
at several thread counts: the 2D sweeps launch 1-6 thousand, a 256^3 sweep
65,536.

    python -m cmcfs_tpu_torch.probes.probe_rowcost [--n 256] [--cells C]
        [--reps 20] [--chains 1024,3072,6144,65536] [--device cuda|cpu]

``chain`` launches the kernel on CUDA tensors and runs ``chain_ref``, the
plain PyTorch version, on CPU tensors.
"""
from __future__ import annotations

import argparse
import sys

import torch

from ..kernels.build import LaunchCounter
from . import common

launches = LaunchCounter()

# name: (sub, lanes, chains per thread, kernel mode)
VARIANTS = {
    "base": (8, 128, 1, 0),
    "noload": (8, 128, 1, 2),
    "wide_j": (16, 128, 2, 0),
    "wide_l": (8, 256, 2, 0),
    "wide4": (8, 512, 4, 0),
    "strided": (8, 128, 1, 3),
    "base_fma": (8, 128, 1, 1),
}


def chain_major(x: torch.Tensor, n: int) -> torch.Tensor:
    """(n*nb, sub, lanes) -> (nb, sub*lanes, n), each chain contiguous."""
    nb = x.shape[0] // n
    return x.reshape(nb, n, -1).transpose(1, 2).contiguous()


def from_chain_major(x: torch.Tensor, sub: int, lanes: int) -> torch.Tensor:
    """The inverse of ``chain_major``."""
    nb, _, n = x.shape
    return x.transpose(1, 2).reshape(nb * n, sub, lanes)


def _shape(a: torch.Tensor, n: int, variant: str) -> tuple[int, int]:
    """(nb, row) of the inputs, checked against the variant."""
    if variant not in VARIANTS:
        raise ValueError(f"unknown variant {variant!r}")
    sub, lanes = VARIANTS[variant][:2]
    if variant == "strided":
        if a.dim() != 3 or a.shape[2] != n:
            raise ValueError(f"strided takes chain-major (nb, row, {n}), "
                             f"got {tuple(a.shape)}")
        return a.shape[0], a.shape[1]
    if a.dim() != 3 or a.shape[0] % n or a.shape[1:] != (sub, lanes):
        raise ValueError(f"{variant} takes (n*nb, {sub}, {lanes}) with n="
                         f"{n}, got {tuple(a.shape)}")
    return a.shape[0] // n, sub * lanes


def chain(a, r, d, n: int, variant: str = "base") -> torch.Tensor:
    """o of ``variant`` (a, r, d and o chain-major for ``strided``;
    ``noload`` returns row 0 of each block, (nb, sub, lanes))."""
    a, r, d = (common.as_f32(x) for x in (a, r, d))
    dev = common.check_tensors("probe_rowcost.chain", a, r, d)
    nb, row = _shape(a, n, variant)
    if not a.shape == r.shape == d.shape:
        raise ValueError("a, r, d must have one shape")
    if dev.type == "cpu":
        return chain_ref(a, r, d, n, variant)
    _, _, k, mode = VARIANTS[variant]
    o = torch.empty_like(a)
    common.launch("cmcfs_probe_rowcost", dev, a.data_ptr(), r.data_ptr(),
                  d.data_ptr(), o.data_ptr(), n, nb, row, k, mode)
    launches.count += 1
    if variant == "noload":
        return o.view(nb, n, *a.shape[1:])[:, 0]
    return o


def chain_ref(a, r, d, n: int, variant: str = "base") -> torch.Tensor:
    """Plain PyTorch version of ``chain``: a Python loop over the rows,
    each step on every chain at once."""
    a, r, d = (common.as_f32(x) for x in (a, r, d))
    nb, row = _shape(a, n, variant)
    if variant == "strided":
        a, r, d = (x.transpose(1, 2) for x in (a, r, d))
    else:
        a, r, d = (x.reshape(nb, n, row) for x in (a, r, d))
    prev = torch.zeros((nb, row), dtype=torch.float32, device=a.device)
    if variant == "noload":
        a0, r0, d0 = a[:, 0], r[:, 0], d[:, 0]
        for _ in range(n):
            prev = (d0 - prev * a0) * r0
        return prev.reshape(nb, *VARIANTS[variant][:2])
    o = torch.empty_like(a)
    for p in range(n):
        prev = (d[:, p] - prev * a[:, p]) * r[:, p]
        o[:, p] = prev
    if variant == "strided":
        return o.transpose(1, 2).contiguous()
    return o.reshape(nb * n, *VARIANTS[variant][:2])


def inputs(shape, gen: torch.Generator, dev: torch.device):
    """a in [0.1, 0.2), r in [0.9, 1.1), d in [0, 1): the script's ranges."""
    return (common.uniform(shape, 0.1, 0.2, gen, dev),
            common.uniform(shape, 0.9, 1.1, gen, dev),
            common.uniform(shape, 0.0, 1.0, gen, dev))


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(
        prog="python -m cmcfs_tpu_torch.probes.probe_rowcost",
        description="cost of one serial row step of a carried chain")
    ap.add_argument("--n", type=int, default=256)
    ap.add_argument("--cells", type=int, default=256 * 64 * 8 * 128)
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--chains", default="1024,3072,6144,65536",
                    help="chain counts for base and strided at (8, 128) "
                         "rows ('' for none)")
    common.add_common_args(ap)
    return ap.parse_args(argv)


def _row(name, label, n, nb, gen, dev, reps) -> common.Row:
    sub, lanes, k, _ = VARIANTS[name]
    a, r, d = inputs((n * nb, sub, lanes), gen, dev)
    if name == "strided":
        a, r, d = (chain_major(x, n) for x in (a, r, d))
    chains = nb * sub * lanes
    row = common.measure(
        label, lambda: chain(a, r, d, n, name),
        lambda: chain_ref(a, r, d, n, name), reps, dev,
        # a, r, d read and o written; noload only row 0 of each chain
        nbytes=16 * chains * (1 if name == "noload" else n),
        rel_tol=1e-6 if name == "base_fma" else 0.0)
    row.note = (f"{row.ms * 1e6 / n:7.2f} ns/row step, "
                f"{chains * n / row.ms / 1e6:7.2f} Gcell/s, "
                f"{chains // k} threads")
    return row


def run(args) -> list[common.Row]:
    dev, gen = common.device_and_generator(args)
    n = args.n
    rows = []
    for name, (sub, lanes, _, _) in VARIANTS.items():
        nb = args.cells // (n * sub * lanes)
        if nb < 1:
            raise ValueError(f"--cells {args.cells} is less than one block "
                             f"of {name}")
        rows.append(_row(name, name, n, nb, gen, dev, args.reps))
    for chains in (int(c) for c in args.chains.split(",") if c):
        if chains % 1024:
            raise ValueError(f"--chains {chains}: not a multiple of 1024")
        for name in ("base", "strided"):
            rows.append(_row(name, f"{name}@{chains}", n, chains // 1024,
                             gen, dev, args.reps))
    return rows


def main(argv=None) -> int:
    args = parse_args(argv)
    rows = run(args)
    common.print_table(f"probe_rowcost: n={args.n}, {args.cells / 1e6:.1f}M "
                       "cells a run", rows, torch.device(args.device))
    return 0 if all(r.ok for r in rows) else 1


if __name__ == "__main__":
    sys.exit(main())
