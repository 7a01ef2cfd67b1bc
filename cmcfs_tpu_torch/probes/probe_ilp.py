"""ILP probe: do K independent carried chains in one thread overlap their
latency on the card, or does each cost its own serial loop?

Port of ``scripts/probe_ilp.py`` as ``kernels/csrc/probe_ilp.cu``.  Over
(n*nb, 8, 128) float32 a, r and (K, n*nb, 8, 128) d, o, chain q runs
o[q, p] = (d[q, p] - o[q, p-1]*a[p]) * r[p] along the n rows of each
block.  ``seq`` runs the K chains one after another, ``ilp`` carries them
in one row loop; one thread owns one (b, s, l) position of block b.  Both
equal the plain version, and each other, bit for bit.  The script's
default of 64 blocks gives 65,536 threads; the probe also runs 1 and 6
blocks (1,024 and 6,144 threads, a 2D sweep's launch).

    python -m cmcfs_tpu_torch.probes.probe_ilp [--n 256] [--blocks 64]
        [--reps 20] [--chains 4] [--device cuda|cpu]

``chains`` launches the kernel on CUDA tensors and runs ``chains_ref``, the
plain PyTorch version, on CPU tensors.
"""
from __future__ import annotations

import argparse
import sys

import torch

from ..kernels.build import LaunchCounter
from . import common

launches = LaunchCounter()
SMALL_BLOCKS = (1, 6)


def _check(a, r, d, n):
    if a.dim() != 3 or a.shape[0] % n or a.shape != r.shape:
        raise ValueError(f"a, r must be one (n*nb, sub, lanes) shape with n="
                         f"{n}, got {tuple(a.shape)}, {tuple(r.shape)}")
    if d.dim() != 4 or d.shape[1:] != a.shape:
        raise ValueError(f"d must be (K,) + {tuple(a.shape)}, got "
                         f"{tuple(d.shape)}")


def chains(a, r, d, n: int, ilp: bool) -> torch.Tensor:
    """o, shaped as d: the K chains one after another or interleaved."""
    a, r, d = (common.as_f32(x) for x in (a, r, d))
    dev = common.check_tensors("probe_ilp.chains", a, r, d)
    _check(a, r, d, n)
    k = d.shape[0]
    if k not in (1, 2, 4, 8):
        raise ValueError(f"the kernel carries 1, 2, 4 or 8 chains, not {k}")
    if dev.type == "cpu":
        return chains_ref(a, r, d, n, ilp)
    o = torch.empty_like(d)
    row = a.shape[1] * a.shape[2]
    common.launch("cmcfs_probe_ilp", dev, a.data_ptr(), r.data_ptr(),
                  d.data_ptr(), o.data_ptr(), n, a.shape[0] // n, row, k,
                  int(ilp))
    launches.count += 1
    return o


def chains_ref(a, r, d, n: int, ilp: bool) -> torch.Tensor:
    """Plain PyTorch version of ``chains``: a row loop on every position at
    once; ``ilp`` steps all K chains in it, else one chain after another
    (the same products and sums either way)."""
    a, r, d = (common.as_f32(x) for x in (a, r, d))
    _check(a, r, d, n)
    shape = d.shape
    k, nb = shape[0], shape[1] // n
    a, r = (x.reshape(nb, n, -1) for x in (a, r))
    d = d.reshape(k, nb, n, -1)
    o = torch.empty_like(d)
    if ilp:
        prev = torch.zeros_like(d[:, :, 0])
        for p in range(n):
            prev = (d[:, :, p] - prev * a[:, p]) * r[:, p]
            o[:, :, p] = prev
    else:
        for q in range(k):
            prev = torch.zeros_like(a[:, 0])
            for p in range(n):
                prev = (d[q, :, p] - prev * a[:, p]) * r[:, p]
                o[q, :, p] = prev
    return o.reshape(shape)


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(
        prog="python -m cmcfs_tpu_torch.probes.probe_ilp",
        description="K carried chains one after another vs interleaved")
    ap.add_argument("--n", type=int, default=256)
    ap.add_argument("--blocks", type=int, default=64)
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--chains", type=int, default=4)
    common.add_common_args(ap)
    return ap.parse_args(argv)


def run(args) -> list[common.Row]:
    dev, gen = common.device_and_generator(args)
    n, k = args.n, args.chains
    rows = []
    for nb in (args.blocks,) + tuple(b for b in SMALL_BLOCKS
                                     if b != args.blocks):
        a = common.uniform((n * nb, 8, 128), 0.1, 0.2, gen, dev)
        r = common.uniform((n * nb, 8, 128), 0.9, 1.1, gen, dev)
        d = common.uniform((k, n * nb, 8, 128), 0.0, 1.0, gen, dev)
        for name, ilp in (("seq", False), ("ilp", True)):
            row = common.measure(
                f"{name}@{nb * 1024}", lambda: chains(a, r, d, n, ilp),
                lambda: chains_ref(a, r, d, n, ilp), args.reps, dev,
                # a and r read once a row, each chain's d read and o written
                nbytes=(8 + 8 * k) * n * nb * 1024)
            row.note = (f"{row.ms * 1e6 / (k * n):7.2f} ns/chain-step, "
                        f"{nb * 1024} threads")
            rows.append(row)
    return rows


def main(argv=None) -> int:
    args = parse_args(argv)
    rows = run(args)
    common.print_table(f"probe_ilp: n={args.n}, chains={args.chains}", rows,
                       torch.device(args.device))
    return 0 if all(r.ok for r in rows) else 1


if __name__ == "__main__":
    sys.exit(main())
