"""Slab-copy probe: how fast the card brings one 256^3 float32 array on chip
in the access patterns of the sweep kernels.

Port of ``scripts/probe_slabdma.py`` as ``kernels/csrc/probe_slabdma.cu``.
The array is read as 64 slabs (256, 8, 128), ``depth`` stages in flight
through shared memory: ``strided`` (slab b = dense[:, 8jj:8jj+8,
128cc:128cc+128], jj, cc = divmod(b, 2)), ``fullc`` (dense[:, 8jj:8jj+8,
:], 8-KB pieces, read for both cc) and ``blocked`` (one contiguous slab of
the (32, 2, 256, 8, 128) copy ``blocked_of`` makes).  The output is
out[p] = sum over b of slab_b[p, :, :128] for every plane p, summed in
slab order, so every byte brought on chip reaches it and kernel and plain
version agree bit for bit; out[0] is the script's acc.  ``lines`` / ``lines_tiled``
read the dense array once more as 65,536 lines along its contiguous axis
(the Z sweeps' access), one thread a line, by direct loads or through a
shared-memory transpose, and sum each line in order.

    python -m cmcfs_tpu_torch.probes.probe_slabdma [--reps 20] [--depth 4]
        [--device cuda|cpu]

``slab_copy`` and ``line_sums`` launch the kernels on CUDA tensors and run
``slab_copy_ref`` / ``line_sums_ref``, the plain PyTorch versions, on CPU
tensors.
"""
from __future__ import annotations

import argparse
import sys

import torch

from ..kernels.build import LaunchCounter
from . import common

launches = LaunchCounter()
N = 256                  # the script's array side
S, L = 8, 128            # a slab's (sublanes, lanes)
MODES = {"strided": 0, "fullc": 1, "blocked": 2}
DEPTHS = (1, 2, 4, 8)


def blocked_of(dense: torch.Tensor) -> torch.Tensor:
    """(n, n, n) -> (n/8, n/128, n, 8, 128), slab (jj, cc) contiguous."""
    n = dense.shape[0]
    return dense.reshape(n, n // S, S, n // L, L).permute(
        1, 3, 0, 2, 4).contiguous()


def _side(x: torch.Tensor, mode: str) -> int:
    if mode not in MODES:
        raise ValueError(f"unknown mode {mode!r}")
    n = x.shape[2] if mode == "blocked" else x.shape[0]
    want = (n // S, n // L, n, S, L) if mode == "blocked" else (n, n, n)
    if n < L or n % L or tuple(x.shape) != want:
        raise ValueError(f"{mode} takes {want} with n a multiple of {L}, "
                         f"got {tuple(x.shape)}")
    return n


def slab_copy(x, mode: str, depth: int = 4) -> torch.Tensor:
    """out (n, 8, 128), out[p] the sum of plane p of every slab of ``x``
    (dense, or ``blocked_of`` for ``blocked``), the slabs brought through
    shared memory, ``depth`` in flight."""
    x = common.as_f32(x)
    dev = common.check_tensors("probe_slabdma.slab_copy", x)
    n = _side(x, mode)
    if depth not in DEPTHS:
        raise ValueError(f"depth must be one of {DEPTHS}, got {depth}")
    if dev.type == "cpu":
        return slab_copy_ref(x, mode)
    out = torch.empty((n, S, L), dtype=torch.float32, device=dev)
    common.launch("cmcfs_probe_slabdma", dev, x.data_ptr(), out.data_ptr(),
                  n, MODES[mode], depth)
    launches.count += 1
    return out


def slab_copy_ref(x, mode: str) -> torch.Tensor:
    """Plain PyTorch version of ``slab_copy``: out += slab_b[:, :, :128]
    for b in slab order."""
    x = common.as_f32(x)
    n = _side(x, mode)
    nc = n // L
    out = torch.zeros((n, S, L), dtype=torch.float32, device=x.device)
    for b in range((n // S) * nc):
        jj, cc = divmod(b, nc)
        if mode == "blocked":
            slab = x[jj, cc]
        elif mode == "fullc":
            slab = x[:, jj * S:(jj + 1) * S, :L]
        else:
            slab = x[:, jj * S:(jj + 1) * S, cc * L:(cc + 1) * L]
        out = out + slab
    return out


def _lines_check(x: torch.Tensor, tiled: bool) -> int:
    n = x.shape[-1]
    if x.dim() < 2 or (tiled and n % 32):
        raise ValueError(f"line_sums takes (..., n) lines (n a multiple of "
                         f"32 when tiled), got {tuple(x.shape)}")
    return n


def line_sums(x, tiled: bool) -> torch.Tensor:
    """x.shape[:-1] sums, each of one line along the last (contiguous) axis,
    in order: one thread a line, direct loads or a shared-memory tile."""
    x = common.as_f32(x)
    dev = common.check_tensors("probe_slabdma.line_sums", x)
    n = _lines_check(x, tiled)
    if dev.type == "cpu":
        return line_sums_ref(x)
    sums = torch.empty(x.shape[:-1], dtype=torch.float32, device=dev)
    common.launch("cmcfs_probe_lines", dev, x.data_ptr(), sums.data_ptr(), n,
                  sums.numel(), int(tiled))
    launches.count += 1
    return sums


def line_sums_ref(x) -> torch.Tensor:
    """Plain PyTorch version of ``line_sums``: s += x[..., k] in order."""
    x = common.as_f32(x)
    s = torch.zeros(x.shape[:-1], dtype=torch.float32, device=x.device)
    for k in range(x.shape[-1]):
        s = s + x[..., k]
    return s


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(
        prog="python -m cmcfs_tpu_torch.probes.probe_slabdma",
        description="slab copy rate: strided, full-width and blocked slabs, "
                    "and lines along the contiguous axis")
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--depth", type=int, default=4)
    common.add_common_args(ap)
    return ap.parse_args(argv)


def run(args) -> list[common.Row]:
    dev, gen = common.device_and_generator(args)
    dense = torch.rand((N, N, N), generator=gen, device=dev)
    blocked = blocked_of(dense)
    nbytes = 4 * N ** 3
    rows = []
    for depth in sorted({1, args.depth}):
        for mode, x in (("strided", dense), ("fullc", dense),
                        ("blocked", blocked)):
            # the array read once and out written: fullc's second read of
            # each 8-row band (for its second cc) comes from L2
            row = common.measure(
                f"{mode}@d{depth}", lambda: slab_copy(x, mode, depth),
                lambda: slab_copy_ref(x, mode), args.reps, dev,
                nbytes + 4 * N * S * L, library=lambda: x.clone())
            row.note = f"{nbytes / row.ms / 1e6:7.1f} GB/s of the array"
            rows.append(row)
    for name, tiled in (("lines", False), ("lines_tiled", True)):
        row = common.measure(
            name, lambda: line_sums(dense, tiled),
            lambda: line_sums_ref(dense), args.reps, dev,
            nbytes + 4 * N * N, library=lambda: dense.sum(-1))
        row.note = f"{nbytes / row.ms / 1e6:7.1f} GB/s of the array"
        rows.append(row)
    return rows


def main(argv=None) -> int:
    args = parse_args(argv)
    rows = run(args)
    common.print_table(f"probe_slabdma: {N}^3 float32, 64 slabs, depth 1 and "
                       f"{args.depth}", rows, torch.device(args.device))
    return 0 if all(r.ok for r in rows) else 1


if __name__ == "__main__":
    sys.exit(main())
