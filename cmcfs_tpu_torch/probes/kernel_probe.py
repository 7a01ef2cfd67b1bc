"""Stream-kernel probe: the copy floor, the compute floor and the real solve
of one 4-variable direction on the card.

Port of ``scripts/kernel_probe.py`` as ``kernels/csrc/kernel_probe.cu``.
Inputs as the script's: temp4, rhs4 (4, n, n, n) and forc (n, n, n)
float32; rows along axis 1 of a field; adv = temp4[1], pk = forc,
a = -adv*0.5 - 1, b = 3 + pk, c = adv*0.5 - 1, d = rhs4[v], Thomas in the
reciprocal form.  Modes (``MODES``):

- ``dma``: out = rhs4, tn = temp4, reading adv, T and pk on the way: the
  copy floor;
- ``full``: the solve, out[v] = d', tn[v] = x;
- ``comp``, ``comp2``, ``comps``, ``compi``, ``pcr``: the same work on
  inputs that stay on chip: every block reads the tile of lines
  (0, p, k < 32) (``tile``), and thread g publishes x_v at tile line g % 32,
  row (g / 32) % n, so pub (4, n*n) covers the tile (``publish``).  comp2
  loads 8 rows ahead of the chain; comps / compi build c' and 1/denom once
  and run the 4 d-chains one after another / interleaved; pcr is parallel
  cyclic reduction.  The script's compute-only modes compute on scratch
  that is never loaded and leave nothing in device memory, so these are
  held against the plain ``full`` on the tile instead.

    python -m cmcfs_tpu_torch.probes.kernel_probe [--n 256] [--reps 10]
        [--modes dma,comp,comp2,comps,compi,pcr,full] [--device cuda|cpu]

``probe`` launches the kernel on CUDA tensors and runs ``probe_ref``, the
plain PyTorch version, on CPU tensors.
"""
from __future__ import annotations

import argparse
import sys

import torch

from ..kernels.build import LaunchCounter
from . import common

launches = LaunchCounter()
MODES = {"dma": 0, "full": 1, "comp": 2, "comp2": 3, "comps": 4, "compi": 5,
         "pcr": 6}
TILE = 32            # lines of the on-chip tile (threads of a comp block)
# float32 operations a (line, row) of the Thomas modes: the row build and
# the solve of 4 variables (comps / compi build the coefficients once);
# pcr a (line, row, level)
FLOPS = {"full": 56, "comp": 56, "comp2": 56, "comps": 36, "compi": 36,
         "pcr": 26}


def _check(temp4, rhs4, forc) -> int:
    n = forc.shape[0]
    if forc.shape != (n, n, n) or temp4.shape != (4, n, n, n) or \
            rhs4.shape != (4, n, n, n):
        raise ValueError(f"temp4, rhs4 must be (4, n, n, n) and forc (n, n, "
                         f"n), got {tuple(temp4.shape)}, {tuple(rhs4.shape)}, "
                         f"{tuple(forc.shape)}")
    if n < TILE or n % 8 or n > 1024:
        raise ValueError(f"n must be a multiple of 8 from {TILE} to 1024, "
                         f"got {n}")
    return n


def probe(temp4, rhs4, forc, mode: str = "full"):
    """(out, tn) for ``dma`` and ``full``; pub (4, n*n) for the others."""
    temp4, rhs4, forc = (common.as_f32(x) for x in (temp4, rhs4, forc))
    dev = common.check_tensors("kernel_probe.probe", temp4, rhs4, forc)
    n = _check(temp4, rhs4, forc)
    if mode not in MODES:
        raise ValueError(f"unknown mode {mode!r}")
    if dev.type == "cpu":
        return probe_ref(temp4, rhs4, forc, mode)
    empty = torch.empty((0,), device=dev)
    out = tn = cp = pub = empty
    if mode in ("dma", "full"):
        out, tn = torch.empty_like(rhs4), torch.empty_like(rhs4)
        if mode == "full":
            cp = torch.empty_like(forc)
    else:
        pub = torch.empty((4, n * n), dtype=torch.float32, device=dev)
    common.launch("cmcfs_kernel_probe", dev, temp4.data_ptr(),
                  rhs4.data_ptr(), forc.data_ptr(), out.data_ptr(),
                  tn.data_ptr(), cp.data_ptr(), pub.data_ptr(), n,
                  MODES[mode])
    launches.count += 1
    return (out, tn) if mode in ("dma", "full") else pub


def _abc(adv, pk):
    return -adv * 0.5 - 1.0, 3.0 + pk, adv * 0.5 - 1.0


def thomas(adv, pk, d4):
    """(out, tn): d' and x of the 4 right-hand sides d4 (4, I, n, K), rows
    along axis 1 of adv, pk (I, n, K); coefficients in the script's order,
    1/denom as the IEEE reciprocal."""
    a, b, c = _abc(adv, pk)
    n = adv.shape[1]
    out, tn = torch.empty_like(d4), torch.empty_like(d4)
    cp = torch.empty_like(adv)
    for v in range(4):
        c_prev = torch.zeros_like(adv[:, 0])
        d_prev = torch.zeros_like(adv[:, 0])
        for p in range(n):
            r = torch.reciprocal(b[:, p] - a[:, p] * c_prev)
            c_prev = c[:, p] * r
            d_prev = (d4[v, :, p] - d_prev * a[:, p]) * r
            cp[:, p] = c_prev
            out[v, :, p] = d_prev
        x = torch.zeros_like(c_prev)
        for p in range(n - 1, -1, -1):
            x = out[v, :, p] - cp[:, p] * x
            tn[v, :, p] = x
    return out, tn


def thomas_shared(adv, pk, d4):
    """x of ``thomas`` with c' and 1/denom built once and the 4 d-chains
    stepped together (comps / compi)."""
    a, b, c = _abc(adv, pk)
    n = adv.shape[1]
    cp, rs = torch.empty_like(adv), torch.empty_like(adv)
    c_prev = torch.zeros_like(adv[:, 0])
    for p in range(n):
        r = torch.reciprocal(b[:, p] - a[:, p] * c_prev)
        c_prev = c[:, p] * r
        cp[:, p] = c_prev
        rs[:, p] = r
    x4 = torch.empty_like(d4)
    d_prev = torch.zeros_like(d4[:, :, 0])
    for p in range(n):
        d_prev = (d4[:, :, p] - d_prev * a[:, p]) * rs[:, p]
        x4[:, :, p] = d_prev
    x = torch.zeros_like(d_prev)
    for p in range(n - 1, -1, -1):
        x = x4[:, :, p] - cp[:, p] * x
        x4[:, :, p] = x
    return x4


def pcr(adv, pk, d4):
    """x of the same systems by parallel cyclic reduction over
    ceil(log2 n) levels (the script's compute_pcr): rows shifted past either
    end read (a, b, c, d) = (0, 1, 0, 0)."""
    a, b, c = _abc(adv, pk)
    n = adv.shape[1]

    def shift(x, k, fill):           # result[:, i] = x[:, i + k]
        out = torch.full_like(x, fill)
        if k > 0:
            out[:, :n - k] = x[:, k:]
        else:
            out[:, -k:] = x[:, :n + k]
        return out

    ds = list(d4)
    s = 1
    while s < n:
        am, bm, cm = shift(a, -s, 0.0), shift(b, -s, 1.0), shift(c, -s, 0.0)
        ap, bp, cq = shift(a, s, 0.0), shift(b, s, 1.0), shift(c, s, 0.0)
        alpha = -a * torch.reciprocal(bm)
        gamma = -c * torch.reciprocal(bp)
        b = b + alpha * cm + gamma * ap
        ds = [dq + alpha * shift(dq, -s, 0.0) + gamma * shift(dq, s, 0.0)
              for dq in ds]
        a = alpha * am
        c = gamma * cq
        s *= 2
    rb = torch.reciprocal(b)
    return torch.stack([dq * rb for dq in ds])


def tile(temp4, rhs4, forc):
    """(adv, pk, d4) of the on-chip tile: lines (0, p, k < 32)."""
    return temp4[1, :1, :, :TILE], forc[:1, :, :TILE], rhs4[:, :1, :, :TILE]


def publish(x4, n: int) -> torch.Tensor:
    """pub (4, n*n) from the tile's x (4, 1, n, 32): thread g's value is x at
    tile line g % 32, row (g / 32) % n."""
    g = torch.arange(n * n, device=x4.device)
    return x4[:, 0, (g // TILE) % n, g % TILE]


def probe_ref(temp4, rhs4, forc, mode: str = "full"):
    """Plain PyTorch version of ``probe``."""
    temp4, rhs4, forc = (common.as_f32(x) for x in (temp4, rhs4, forc))
    n = _check(temp4, rhs4, forc)
    if mode == "dma":
        return rhs4.clone(), temp4.clone()
    if mode == "full":
        return thomas(temp4[1], forc, rhs4)
    adv, pk, d4 = tile(temp4, rhs4, forc)
    if mode in ("comp", "comp2"):
        return publish(thomas(adv, pk, d4)[1], n)
    if mode in ("comps", "compi"):
        return publish(thomas_shared(adv, pk, d4), n)
    if mode == "pcr":
        return publish(pcr(adv, pk, d4), n)
    raise ValueError(f"unknown mode {mode!r}")


def inputs(n: int, gen: torch.Generator, dev: torch.device):
    """temp4 in [-1, 1) (adv = temp4[1]), rhs4 in [-1, 1), forc in [0, 1):
    every row diagonally dominant (|a| + |c| = 2 < b)."""
    return (common.uniform((4, n, n, n), -1.0, 1.0, gen, dev),
            common.uniform((4, n, n, n), -1.0, 1.0, gen, dev),
            common.uniform((n, n, n), 0.0, 1.0, gen, dev))


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(
        prog="python -m cmcfs_tpu_torch.probes.kernel_probe",
        description="copy floor, compute floor and real solve of one "
                    "4-variable direction")
    ap.add_argument("--n", type=int, default=256)
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--modes", default="dma,comp,comp2,comps,compi,pcr,full")
    common.add_common_args(ap)
    return ap.parse_args(argv)


def run(args) -> list[common.Row]:
    dev, gen = common.device_and_generator(args)
    n = args.n
    temp4, rhs4, forc = inputs(n, gen, dev)
    cells = n ** 3
    rows = []
    for mode in args.modes.split(","):
        if mode not in MODES:
            raise ValueError(f"unknown mode {mode!r}")
        library, flops, rel_tol = None, 0, 0.0
        if mode == "dma":
            # temp4, rhs4, forc read; out, tn written: 17 fields
            nbytes = 17 * 4 * cells
            library = lambda: torch.stack((rhs4, temp4))    # noqa: E731
        elif mode == "full":
            # adv, pk, rhs4 read; out, tn written: 14 fields
            nbytes, flops = 14 * 4 * cells, FLOPS["full"] * cells
        else:
            # the tile's adv, pk, rhs4 read once; pub written
            nbytes = 4 * (6 * n * TILE + 4 * n * n)
            levels = (n - 1).bit_length() if mode == "pcr" else 1
            flops = FLOPS[mode] * cells * levels
            rel_tol = 1e-5 if mode == "pcr" else 0.0
        plain_mode = mode if mode in ("dma", "full") else "comp"
        row = common.measure(
            mode, lambda: probe(temp4, rhs4, forc, mode),
            lambda: probe_ref(temp4, rhs4, forc, plain_mode), args.reps,
            dev, nbytes, rel_tol, library=library, flops=flops)
        row.note = (f"{nbytes / row.ms / 1e6:7.0f} GB/s over "
                    f"{nbytes / 1e9:.3f} GB" if mode in ("dma", "full") else
                    f"{flops / row.ms / 1e9:7.3f} TFLOP/s")
        rows.append(row)
    return rows


def main(argv=None) -> int:
    args = parse_args(argv)
    rows = run(args)
    common.print_table(f"kernel_probe: n={args.n}", rows,
                       torch.device(args.device))
    return 0 if all(r.ok for r in rows) else 1


if __name__ == "__main__":
    sys.exit(main())
