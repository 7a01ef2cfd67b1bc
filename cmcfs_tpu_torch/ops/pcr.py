"""Parallel cyclic reduction of batched tridiagonal systems, plain PyTorch.

Port of the two places where cmcfs_tpu reduces cyclically:
``ops/tridiag._solve_leading_axis_pcr`` (tridiag.py:66-103), the row
solve of backend ``pcr``, and ``_pcr_chain`` (pallas_sweep_nl.py:557-589),
the pair kernel's pcr mode, where one (a, b, c) chain carries several
right-hand sides.  cmcfs_tpu runs the former as XLA ops, not as a Pallas
kernel, so its port is this module in PyTorch ops on either device
(``ops/tridiag.tridiag_solve(backend="pcr")``).  The latter is a Pallas
kernel: ``kernels/csrc/pcr_sweep.cu`` (``ops/pcr_sweep.py``), whose plain
version solves with ``pcr_solve``.

Solves a*x[i-1] + b*x[i] + c*x[i+1] = d along one axis.  Row 0's a and row
n-1's c are zeroed first (Thomas ignores them, Algorithms.h:23); a
neighbour out of range is an identity row (a = c = 0, b = 1, d = 0), so
any n works.  Level s = 1, 2, 4, ... while s < n, each product rounded
before it is added, in this order:

    alpha = -(a / b[i-s])      exact; else -a * (1 / b[i-s])
    gamma = -(c / b[i+s])      exact; else -c * (1 / b[i+s])
    b'    = (b + alpha*c[i-s]) + gamma*a[i+s]
    d'    = (d + alpha*d[i-s]) + gamma*d[i+s]
    a'    = alpha*a[i-s],  c' = gamma*c[i+s]   (not after the last level)

then x = d / b (exact) or d * (1 / b).  Not bitwise against Thomas (another
elimination order; ulp-class on the diagonally dominant ADI rows).
"""
from __future__ import annotations

import torch


def shift(x: torch.Tensor, k: int, axis: int, fill: float) -> torch.Tensor:
    """result[i] = x[i + k] along ``axis``; rows out of range are ``fill``."""
    n = x.shape[axis]
    size = list(x.shape)
    size[axis] = min(abs(k), n)
    pad = torch.full(size, fill, dtype=x.dtype, device=x.device)
    if abs(k) >= n:
        return pad
    if k > 0:
        return torch.cat((x.narrow(axis, k, n - k), pad), dim=axis)
    return torch.cat((pad, x.narrow(axis, 0, n + k)), dim=axis)


def _cap(t: torch.Tensor, row: int, axis: int) -> torch.Tensor:
    """t with ``row`` (0 or -1) along ``axis`` set to 0."""
    t = t.clone()
    t.narrow(axis, row % t.shape[axis], 1).zero_()
    return t


def pcr_solve(a, b, c, d, axis: int = 0, exact: bool = True) -> torch.Tensor:
    """Solve the systems along ``axis`` of ``a``; ``d`` is a's shape or
    (k,) + a's shape (k right-hand sides on the same rows).  Returns x,
    shaped as d."""
    if d.dim() == a.dim() + 1:
        a, b, c = (t.unsqueeze(0) for t in (a, b, c))
        axis += 1
    n = a.shape[axis]
    a = _cap(a, 0, axis)
    c = _cap(c, -1, axis)
    s = 1
    while s < n:
        bm = shift(b, -s, axis, 1.0)
        bp = shift(b, s, axis, 1.0)
        if exact:
            alpha = -(a / bm)
            gamma = -(c / bp)
        else:
            alpha = -a * (1.0 / bm)
            gamma = -c * (1.0 / bp)
        b_new = b + alpha * shift(c, -s, axis, 0.0) \
            + gamma * shift(a, s, axis, 0.0)
        d = d + alpha * shift(d, -s, axis, 0.0) + gamma * shift(d, s, axis,
                                                                0.0)
        if 2 * s < n:
            a = alpha * shift(a, -s, axis, 0.0)
            c = gamma * shift(c, s, axis, 0.0)
        b = b_new
        s *= 2
    return d / b if exact else d * (1.0 / b)
