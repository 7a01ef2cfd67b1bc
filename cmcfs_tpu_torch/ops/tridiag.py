"""Batched tridiagonal solve: plain Thomas in the reference operation order.

Port of ``cmcfs_tpu/ops/tridiag.py::_solve_leading_axis_scan``
(src/Common/Algorithms.h:21-38).  Solves a*x[i-1] + b*x[i] + c*x[i+1] = d
along one axis for a full batch; the first row's ``a`` is ignored and the
last row's ``c`` is taken as 0.  ``exact=True`` divides twice per row;
``exact=False`` multiplies by one reciprocal per row (rows 1..n-1; row 0
divides in both modes, as the reference does, unless ``recip_row0``: the
fused line-sweep kernels' order, pallas_sweep_dma._solve_var, where row 0
is the first step of the same recurrence).  The row loop runs in Python
over whole batch slices, so each step is one vector operation.
"""
from __future__ import annotations

import torch


def _solve_leading_axis(a, b, c, d, exact: bool,
                        recip_row0: bool = False) -> torch.Tensor:
    """Thomas along axis 0; batch = trailing axes."""
    n = d.shape[0]
    cp = torch.empty_like(d)
    dp = torch.empty_like(d)
    c0 = c[0] if n > 1 else torch.zeros_like(c[0])    # c[-1] = 0
    if recip_row0 and not exact:
        r = torch.reciprocal(b[0])
        cp[0] = c0 * r
        dp[0] = d[0] * r
    else:
        cp[0] = c0 / b[0]
        dp[0] = d[0] / b[0]
    for i in range(1, n):
        ci = c[i] if i < n - 1 else torch.zeros_like(c[i])
        denom = b[i] - a[i] * cp[i - 1]
        num = d[i] - dp[i - 1] * a[i]
        if exact:
            cp[i] = ci / denom
            dp[i] = num / denom
        else:
            r = torch.reciprocal(denom)
            cp[i] = ci * r
            dp[i] = num * r
    x = torch.empty_like(d)
    x[n - 1] = dp[n - 1]
    for i in range(n - 2, -1, -1):
        x[i] = dp[i] - cp[i] * x[i + 1]
    return x


def tridiag_solve(a, b, c, d, axis: int = 0, exact: bool = True,
                  recip_row0: bool = False) -> torch.Tensor:
    """Solve the tridiagonal systems along ``axis`` (all inputs one shape)."""
    if axis != 0:
        a, b, c, d = (torch.movedim(t, axis, 0) for t in (a, b, c, d))
        return torch.movedim(
            _solve_leading_axis(a, b, c, d, exact, recip_row0), 0, axis)
    return _solve_leading_axis(a, b, c, d, exact, recip_row0)
