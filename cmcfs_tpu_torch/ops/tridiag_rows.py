"""Batched Thomas solve on materialized rows: the CUDA kernel's wrapper
and its plain PyTorch version.

Port of ``cmcfs_tpu/ops/pallas_tridiag.py::tridiag_pallas``, the TPU's
two-pass Thomas kernel, as ``kernels/csrc/tridiag_rows.cu`` (on the shared
walk of ``walk.cuh``): one thread per line does forward elimination and
back substitution in one launch.  It is the solve of backends ``scan`` and
``pallas`` (``ops/tridiag``), whose only difference is row 0 of the
reciprocal form (``recip_row0``).

Solves a*x[i-1] + b*x[i] + c*x[i+1] = d along one axis for a full batch;
the first row's ``a`` is ignored and the last row's ``c`` is taken as 0.
``exact=True`` divides twice per row; ``exact=False`` multiplies by one
reciprocal per row (rows 1..n-1; row 0 divides in both modes, as the
reference does, unless ``recip_row0``: the order of
``pallas_tridiag.tridiag_pallas`` and of the fused line-sweep kernels,
pallas_sweep_dma._solve_var, where row 0 is the first step of the same
recurrence).

``a``, ``b``, ``c``: float32 tensors of one shape, contiguous; the systems
run along ``axis`` (the leading one by default, any trailing batch).
``d``: that shape, or ``(k,) + shape`` for k right-hand sides on the same
rows (the k-form: the kernel reads the rows once and computes c' once; the
3D row path solves u, v and w so); x has d's shape.  The kernel addresses
the rows of a middle axis by stride, so no transpose is made.
``tridiag_rows`` dispatches on the tensors' device: CUDA tensors launch
the kernel or raise; CPU tensors run ``tridiag_rows_ref``, the plain
PyTorch version, whose row loop runs in Python over whole batch slices
(the k-form one system at a time).  The other kernels' plain versions
solve with it too.
"""
from __future__ import annotations

import math

import torch

from ..kernels.build import LaunchCounter

launches = LaunchCounter()
# kernels/csrc/walk.cuh kLinePad: a scratch row's runs of n2 lines are
# padded to a multiple of it
LINE_PAD = 64
# right-hand sides a launch of the kernel takes (larger k run as launches
# of 3, then of 1)
KERNEL_K = (3, 1)


def walk_scratch(planes: int, n: int, n1: int, n2: int, device):
    """The scratch of a walk.cuh launch over n1 x n2 lines of n rows:
    (planes, n, columns), each run of n2 lines padded to LINE_PAD."""
    cols = n1 * (-(-n2 // LINE_PAD) * LINE_PAD)
    return torch.empty((planes, n, cols), dtype=torch.float32, device=device)


def _check(a, b, c, d, axis):
    shape = tuple(a.shape)
    if not 0 <= axis < a.dim():
        raise ValueError(f"axis {axis} out of range for {a.dim()} dims")
    if tuple(d.shape) not in (shape, tuple(d.shape[:1]) + shape):
        raise ValueError(f"d must be {shape} or (k,) + {shape}, got "
                         f"{tuple(d.shape)}")
    for name, t in (("a", a), ("b", b), ("c", c), ("d", d)):
        if t.device != d.device:
            raise ValueError(f"{name} is on {t.device}, d on {d.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be torch.float32, got {t.dtype}")
        if name != "d" and tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {shape}, got "
                             f"{tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def tridiag_rows(a, b, c, d, axis: int = 0, exact: bool = True,
                 recip_row0: bool = False) -> torch.Tensor:
    """Solve the systems along ``axis`` of a (one per right-hand side of
    d); returns x, shaped as d."""
    _check(a, b, c, d, axis)
    if d.device.type == "cpu":
        return tridiag_rows_ref(a, b, c, d, axis, exact, recip_row0)
    if d.device.type != "cuda":
        raise RuntimeError(f"tridiag_rows has no kernel for {d.device}")
    from ..kernels.build import load_library
    fn = load_library().lib.cmcfs_tridiag_rows
    shape = tuple(a.shape)
    pre, n, post = (math.prod(shape[:axis]), shape[axis],
                    math.prod(shape[axis + 1:]))
    dk = d.reshape((-1,) + shape)
    k = dk.shape[0]
    x = torch.empty_like(dk)
    # c' and the d' of each right-hand side, laid out [plane][row][line];
    # lines along the contiguous axis (post == 1) are its pre lines
    scratch = walk_scratch(1 + min(k, KERNEL_K[0]), n,
                           *((1, pre) if post == 1 else (pre, post)),
                           d.device)
    with torch.cuda.device(d.device):
        stream = torch.cuda.current_stream(d.device).cuda_stream
        i = 0
        while i < k:
            kk = next(m for m in KERNEL_K if m <= k - i)
            err = fn(a.data_ptr(), b.data_ptr(), c.data_ptr(),
                     dk[i].data_ptr(), x[i].data_ptr(), scratch.data_ptr(),
                     pre, n, post, kk, int(exact), int(recip_row0), stream)
            if err != 0:
                raise RuntimeError(
                    f"tridiag_rows kernel launch failed: CUDA error {err} "
                    f"(shape {shape}, k {kk}, axis {axis})")
            launches.count += 1
            i += kk
    return x.reshape(d.shape)


def _solve_leading_axis(a, b, c, d, exact: bool,
                        recip_row0: bool) -> torch.Tensor:
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


def tridiag_rows_ref(a, b, c, d, axis: int = 0, exact: bool = True,
                     recip_row0: bool = False) -> torch.Tensor:
    """Plain PyTorch solve along ``axis`` on any device; d is a's shape or
    (k,) + a's shape (k systems on the same rows, solved one by one)."""
    if d.dim() == a.dim() + 1:
        return torch.stack([tridiag_rows_ref(a, b, c, dv, axis, exact,
                                             recip_row0) for dv in d])
    if axis != 0:
        a, b, c, d = (torch.movedim(t, axis, 0) for t in (a, b, c, d))
        return torch.movedim(
            _solve_leading_axis(a, b, c, d, exact, recip_row0), 0, axis)
    return _solve_leading_axis(a, b, c, d, exact, recip_row0)
