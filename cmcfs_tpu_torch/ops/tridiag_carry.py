"""The carry Thomas passes of the Z-blocked wavefront X sweep: the CUDA
kernels' wrappers and their plain PyTorch versions.

Port of ``cmcfs_tpu/parallel/pipeline.py``'s ``_local_fwd`` and
``_local_bwd`` (:26, :45), the recurrences each shard runs on its part of
the X lines, as ``kernels/csrc/tridiag_carry.cu``.  cmcfs_tpu runs them as
``lax.scan``; as eager PyTorch their row loop would launch several
kernels a row, so the card runs one kernel a pass.

Rows: a, b, c of one shape S = (n, ..., Z), contiguous, float32, the
systems along the leading axis (the shard's owned X planes); d holds k
right-hand sides on those rows, (k,) + S, each d[j] laid out as a (the
planes of a larger tensor may lie between them: the wrappers read
d.stride(0)); k = 1 or 3.  A call covers the lines of the Z columns
``z0 .. z0 + nz``, nz the width of its carry planes, in place: the block
is addressed by offset and stride, not copied, and the outputs c', d'
(``cp``, ``dp``, contiguous, shaped as a and as (k,) + S) and x are
written in those columns only.  Carry planes are contiguous, shaped
S[1:-1] + (nz,) (one c') and (k,) + that (one a system).

``carry_fwd``: from the carries (c'_in, d'_in), every row: denom = b -
a c'_prev, then c' = c / denom and d' = (d - d'_prev a) / denom
(``exact``) or both times one reciprocal 1 / denom on every row, row 0
included: cmcfs_tpu's reciprocal form, the ``recip_row0`` form of
``tridiag_rows``.  Row 0's a is kept (the carry takes the zero's place; a
line's first row has a = 0 by the row build), and ``last`` (the shard that
ends the lines) takes c = 0 on its last row.  Returns the last row's c'
and d', the carries of the next shard.
``carry_bwd``: from x_in, x = d' - c' x_next on every row (x_in = 0 past
the lines' end); returns row 0's x, the previous shard's carry.

The wrappers dispatch on the tensors' device: CUDA tensors launch the
kernel or raise, CPU tensors run the plain version, whose row loop runs
in Python over whole batch slices, the k systems side by side.
"""
from __future__ import annotations

import math

import torch

from ..kernels.build import LaunchCounter

launches = LaunchCounter()
KS = (1, 3)


def _contiguous_strides(shape) -> tuple:
    return tuple(math.prod(shape[i + 1:]) for i in range(len(shape)))


def _check(rows, systems, planes, nz, z0):
    """Shapes, types, devices and layouts of a call: ``planes`` the c'
    carry plane (or None) and the systems' carry planes; returns k."""
    shape = tuple(rows[0].shape)
    if len(shape) < 2:
        raise ValueError(f"rows must be (n, ..., Z), got {shape}")
    dev = rows[0].device
    k = systems[0].shape[0]
    if k not in KS:
        raise ValueError(f"k must be 1 or 3, got {k}")
    if not (nz >= 1 and 0 <= z0 and z0 + nz <= shape[-1]):
        raise ValueError(f"columns {z0}:{z0 + nz} outside Z = {shape[-1]}")
    inner = _contiguous_strides(shape)
    given = [p for p in planes if p is not None]
    for t in list(rows) + list(systems) + given:
        if t.device != dev:
            raise ValueError(f"tensors on {t.device} and {dev}")
        if t.dtype != torch.float32:
            raise TypeError(f"tensors must be torch.float32, got {t.dtype}")
    for t in rows:
        if tuple(t.shape) != shape or not t.is_contiguous():
            raise ValueError(f"rows must be contiguous {shape}, got "
                             f"{tuple(t.shape)}")
    for t in systems:
        if (tuple(t.shape) != (k,) + shape or t.stride()[1:] != inner
                or t.stride(0) < math.prod(shape)):
            raise ValueError(f"right-hand sides must be ({k},) + {shape}, "
                             f"each laid out as the rows")
    cshape = shape[1:-1] + (nz,)
    for t, want in zip(planes, (cshape, (k,) + cshape)):
        if t is not None and (tuple(t.shape) != want
                              or not t.is_contiguous()):
            raise ValueError(f"carry planes must be contiguous {want}, got "
                             f"{tuple(t.shape)}")
    return k


def _lines(shape, z0, nz):
    """The kernel's (n, n1, s1, n2, sp, off) of columns z0 .. z0 + nz."""
    return (shape[0], math.prod(shape[1:-1]), shape[-1], nz,
            math.prod(shape[1:]), z0)


def _fn(name, device):
    if device.type != "cuda":
        raise RuntimeError(f"tridiag_carry has no kernel for {device}")
    from ..kernels.build import load_library
    return getattr(load_library().lib, name)


def carry_fwd(a, b, c, d, cin_c, cin_d, cp, dp, z0: int, last: bool,
              exact: bool = True):
    """Forward elimination of the lines in columns z0 .. z0 + nz; writes
    c' into ``cp`` and d' into ``dp`` there.  Returns (out_c, out_d)."""
    nz = cin_c.shape[-1]
    k = _check((a, b, c, cp), (d, dp), (cin_c, cin_d), nz, z0)
    if d.device.type == "cpu":
        return carry_fwd_ref(a, b, c, d, cin_c, cin_d, cp, dp, z0, last,
                             exact)
    fn = _fn("cmcfs_tridiag_carry_fwd", d.device)
    out_c, out_d = torch.empty_like(cin_c), torch.empty_like(cin_d)
    with torch.cuda.device(d.device):
        stream = torch.cuda.current_stream(d.device).cuda_stream
        err = fn(a.data_ptr(), b.data_ptr(), c.data_ptr(), d.data_ptr(),
                 cin_c.data_ptr(), cin_d.data_ptr(), cp.data_ptr(),
                 dp.data_ptr(), out_c.data_ptr(), out_d.data_ptr(),
                 *_lines(tuple(a.shape), z0, nz), d.stride(0), dp.stride(0),
                 k, int(last), int(exact), stream)
    if err != 0:
        raise RuntimeError(f"tridiag_carry forward launch failed: CUDA error "
                           f"{err} (rows {tuple(a.shape)}, k {k}, columns "
                           f"{z0}:{z0 + nz})")
    launches.count += 1
    return out_c, out_d


def carry_bwd(cp, dp, xin, x, z0: int):
    """Back substitution of the lines in columns z0 .. z0 + nz; writes x
    there.  Returns out_x."""
    nz = xin.shape[-1]
    k = _check((cp,), (dp, x), (None, xin), nz, z0)
    if dp.device.type == "cpu":
        return carry_bwd_ref(cp, dp, xin, x, z0)
    fn = _fn("cmcfs_tridiag_carry_bwd", dp.device)
    out_x = torch.empty_like(xin)
    with torch.cuda.device(dp.device):
        stream = torch.cuda.current_stream(dp.device).cuda_stream
        err = fn(cp.data_ptr(), dp.data_ptr(), xin.data_ptr(), x.data_ptr(),
                 out_x.data_ptr(), *_lines(tuple(cp.shape), z0, nz),
                 dp.stride(0), k, stream)
    if err != 0:
        raise RuntimeError(f"tridiag_carry backward launch failed: CUDA "
                           f"error {err} (rows {tuple(cp.shape)}, k {k}, "
                           f"columns {z0}:{z0 + nz})")
    launches.count += 1
    return out_x


def carry_fwd_ref(a, b, c, d, cin_c, cin_d, cp, dp, z0: int, last: bool,
                  exact: bool = True):
    """Plain PyTorch ``carry_fwd``, on any device."""
    cols = slice(z0, z0 + cin_c.shape[-1])
    a, b, c, cpv = (t[..., cols] for t in (a, b, c, cp))
    d, dpv = d[..., cols], dp[..., cols]
    cq, dq = cin_c, cin_d
    n = a.shape[0]
    for p in range(n):
        ci = torch.zeros_like(c[p]) if last and p == n - 1 else c[p]
        den = b[p] - a[p] * cq
        num = d[:, p] - dq * a[p]
        if exact:
            cq, dq = ci / den, num / den
        else:
            r = torch.reciprocal(den)
            cq, dq = ci * r, num * r
        cpv[p] = cq
        dpv[:, p] = dq
    return cq, dq


def carry_bwd_ref(cp, dp, xin, x, z0: int):
    """Plain PyTorch ``carry_bwd``, on any device."""
    cols = slice(z0, z0 + xin.shape[-1])
    cp, dp, xv = cp[..., cols], dp[..., cols], x[..., cols]
    xq = xin
    for p in range(cp.shape[0] - 1, -1, -1):
        xq = dp[:, p] - cp[p] * xq
        xv[:, p] = xq
    return xq
