"""The stream sweep: one local ADI iteration with a caller-built forcing.

Port of ``cmcfs_tpu/ops/pallas_sweep_stream.py::fused_sweep_stream``, in
its 3D form (``stream_sweep``, 4 variables) and its 2D ``merge2d`` form
(``stream_sweep_2d``, below).  The 3D form is one iteration of the pair sweep's arithmetic (``ops/pair_sweep.py``)
with one difference: the T equation's forcing ``t_phi * diss_axis(temp)``
is computed by the caller with ``ops/stencil`` (adi3d.py:402-409) instead
of in the kernel.  Derivatives multiply by 1/(2h), Dirichlet values come
from ``temp``, and the update is

    out = where(cls != 0, x, out_prev)
    tn  = where(INTERIOR, (temp + out)/2, temp)

with no global-merge fold.  ``scal`` = [v_vis/h^2, t_vis/h^2, 3/dt,
1/(2h), v_T] in float32.

2D (adi2d.py:180-217, pallas_sweep_stream.py:287-294): fields (3, nx, ny)
(u, v, T), masks (nx, ny), ``cls`` the line classes of the sweep axis and
``bct`` both BC masks; ``scal`` = [v_vis/h^2, t_vis/h^2, 1/dt, 1/(2h),
v_T]; the velocity ``axis`` advects and takes - v_T dT/dh; the FREE rows
are the 2D forms; the update is the copy-then-merge on INTERIOR cells
(the caller guarantees INTERIOR == NODE_IN, ``models/adi2d.stream_ok_2d``):

    out = where(INTERIOR, x, out_prev)
    tn  = where(INTERIOR, x if first else (temp + x)/2, temp)

Both entry points dispatch on the tensors' device: CUDA tensors launch
the stream entry point of ``kernels/csrc/pair_sweep.cu`` (it shares the
pair sweep's per-iteration device code) or raise; CPU tensors run the
plain PyTorch version (``stream_sweep_ref``, ``stream_sweep_2d_ref``).

bf16 payloads (pallas_sweep_stream.py:28, :93-110, :447-452): with
``rhs`` and ``out_prev`` in bfloat16, both are read upcast, the iteration
runs in float32 and out and tn come back rounded to bfloat16; ``temp``
and the forcing stay float32.  On the card it is the bf16 entry
(``stream_sweep_bf16.cu``), counted in ``bf16_launches``.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.types import BCtype
from ..kernels.build import LaunchCounter
from .masks import BC0, BC1, INTERIOR
from .pair_sweep import (_dd, check_inputs, iteration_ref, launch_iteration,
                         new_scratch)
from .sweep_common import build_abc
from .tridiag_rows import tridiag_rows_ref

_F = np.float32

launches = LaunchCounter()
bf16_launches = LaunchCounter()   # the bf16 payloads, 3D and 2D


def stream_sweep(temp4, cls, bcv, bct, rhs4, out_prev4, forcing, scal,
                 axis: int, exact: bool):
    """One local iteration of direction ``axis``; returns (out4, tn4)."""
    s = check_inputs(temp4, cls, bcv, bct, rhs4, out_prev4, scal, axis,
                     nscal=5)
    _check_forcing(forcing, temp4, cls)
    if temp4.device.type == "cpu":
        return stream_sweep_ref(temp4, cls, bcv, bct, rhs4, out_prev4,
                                forcing, s, axis, exact)
    if temp4.device.type != "cuda":
        raise RuntimeError(f"stream_sweep has no kernel for {temp4.device}")
    out = launch_iteration(temp4, cls, bcv, bct, rhs4, out_prev4, forcing,
                           new_scratch(4, cls, axis), s, axis, exact, False,
                           out_dtype=rhs4.dtype)
    _counter(rhs4).count += 1
    return out


def _counter(rhs):
    return bf16_launches if rhs.dtype == torch.bfloat16 else launches


def _check_forcing(forcing, temp, cls):
    if (forcing.device != temp.device or forcing.dtype != torch.float32
            or tuple(forcing.shape) != tuple(cls.shape)
            or not forcing.is_contiguous()):
        raise ValueError(f"forcing must be a contiguous float32 "
                         f"{tuple(cls.shape)} tensor on {temp.device}")


def stream_sweep_ref(temp4, cls, bcv, bct, rhs4, out_prev4, forcing, scal,
                     axis: int, exact: bool):
    """Plain PyTorch stream sweep on any device; returns (out4, tn4) in
    the payloads' dtype (bf16: upcast in, float32 iteration, rounded
    out)."""
    s = np.asarray(scal, dtype=np.float32)
    out, tn = iteration_ref(temp4, cls, bcv, bct, rhs4.float(),
                            out_prev4.float(), s, axis, exact, False,
                            forcing=forcing)
    return out.to(rhs4.dtype), tn.to(rhs4.dtype)


def stream_sweep_2d(temp3, cls, bct, rhs3, out_prev3, forcing, scal,
                    axis: int, exact: bool, first: bool):
    """One 2D local iteration of direction ``axis``; returns (out3, tn3)."""
    s = check_inputs(temp3, cls, bct, bct, rhs3, out_prev3, scal, axis,
                     nscal=5, ndim=2)
    _check_forcing(forcing, temp3, cls)
    if temp3.device.type == "cpu":
        return stream_sweep_2d_ref(temp3, cls, bct, rhs3, out_prev3, forcing,
                                   s, axis, exact, first)
    if temp3.device.type != "cuda":
        raise RuntimeError(f"stream_sweep has no kernel for {temp3.device}")
    # the 3D kernel on the view (1, nx, ny): X is its axis 1, Y its axis 2
    out3, tn3 = launch_iteration(
        temp3[:, None], cls[None], bct[None], bct[None], rhs3[:, None],
        out_prev3[:, None], forcing[None], new_scratch(3, cls, axis), s,
        axis + 1, exact, False, axis_var=axis, first=first,
        out_dtype=rhs3.dtype)
    _counter(rhs3).count += 1
    return out3.squeeze(1), tn3.squeeze(1)


def stream_sweep_2d_ref(temp3, cls, bct, rhs3, out_prev3, forcing, scal,
                        axis: int, exact: bool, first: bool):
    """Plain PyTorch 2D stream sweep on any device; returns (out3, tn3)
    in the payloads' dtype (bf16: upcast in, float32 iteration, rounded
    out)."""
    pay = rhs3.dtype
    rhs3, out_prev3 = rhs3.float(), out_prev3.float()
    v_vis_h2, t_vis_h2, inv_dt, inv2h, v_T = np.asarray(scal, dtype=_F)
    adv2h = temp3[axis] * inv2h
    free = bct == BCtype.FREE
    rows_v = build_abc(cls, free, adv2h, v_vis_h2,
                       inv_dt + _F(2.0) * v_vis_h2, bc2d=True)
    rows_t = build_abc(cls, free, adv2h, t_vis_h2,
                       inv_dt + _F(2.0) * t_vis_h2, bc2d=True)
    a, b, c = (torch.stack((rv, rv, rt)) for rv, rt in zip(rows_v, rows_t))
    d_int = rhs3 * inv_dt
    d_int[axis] = d_int[axis] - v_T * _dd(temp3[2], inv2h, axis)
    d_int[2] = d_int[2] + forcing
    interior = cls == INTERIOR
    d = torch.where(interior, d_int,
                    torch.where((cls == BC0) | (cls == BC1),
                                torch.where(free, 0.0, temp3), 0.0))
    x = tridiag_rows_ref(a, b, c, d, axis=axis + 1, exact=exact)
    out = torch.where(interior, x, out_prev3)
    tn = torch.where(interior, x if first else (temp3 + x) * 0.5, temp3)
    return out.to(pay), tn.to(pay)
