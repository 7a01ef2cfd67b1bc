"""The stream sweep: one local ADI iteration with a caller-built forcing.

Port of ``cmcfs_tpu/ops/pallas_sweep_stream.py::fused_sweep_stream``, 3D
form (4 variables; the 2D ``bc2d``/``merge2d`` modes wait for ROADMAP A9).
It is one iteration of the pair sweep's arithmetic (``ops/pair_sweep.py``)
with one difference: the T equation's forcing ``t_phi * diss_axis(temp)``
is computed by the caller with ``ops/stencil`` (adi3d.py:402-409) instead
of in the kernel.  Derivatives multiply by 1/(2h), Dirichlet values come
from ``temp``, and the update is

    out = where(cls != 0, x, out_prev)
    tn  = where(INTERIOR, (temp + out)/2, temp)

with no global-merge fold.  ``scal`` = [v_vis/h^2, t_vis/h^2, 3/dt,
1/(2h), v_T] in float32.

``stream_sweep`` dispatches on the tensors' device: CUDA tensors launch
the stream entry point of ``kernels/csrc/pair_sweep.cu`` (it shares the
pair sweep's per-iteration device code) or raise; CPU tensors run
``stream_sweep_ref``, the plain PyTorch version.
"""
from __future__ import annotations

import numpy as np
import torch

from .pair_sweep import (LaunchCounter, check_inputs, iteration_ref,
                         launch_iteration)

launches = LaunchCounter()


def stream_sweep(temp4, cls, bcv, bct, rhs4, out_prev4, forcing, scal,
                 axis: int, exact: bool):
    """One local iteration of direction ``axis``; returns (out4, tn4)."""
    s = check_inputs(temp4, cls, bcv, bct, rhs4, out_prev4, scal, axis,
                     nscal=5)
    if (forcing.device != temp4.device or forcing.dtype != torch.float32
            or tuple(forcing.shape) != tuple(cls.shape)
            or not forcing.is_contiguous()):
        raise ValueError("forcing must be a contiguous float32 (nx, ny, nz) "
                         "tensor on temp4's device")
    if temp4.device.type == "cpu":
        return stream_sweep_ref(temp4, cls, bcv, bct, rhs4, out_prev4,
                                forcing, s, axis, exact)
    if temp4.device.type != "cuda":
        raise RuntimeError(f"stream_sweep has no kernel for {temp4.device}")
    n = cls.shape[axis]
    scratch = torch.empty((3, n, cls.numel() // n), dtype=torch.float32,
                          device=temp4.device)
    out = launch_iteration(temp4, cls, bcv, bct, rhs4, out_prev4, forcing,
                           scratch, s, axis, exact, False)
    launches.count += 1
    return out


def stream_sweep_ref(temp4, cls, bcv, bct, rhs4, out_prev4, forcing, scal,
                     axis: int, exact: bool):
    """Plain PyTorch stream sweep on any device; returns (out4, tn4)."""
    s = np.asarray(scal, dtype=np.float32)
    return iteration_ref(temp4, cls, bcv, bct, rhs4, out_prev4, s, axis,
                         exact, False, forcing=forcing)
