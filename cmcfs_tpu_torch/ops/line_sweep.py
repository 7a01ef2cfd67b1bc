"""The line sweep: row build + Thomas on a caller-built RHS, 4 variables.

Port of three TPU kernels that compute one function and differ only in
how they tile VMEM: ``cmcfs_tpu/ops/pallas_sweep_dma.py::fused_sweep_dma``
(lines up to 288 cells), ``pallas_sweep_long.py::fused_sweep_long``
(longer lines, chunked) and ``pallas_sweep.py::fused_sweep`` (the
BlockSpec form).  The CUDA kernel keeps (c', d') in global memory, so it
has no length cap and one kernel serves all three.

Inputs in the JAX package's layout: ``adv`` (nx, ny, nz) float32, the
sweep axis's temp velocity; ``pk`` (nx, ny, nz) int8, the packed masks of
one line class (``sweep_common.pack_masks``); ``d4`` (4, nx, ny, nz)
float32, the right-hand sides with the boundary and identity values
folded in; ``scal`` = [v_vis/h^2, t_vis/h^2, 3/dt, 1/(2h)] in float32.

Per variable v (T is v = 3: t_vis and bc_temp, else v_vis and bc_vel):
  rows   (a, b, c) = build_abc(cls, bc == FREE, adv/(2h), vis, 3/dt + 2 vis)
  solve  Thomas in pallas_sweep_dma._solve_var's order (:48-74): a = 0 on
         row 0, c = 0 on row n-1, denom = b - a c'; ``exact`` divides
         twice, else multiplies by one reciprocal (row 0 included);
         x = d' - c' x_next.

``line_sweep`` dispatches on the tensors' device: CUDA tensors launch
``kernels/csrc/line_sweep.cu`` or raise; CPU tensors run
``line_sweep_ref``, the plain PyTorch version.
"""
from __future__ import annotations

import numpy as np
import torch

from .pair_sweep import LaunchCounter
from .sweep_common import build_abc, decode_pk
from .tridiag import tridiag_solve

_F = np.float32

launches = LaunchCounter()


def _check(adv, pk, d4, scal, axis):
    if axis not in (0, 1, 2):
        raise ValueError(f"axis must be 0, 1 or 2, got {axis}")
    if adv.dim() != 3:
        raise ValueError(f"adv must be (nx, ny, nz), got {tuple(adv.shape)}")
    shape3 = tuple(adv.shape)
    for name, t, dtype, shape in (
            ("adv", adv, torch.float32, shape3),
            ("pk", pk, torch.int8, shape3),
            ("d4", d4, torch.float32, (4,) + shape3)):
        if t.device != adv.device:
            raise ValueError(f"{name} is on {t.device}, adv on {adv.device}")
        if t.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {shape}, got {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    s = np.asarray(scal, dtype=np.float32)
    if s.shape != (4,):
        raise ValueError(f"scal must hold 4 values, got shape {s.shape}")
    return s


def line_sweep(adv, pk, d4, scal, axis: int, exact: bool) -> torch.Tensor:
    """Solve the four systems of direction ``axis``; returns x4."""
    s = _check(adv, pk, d4, scal, axis)
    if adv.device.type == "cpu":
        return line_sweep_ref(adv, pk, d4, s, axis, exact)
    if adv.device.type != "cuda":
        raise RuntimeError(f"line_sweep has no kernel for {adv.device}")
    from ..kernels.build import load_library
    fn = load_library().lib.cmcfs_line_sweep
    n = adv.shape[axis]
    x4 = torch.empty_like(d4)
    # c' and d' of every row, per variable, laid out [row][line]
    scratch = torch.empty((2, 4, n, adv.numel() // n), dtype=torch.float32,
                          device=adv.device)
    nx, ny, nz = adv.shape
    with torch.cuda.device(adv.device):
        stream = torch.cuda.current_stream(adv.device).cuda_stream
        err = fn(adv.data_ptr(), pk.data_ptr(), d4.data_ptr(), x4.data_ptr(),
                 scratch.data_ptr(), nx, ny, nz, axis, int(exact),
                 *(float(x) for x in s), stream)
    if err != 0:
        raise RuntimeError(f"line_sweep kernel launch failed: CUDA error "
                           f"{err} (shape {tuple(adv.shape)}, axis {axis})")
    launches.count += 1
    return x4


def line_sweep_ref(adv, pk, d4, scal, axis: int, exact: bool):
    """Plain PyTorch line sweep on any device; returns x4."""
    v_vis_h2, t_vis_h2, inv3dt, inv2h = np.asarray(scal, dtype=np.float32)
    cls, bcv, bct = decode_pk(pk)
    adv_2h = adv * inv2h
    xs = []
    for v in range(4):
        vis = t_vis_h2 if v == 3 else v_vis_h2
        free = (bct if v == 3 else bcv) == 1
        a, b, c = build_abc(cls, free, adv_2h, vis, inv3dt + _F(2.0) * vis)
        xs.append(tridiag_solve(a, b, c, d4[v], axis=axis, exact=exact,
                                recip_row0=True))
    return torch.stack(xs)
