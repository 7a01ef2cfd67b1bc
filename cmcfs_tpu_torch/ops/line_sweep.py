"""The line sweep: row build + Thomas on a caller-built RHS, all variables.

Port of three TPU kernels that compute one function and differ only in
how they tile VMEM: ``cmcfs_tpu/ops/pallas_sweep_dma.py::fused_sweep_dma``
(lines up to 288 cells), ``pallas_sweep_long.py::fused_sweep_long``
(longer lines, chunked) and ``pallas_sweep.py::fused_sweep`` (the
BlockSpec form).  The CUDA kernel (``kernels/csrc/line_sweep.cu`` on the
shared walk of ``walk.cuh``) keeps (c', d') in a global scratch, so it has
no length cap and one kernel serves all three, in their 3D form and their
2D one (``t_var=2, bc2d=True``); its tiles are constants of the source.

3D (``line_sweep``), in the JAX package's layout: ``adv`` (nx, ny, nz)
float32, the sweep axis's temp velocity; ``pk`` (nx, ny, nz) int8, the
packed masks of one line class (``sweep_common.pack_masks``); ``d4``
(4, nx, ny, nz) float32, the right-hand sides with the boundary and
identity values folded in; ``scal`` = [v_vis/h^2, t_vis/h^2, 3/dt, 1/(2h)]
in float32.  Variable T = 3 takes t_vis and the bc_temp bit.

2D (``line_sweep_2d``): ``adv`` and ``pk`` (nx, ny), ``d3`` (3, nx, ny)
for (u, v, T); ``pk`` packs bc_temp as both BC masks (adi2d.py:113-114),
``scal[2]`` is 1/dt, T = 2, and the FREE rows are the 2D forms.

Per variable v:
  rows   (a, b, c) = build_abc(cls, bc == FREE, adv/(2h), vis, 3/dt + 2 vis)
  solve  Thomas in pallas_sweep_dma._solve_var's order (:48-74): a = 0 on
         row 0, c = 0 on row n-1, denom = b - a c'; ``exact`` divides
         twice, else multiplies by one reciprocal (row 0 included);
         x = d' - c' x_next.

Both entry points dispatch on the tensors' device: CUDA tensors launch
``kernels/csrc/line_sweep.cu`` or raise; CPU tensors run the plain
PyTorch version (``line_sweep_ref``, ``line_sweep_2d_ref``).

bf16 payloads (pallas_sweep_dma.py:79-81, :263; pallas_sweep_long.py:
344-353): a bfloat16 ``d`` is read upcast, Thomas runs in float32 and x
comes back rounded to bfloat16; ``adv``, the masks and the (c', d')
carries stay float32.  On the card it is ``line_sweep_bf16.cu``'s entry,
counted in ``bf16_launches``.

The fallback iteration (``fallback_iteration``): one local iteration of a
dual-free fallback direction of the 3D ADI step, float32, in one launch of
the same kernel on the rows of ``line_sweep.cuh``'s FallbackRows: the
right-hand side of ``models/adi3d.fallback_rhs``, ``fold_d``'s folds, the
line sweep, UpdateSegment and the NODE_IN merge.  ``fallback_iteration_ref``
is that composition in plain PyTorch; the kernel equals it bit for bit.
Counted in ``fused_launches``.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.types import NodeType
from ..kernels.build import LaunchCounter
from . import stencil
from .masks import BC0, BC1, INTERIOR
from .sweep_common import build_abc, decode_pk
from .tridiag_rows import tridiag_rows_ref, walk_scratch

_F = np.float32

launches = LaunchCounter()
bf16_launches = LaunchCounter()   # bf16 d and x, 3D and 2D
fused_launches = LaunchCounter()  # fallback_iteration
_DISS = (stencil.diss_x_3d, stencil.diss_y_3d, stencil.diss_z_3d)
# the 3D Z tiles line_sweep.cu builds, by their rows (its kZR first)
Z_ROWS = (16, 8, 32)


def _check(adv, pk, d, scal, axis, nd):
    if adv.dim() != nd:
        raise ValueError(f"adv must have {nd} dims, got {tuple(adv.shape)}")
    if axis not in range(nd):
        raise ValueError(f"axis must be in 0..{nd - 1}, got {axis}")
    shape = tuple(adv.shape)
    pay = torch.bfloat16 if d.dtype == torch.bfloat16 else torch.float32
    for name, t, dtype, want in (
            ("adv", adv, torch.float32, shape),
            ("pk", pk, torch.int8, shape),
            ("d", d, pay, (nd + 1,) + shape)):
        if t.device != adv.device:
            raise ValueError(f"{name} is on {t.device}, adv on {adv.device}")
        if t.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
        if tuple(t.shape) != want:
            raise ValueError(f"{name} must be {want}, got {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    s = np.asarray(scal, dtype=np.float32)
    if s.shape != (4,):
        raise ValueError(f"scal must hold 4 values, got shape {s.shape}")
    return s


def line_sweep(adv, pk, d4, scal, axis: int, exact: bool) -> torch.Tensor:
    """Solve the four 3D systems of direction ``axis``; returns x4."""
    s = _check(adv, pk, d4, scal, axis, 3)
    if adv.device.type == "cpu":
        return line_sweep_ref(adv, pk, d4, s, axis, exact)
    return _launch(adv, pk, d4, s, axis, axis, exact)


def line_sweep_2d(adv, pk, d3, scal, axis: int, exact: bool) -> torch.Tensor:
    """Solve the three 2D systems (u, v, T) of direction ``axis``; x3."""
    s = _check(adv, pk, d3, scal, axis, 2)
    if adv.device.type == "cpu":
        return line_sweep_2d_ref(adv, pk, d3, s, axis, exact)
    # the 3D kernel on the view (1, nx, ny): X is its axis 1, Y its axis 2
    return _launch(adv[None], pk[None], d3[:, None], s, axis + 1, axis,
                   exact).squeeze(1)


def _launch(adv, pk, d, s, kaxis, axis, exact, z_rows=0):
    """One launch of line_sweep.cu on (nx, ny, nz) views; ``kaxis`` is
    the sweep axis of the view, ``axis`` the caller's (for messages).  The
    kernel reads the mode off the number of variables: 4 is 3D, 3 is 2D
    (T = 2, the 2D FREE rows).  ``z_rows`` names a 3D Z tile by its rows
    (``Z_ROWS``; 0 is the source's own), for timing the alternatives."""
    if adv.device.type != "cuda":
        raise RuntimeError(f"line_sweep has no kernel for {adv.device}")
    from ..kernels.build import load_library
    bf16 = d.dtype == torch.bfloat16
    lib = load_library().lib
    fn = lib.cmcfs_line_sweep_bf16 if bf16 else lib.cmcfs_line_sweep
    nvars = d.shape[0]
    n = adv.shape[kaxis]
    x = torch.empty_like(d)
    # c' of the velocities' rows and of T's, d' of every variable, laid
    # out [plane][row][line]; the lines are (i1, i2) over the other two
    # axes, i2 the later
    nx, ny, nz = adv.shape
    scratch = walk_scratch(nvars + 2, n, *(m for i, m in enumerate(adv.shape)
                                           if i != kaxis), adv.device)
    with torch.cuda.device(adv.device):
        stream = torch.cuda.current_stream(adv.device).cuda_stream
        err = fn(adv.data_ptr(), pk.data_ptr(), d.data_ptr(), x.data_ptr(),
                 scratch.data_ptr(), nx, ny, nz, kaxis, int(exact), nvars,
                 z_rows, *(float(v) for v in s), stream)
    if err != 0:
        raise RuntimeError(f"line_sweep kernel launch failed: CUDA error "
                           f"{err} (shape {tuple(adv.shape)}, axis {axis})")
    (bf16_launches if bf16 else launches).count += 1
    return x


def _ref(adv, pk, d, scal, axis, exact, bc2d):
    """Plain PyTorch line sweep of every variable in ``d``; T is last;
    x in d's dtype (bf16: upcast in, float32 Thomas, rounded out)."""
    v_vis_h2, t_vis_h2, inv3dt, inv2h = np.asarray(scal, dtype=np.float32)
    cls, bcv, bct = decode_pk(pk)
    adv_2h = adv * inv2h
    t_var = d.shape[0] - 1
    xs = []
    for v in range(d.shape[0]):
        vis = t_vis_h2 if v == t_var else v_vis_h2
        free = (bct if v == t_var else bcv) == 1
        a, b, c = build_abc(cls, free, adv_2h, vis, inv3dt + _F(2.0) * vis,
                            bc2d)
        xs.append(tridiag_rows_ref(a, b, c, d[v].float(), axis=axis,
                                   exact=exact, recip_row0=True))
    return torch.stack(xs).to(d.dtype)


def line_sweep_ref(adv, pk, d4, scal, axis: int, exact: bool):
    """Plain PyTorch 3D line sweep on any device; returns x4."""
    return _ref(adv, pk, d4, scal, axis, exact, bc2d=False)


def line_sweep_2d_ref(adv, pk, d3, scal, axis: int, exact: bool):
    """Plain PyTorch 2D line sweep on any device; returns x3."""
    return _ref(adv, pk, d3, scal, axis, exact, bc2d=True)


def _check_iteration(temp4, rhs4, out4, types, pk, vals, scal, hs, axis):
    if temp4.dim() != 4 or temp4.shape[0] != 4:
        raise ValueError(f"temp4 must be (4, nx, ny, nz), got "
                         f"{tuple(temp4.shape)}")
    if axis not in range(3):
        raise ValueError(f"axis must be in 0..2, got {axis}")
    shape = tuple(temp4.shape[1:])
    if len(vals) != 4:
        raise ValueError(f"vals must hold 4 tensors, got {len(vals)}")
    named = [("temp4", temp4), ("rhs4", rhs4), ("out4", out4),
             ("types", types), ("pk", pk)] + [
        (f"vals[{i}]", v) for i, v in enumerate(vals)]
    for name, t in named:
        dtype = torch.int8 if name in ("types", "pk") else torch.float32
        want = (4,) + shape if name.endswith("4") else shape
        if t.device != temp4.device:
            raise ValueError(f"{name} is on {t.device}, temp4 on "
                             f"{temp4.device}")
        if t.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
        if tuple(t.shape) != want:
            raise ValueError(f"{name} must be {want}, got {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    s = np.asarray(scal, dtype=np.float32)
    h = np.asarray(hs, dtype=np.float32)
    if s.shape != (6,) or h.shape != (3,):
        raise ValueError(f"scal must hold 6 values and hs 3, got shapes "
                         f"{s.shape}, {h.shape}")
    return s, h


def fallback_iteration(temp4, rhs4, out4, types, pk, vals, scal, hs,
                       axis: int, exact: bool):
    """One local iteration of a dual-free fallback direction along
    ``axis``; returns (out4, tn4), new tensors.

    ``temp4``, ``rhs4``, ``out4``: (4, nx, ny, nz) float32, u, v, w, T;
    ``types`` the node types and ``pk`` the packed masks of the axis's
    line classes (``sweep_common.pack_masks``), (nx, ny, nz) int8;
    ``vals`` the grid's boundary values of u, v, w, T; ``scal`` = [v_vis/
    h^2, t_vis/h^2, 3/dt, 1/(2h), v_T, t_phi] (``models/adi3d._nl_scal``'s
    first six) and ``hs`` = (dx, dy, dz), float32.  CUDA tensors launch
    ``cmcfs_line_fallback`` or raise; CPU tensors run
    ``fallback_iteration_ref``."""
    s, h = _check_iteration(temp4, rhs4, out4, types, pk, vals, scal, hs,
                            axis)
    if temp4.device.type == "cpu":
        return fallback_iteration_ref(temp4, rhs4, out4, types, pk, vals, s,
                                      h, axis, exact)
    if temp4.device.type != "cuda":
        raise RuntimeError(f"fallback_iteration has no kernel for "
                           f"{temp4.device}")
    from ..kernels.build import load_library
    fn = load_library().lib.cmcfs_line_fallback
    shape = tuple(types.shape)
    out, tn = torch.empty_like(temp4), torch.empty_like(temp4)
    # the line sweep's scratch: c' of the two row sets, d' of u, v, w, T
    scratch = walk_scratch(6, shape[axis], *(m for i, m in enumerate(shape)
                                             if i != axis), temp4.device)
    two_h = [float(_F(2.0) * x) for x in h]
    with torch.cuda.device(temp4.device):
        stream = torch.cuda.current_stream(temp4.device).cuda_stream
        err = fn(temp4.data_ptr(), rhs4.data_ptr(), out4.data_ptr(),
                 pk.data_ptr(), types.data_ptr(),
                 *(v.data_ptr() for v in vals), out.data_ptr(),
                 tn.data_ptr(), scratch.data_ptr(), *shape, axis,
                 int(exact), *(float(v) for v in s), two_h[axis],
                 *(x for i, x in enumerate(two_h) if i != axis), stream)
    if err != 0:
        raise RuntimeError(f"fallback_iteration kernel launch failed: CUDA "
                           f"error {err} (shape {shape}, axis {axis})")
    fused_launches.count += 1
    return out, tn


def fallback_iteration_ref(temp4, rhs4, out4, types, pk, vals, scal, hs,
                           axis: int, exact: bool):
    """Plain PyTorch ``fallback_iteration`` on any device: the composition
    of ``models/adi3d``'s fallback (``fallback_rhs``, ``fold_d``, the line
    sweep, UpdateSegment, the NODE_IN merge), the FREE bits and classes
    read from ``pk``."""
    _, _, inv3dt, _, v_T, t_phi = np.asarray(scal, dtype=np.float32)
    hs = tuple(_F(x) for x in hs)
    cls, bcv, bct = decode_pk(pk)
    d = rhs4 * inv3dt
    d[axis] = d[axis] - v_T * stencil.d1(temp4[3], hs[axis], axis)
    d[3] = d[3] + t_phi * _DISS[axis](temp4[0], temp4[1], temp4[2], *hs)
    d_bc = torch.where(torch.stack((bcv, bcv, bcv, bct)) == 1, 0.0,
                       torch.stack(tuple(vals)))
    d = torch.where(cls == INTERIOR, d,
                    torch.where((cls == BC0) | (cls == BC1), d_bc, 0.0))
    x = line_sweep_ref(temp4[axis], pk, d, scal[:4], axis, exact)
    out = torch.where(cls != 0, x, out4)
    tn = torch.where(types == NodeType.IN, (temp4 + out) / 2.0, temp4)
    return out, tn
