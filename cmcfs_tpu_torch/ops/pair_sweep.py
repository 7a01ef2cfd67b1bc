"""The pair sweep: two local ADI iterations of one direction, 4 variables.

Port of ``cmcfs_tpu/ops/pallas_sweep_nl.py::fused_sweep_nl`` in its Thomas
form, with gmerge, the dual second chain (``flags``) and the bf16 payloads.
Its pcr mode is ``ops/pcr_sweep.py``, which shares this module's plain
iteration; its targeted layout writes are not ported.  Fields keep the JAX
package's layout: stacked (4, nx, ny, nz) float32 (u, v, w, T) and
(nx, ny, nz) int8 masks.

The payloads' dtype selects the mode, as in the JAX package
(``rp4.dtype == bfloat16``, pallas_sweep_nl.py:1161): with ``rhs4`` and
``out_prev4`` in bfloat16 the pair reads them upcast, computes in float32,
keeps the first iteration's out1 and tn1 in float32 (the TPU kernel keeps
them in VMEM, pallas_sweep_nl.py:269-273, :808, :834) and rounds only the
second iteration's out and tn to bfloat16 (:956-959, :1002-1005); temp4,
the masks and all arithmetic stay float32.  On the card that is two
launches: bf16 in and float32 out, then float32 out_prev in and bf16 out.

``pair_sweep`` dispatches on the tensors' device:

* CUDA tensors launch the hand-written kernel
  (``kernels/csrc/pair_sweep.cu``), once per local iteration, or raise;
* CPU tensors run ``pair_sweep_ref``, the plain PyTorch version with the
  same arithmetic, which the tests hold against ``cmcfs_tpu`` and
  ``chip_smoke.py`` holds the kernel against on the card.

Per iteration (scal = models/adi3d._nl_scal):
  rows     (a, b, c) = build_abc(cls, free, temp[axis]/(2h), vis, 3/dt + 2 vis)
  rhs      interior: rhs*3/dt (- v_T dT/dh on the sweep velocity,
           + t_phi*diss_axis(temp) on T); BC rows: 0 if FREE else temp;
           identity rows 0
  solve    Thomas in the reference order (ops/tridiag.py), or PCR
           (ops/pcr.py) for the pcr sweep
  duals    ``flags`` (models/common3d.dual_flags: bit 0 the cell takes the
           BC0 start role in pass B, bit 1 the stitch takes pass B): pass
           B solves the rows of cls_b = where(dual, BC0, cls) on the same
           d (the d row of a dual cell is the same in both roles), and
           x = where(take, x_B, x_A) before the update, so iteration 2 and
           its dissipation see the stitched field (pallas_sweep_nl.py:
           519-535)
  update   out = where(cls != 0, x, out_prev)
           tn = where(INTERIOR, (temp + out)/2, temp)
           gmerge: tn = where(INTERIOR, (tn + out)/2, tn)
Iteration 2 runs on (temp, out_prev) := (tn1, out1); gmerge applies to it
only.  Derivatives multiply by the reciprocal spacings in ``scal``, as the
TPU kernel does; ``ops/stencil.d1`` divides.  ``ops/stream_sweep.py`` runs
one such iteration with a caller-built T forcing, through the same kernel
(``launch_iteration``) and the same plain iteration (``iteration_ref``).
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.types import BCtype
from ..kernels.build import LaunchCounter
from .masks import BC0, BC1, INTERIOR
from .pcr import pcr_solve
from .stencil import shift
from .sweep_common import build_abc
from .tridiag_rows import tridiag_rows_ref

_F = np.float32

launches = LaunchCounter()        # one per local iteration, dual-free
dual_launches = LaunchCounter()   # one per local iteration with flags
bf16_launches = LaunchCounter()   # the same, bf16 payloads
dual_bf16_launches = LaunchCounter()


def check_inputs(temp4, cls, bcv, bct, rhs4, out_prev4, scal, axis,
                 nscal=8, ndim=3, flags=None):
    """Validate one iteration's operands, ``ndim``-D fields of ndim + 1
    variables (3D: u, v, w, T; 2D: u, v, T) and the optional dual
    ``flags``; ``rhs4`` and ``out_prev4`` are float32, or both bfloat16
    (the bf16 payloads); returns ``scal`` as float32."""
    pay = (torch.bfloat16 if rhs4.dtype == torch.bfloat16
           else torch.float32)
    if axis not in range(ndim):
        raise ValueError(f"axis must be in 0..{ndim - 1}, got {axis}")
    if cls.dim() != ndim:
        raise ValueError(f"cls must have {ndim} dims, got "
                         f"{tuple(cls.shape)}")
    shape4 = (ndim + 1,) + tuple(cls.shape)
    dev = temp4.device
    for name, t, dtype, shape in (
            ("temp4", temp4, torch.float32, shape4),
            ("rhs4", rhs4, pay, shape4),
            ("out_prev4", out_prev4, pay, shape4),
            ("cls", cls, torch.int8, shape4[1:]),
            ("bcv", bcv, torch.int8, shape4[1:]),
            ("bct", bct, torch.int8, shape4[1:])) + (
            () if flags is None else (("flags", flags, torch.int8,
                                       shape4[1:]),)):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, temp4 on {dev}")
        if t.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {shape}, got {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    s = np.asarray(scal, dtype=np.float32)
    if s.shape != (nscal,):
        raise ValueError(f"scal must hold {nscal} values, got shape "
                         f"{s.shape}")
    return s


def pair_sweep(temp4, cls, bcv, bct, rhs4, out_prev4, scal, axis: int,
               exact: bool, gmerge: bool, flags=None):
    """Two local iterations of direction ``axis``; returns (out4, tn4), in
    the payloads' dtype.

    ``scal``: the 8 float32 scalars of ``models/adi3d._nl_scal``;
    ``flags``: the direction's dual plane (``models/common3d``), or None
    on dual-free lines."""
    s = check_inputs(temp4, cls, bcv, bct, rhs4, out_prev4, scal, axis,
                     flags=flags)
    if temp4.device.type == "cpu":
        return pair_sweep_ref(temp4, cls, bcv, bct, rhs4, out_prev4, s, axis,
                              exact, gmerge, flags)
    if temp4.device.type != "cuda":
        raise RuntimeError(f"pair_sweep has no kernel for {temp4.device}")
    if rhs4.dtype == torch.bfloat16:
        counter = bf16_launches if flags is None else dual_bf16_launches
    else:
        counter = launches if flags is None else dual_launches
    # both launches share the scratch (same stream); the first writes
    # float32, the second the payloads' dtype
    scratch = new_scratch(4, cls, axis, flags is not None)
    out1, tn1 = launch_iteration(temp4, cls, bcv, bct, rhs4, out_prev4,
                                 None, scratch, s, axis, exact, False,
                                 flags=flags)
    counter.count += 1
    out4, tn4 = launch_iteration(tn1, cls, bcv, bct, rhs4, out1, None,
                                 scratch, s, axis, exact, gmerge,
                                 flags=flags, out_dtype=rhs4.dtype)
    counter.count += 1
    return out4, tn4


def new_scratch(nvars, cls, axis, dual=False):
    """The kernel's Thomas scratch for ``nvars`` variables swept along
    ``axis`` of ``cls``: c' of the velocity rows, c' of T's rows and d' of
    each variable, (nvars + 2, n, lines) float32; twice that with duals
    (pass B's planes after pass A's)."""
    n = cls.shape[axis]
    planes = (nvars + 2) * (2 if dual else 1)
    return torch.empty((planes, n, cls.numel() // n), dtype=torch.float32,
                       device=cls.device)


def launch_iteration(temp4, cls, bcv, bct, rhs4, op4, forcing, scratch, s,
                     axis, exact, gmerge, axis_var=None, first=False,
                     flags=None, out_dtype=torch.float32):
    """One launch of ``pair_sweep.cu``'s iteration kernel: the pair
    sweep's (``forcing`` None: dissipation in-kernel, 8 scalars, the dual
    chain where ``flags`` is given) or the stream sweep's (``forcing``
    given, 5 scalars, no gmerge, no duals).  Fields are (nvars, nx, ny,
    nz), masks (nx, ny, nz); ``axis`` is the sweep axis of that shape.
    Three variables (u, v, T) on the view (1, nx, ny) are the 2D stream
    mode (the 2D rows and the ``merge2d`` update with ``first``), which
    names the advecting velocity ``axis_var``.  A bfloat16 ``rhs4`` takes
    the bf16 entries (``pair_sweep_bf16.cu``, ``stream_sweep_bf16.cu``):
    out and tn of ``out_dtype``, ``op4`` bfloat16 or float32 as the pair's
    launches take them, and the stream's all bfloat16."""
    from ..kernels.build import load_library
    lib = load_library().lib
    bf16 = rhs4.dtype == torch.bfloat16
    out4 = torch.empty_like(temp4, dtype=out_dtype)
    tn4 = torch.empty_like(temp4, dtype=out_dtype)
    nx, ny, nz = cls.shape
    with torch.cuda.device(temp4.device):
        stream = torch.cuda.current_stream(temp4.device).cuda_stream
        ptrs = (temp4.data_ptr(), cls.data_ptr(), bcv.data_ptr(),
                bct.data_ptr(), rhs4.data_ptr(), op4.data_ptr())
        outs = (out4.data_ptr(), tn4.data_ptr(), scratch.data_ptr())
        if forcing is None:
            pay = ((int(op4.dtype == torch.bfloat16),
                    int(out_dtype == torch.bfloat16)) if bf16 else ())
            fn = (lib.cmcfs_pair_sweep_iter_bf16 if bf16
                  else lib.cmcfs_pair_sweep_iter)
            err = fn(*ptrs, None if flags is None else flags.data_ptr(),
                     *outs, nx, ny, nz, axis, int(exact), int(gmerge),
                     *(float(x) for x in s), *pay, stream)
        else:
            fn = (lib.cmcfs_stream_sweep_iter_bf16 if bf16
                  else lib.cmcfs_stream_sweep_iter)
            err = fn(*ptrs, forcing.data_ptr(), *outs, nx, ny, nz, axis,
                     int(exact), temp4.shape[0],
                     axis if axis_var is None else axis_var, int(first),
                     *(float(x) for x in s), stream)
    if err != 0:
        name = "pair_sweep" if forcing is None else "stream_sweep"
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err} "
                           f"(shape {tuple(cls.shape)}, axis {axis})")
    return out4, tn4


def _dd(f, inv2h, axis):
    """(f[i+1] - f[i-1]) * inv2h — the kernel's reciprocal form of d1."""
    return (shift(f, 1, axis) - shift(f, -1, axis)) * inv2h


def _forcing(temp4, axis, s):
    """t_phi * diss_axis(temp), term order of ops/stencil.diss_*_3d."""
    o1, o2 = (ax for ax in range(3) if ax != axis)
    adv = temp4[axis]
    gav = _dd(adv, s[3], axis)
    go1 = _dd(temp4[o1], s[3], axis)
    go2 = _dd(temp4[o2], s[3], axis)
    h1 = _dd(adv, s[6], o1)
    h2 = _dd(adv, s[7], o2)
    if axis == 0:
        diss = 2 * gav * gav + go1 * go1 + go2 * go2
    elif axis == 1:
        diss = go1 * go1 + 2 * gav * gav + go2 * go2
    else:
        diss = go1 * go1 + go2 * go2 + 2 * gav * gav
    return s[5] * (diss + go1 * h1 + go2 * h2)


def _solve(cls, free_v, free_t, adv2h, d, s, axis, exact, pcr):
    """x of the four systems on the rows of ``cls``: u, v and w share the
    velocity rows, T has its own; Thomas, or PCR where ``pcr``."""
    rows_v = build_abc(cls, free_v, adv2h, s[0], s[2] + _F(2.0) * s[0])
    rows_t = build_abc(cls, free_t, adv2h, s[1], s[2] + _F(2.0) * s[1])
    if pcr:
        return torch.cat((pcr_solve(*rows_v, d[:3], axis, exact),
                          pcr_solve(*rows_t, d[3], axis, exact)[None]))
    a, b, c = (torch.stack((rv, rv, rv, rt)) for rv, rt in zip(rows_v, rows_t))
    return tridiag_rows_ref(a, b, c, d, axis=axis + 1, exact=exact)


def iteration_ref(temp4, cls, bcv, bct, rhs4, op4, s, axis, exact, gmerge,
                  forcing=None, flags=None, pcr=False):
    """One local iteration, plain PyTorch; returns (out4, tn4).  The T
    equation's forcing is t_phi*diss_axis(temp) from ``s`` unless the
    caller passes ``forcing`` (the stream sweep); ``flags`` adds pass B and
    the stitch; ``pcr`` solves by cyclic reduction."""
    inv3dt, inv2h, v_T = s[2:5]
    adv2h = temp4[axis] * inv2h
    free_v = bcv == BCtype.FREE
    free_t = bct == BCtype.FREE

    d_int = rhs4 * inv3dt
    d_int[axis] = d_int[axis] - v_T * _dd(temp4[3], inv2h, axis)
    d_int[3] = d_int[3] + (_forcing(temp4, axis, s) if forcing is None
                           else forcing)
    free4 = torch.stack((free_v, free_v, free_v, free_t))
    interior = cls == INTERIOR
    d = torch.where(interior, d_int,
                    torch.where((cls == BC0) | (cls == BC1),
                                torch.where(free4, 0.0, temp4), 0.0))
    x = _solve(cls, free_v, free_t, adv2h, d, s, axis, exact, pcr)
    if flags is not None:
        cls_b = torch.where((flags & 1) != 0, BC0, cls).to(torch.int8)
        x_b = _solve(cls_b, free_v, free_t, adv2h, d, s, axis, exact, pcr)
        x = torch.where((flags & 2) != 0, x_b, x)
    out = torch.where(cls != 0, x, op4)
    tn = torch.where(interior, (temp4 + out) * 0.5, temp4)
    if gmerge:
        tn = torch.where(interior, (tn + out) * 0.5, tn)
    return out, tn


def pair_sweep_ref(temp4, cls, bcv, bct, rhs4, out_prev4, scal, axis: int,
                   exact: bool, gmerge: bool, flags=None, pcr=False):
    """Plain PyTorch pair sweep on any device; returns (out4, tn4) in the
    payloads' dtype.  bf16 payloads are upcast, both iterations run in
    float32, and only the second one's out and tn are rounded."""
    s = np.asarray(scal, dtype=np.float32)
    rhs = rhs4.float()
    out1, tn1 = iteration_ref(temp4, cls, bcv, bct, rhs, out_prev4.float(),
                              s, axis, exact, False, flags=flags, pcr=pcr)
    out, tn = iteration_ref(tn1, cls, bcv, bct, rhs, out1, s, axis, exact,
                            gmerge, flags=flags, pcr=pcr)
    return out.to(rhs4.dtype), tn.to(rhs4.dtype)
