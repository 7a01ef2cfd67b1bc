"""3D ADI time step (port of cmcfs_tpu/models/adi3d.py, single device).

Numerics replicate src/FluidSolver3D/AdiSolver3D.cpp as the JAX package
does: per global iteration a Z sweep (rhs cur -> next), a Y sweep (next ->
half) and an X sweep (half -> next), each ``num_local`` implicit local
iterations with the NODE_IN merge, then the MergeLayer temp <- (temp +
next)/2 on IN cells, folded into the X direction's final pair (gmerge)
when X ends on one.

Each direction takes one of cmcfs_tpu's four paths, chosen by the same
predicates (``_dir_path``, adi3d.py:482-507):

* "pair"        the pair sweep (``ops/pair_sweep.py``; under ``fused_pcr``
                and ``fused_pcr_bf16`` its PCR form, ``ops/pcr_sweep.py``),
                num_local/2 times, lines with FREE dual endpoints stitched
                in the kernel (the ``dual_flags`` plane);
* "pair+stream" the pairs, then one stream iteration (odd num_local;
                dual-free only, Thomas under the PCR backends too, as in
                cmcfs_tpu);
* "stream"      num_local stream iterations (``ops/stream_sweep.py``);
* "fallback"    per iteration: the RHS built here with ``ops/stencil``,
                the line sweep (``ops/line_sweep.py``) per line class with
                the ``cls_b``/``take_b`` dual stitch, then UpdateSegment
                and the NODE_IN merge.  Backends ``scan``, ``pallas`` and
                ``pcr`` take this path with materialized (a, b, c) rows,
                one set for u, v and w and one for T, solved by
                ``ops/tridiag.tridiag_solve`` (the tridiag_rows kernel in
                its k-form, or PCR; ``solve_with_cls``, adi3d.py:305-332).

The choice is made on the shape after cmcfs_tpu's step-level tile padding
decision (``_step_pad``), as cmcfs_tpu's dispatch makes it; the port does
not pad its tensors, since padded cells are inert identity rows.  The
TPU's layout machinery (xmode, stacked, targeted, carried) is not ported:
on the TPU it is bitwise equal to the per-direction path.  Under the
default xmode layout cmcfs_tpu runs PCR on every pair direction of
``fused_pcr`` (adi3d.py:559-575, 971-975), and so does the port.

The step keeps the fields stacked (4, nx, ny, nz): it stacks ``cur`` and
``nxt_prev`` once, and the returned State3D's fields are views of one
stacked tensor.

The bf16 backends (``fused_bf16``, ``fused_pcr_bf16``) store the kernels'
payloads in bfloat16 and compute in float32, rounding where cmcfs_tpu
rounds: the pair and stream sweeps read rhs and out_prev rounded
(adi3d.py:415-419, 544-548) and their out and tn come back rounded and
upcast (:452-454, :676-678), temp staying float32; the fallback rounds the
folded d, BC values included (:291-295), and upcasts x before the dual
stitch, UpdateSegment and the merge, which run in float32 on the
unrounded out_prev (:301-302).  A pair or stream direction's out stays in
bf16 (its values are cmcfs_tpu's float32 upcast of them), so the next
kernel that reads it as rhs or out_prev needs no cast; temp and the
fallback's arithmetic are float32, and the step returns float32.
"""
from __future__ import annotations

import contextlib
from typing import NamedTuple

import numpy as np
import torch

from ..core.types import BCtype, NodeType
from ..ops import stencil
from ..ops.line_sweep import line_sweep
from ..ops.masks import BC0, BC1, INTERIOR
from ..ops.pair_sweep import pair_sweep
from ..ops.pcr_sweep import pcr_sweep
from ..ops.stream_sweep import stream_sweep
from ..ops.sweep_common import build_abc
from ..ops.tridiag import tridiag_solve
from .common3d import GridArrays3D, State3D

ERR_THRESHOLD = 0.01       # reference AdiSolver3D.h:32

# the pair and stream TPU kernels keep whole lines in VMEM up to this
# length (pallas_sweep_nl.py:70, pallas_sweep_stream.py:58); the port's
# kernels have no cap, but the dispatch keeps cmcfs_tpu's decisions
MAX_SWEEP = 256
# cmcfs_tpu's step-level pad tiles (adi3d.py:713)
_STEP_TILES = (8, 128, 128)

_F = np.float32
_AXES = ((0, "X"), (1, "Y"), (2, "Z"))
_DISS = (stencil.diss_x_3d, stencil.diss_y_3d, stencil.diss_z_3d)
# the backends the port runs; the fused ones are cmcfs_tpu's step-pad list
# (adi3d.py:728-732), scan, pallas and pcr solve materialized rows
FUSED = ("fused_nl", "fused_pcr", "fused_bf16", "fused_pcr_bf16",
         "fused_full", "fused_dma", "fused")
BACKENDS = FUSED + ("scan", "pallas", "pcr")
# the backends whose pair directions run the pair kernel, those that run
# its PCR form, and those that store the kernels' payloads in bf16
PAIR_BACKENDS = ("fused_nl", "fused_pcr", "fused_bf16", "fused_pcr_bf16")
PCR_BACKENDS = ("fused_pcr", "fused_pcr_bf16")
BF16_BACKENDS = ("fused_bf16", "fused_pcr_bf16")


class ParamsArgs3D(NamedTuple):
    """Physical parameters and spacings as float32 scalars."""
    v_T: np.float32
    v_vis: np.float32
    t_vis: np.float32
    t_phi: np.float32
    dx: np.float32
    dy: np.float32
    dz: np.float32


def make_params(params, dx, dy, dz) -> ParamsArgs3D:
    """From a ``core.params.FluidParams`` and the grid spacings."""
    return ParamsArgs3D(*(_F(x) for x in (params.v_T, params.v_vis,
                                          params.t_vis, params.t_phi,
                                          dx, dy, dz)))


def _nl_scal(axis: int, pa: ParamsArgs3D, dt) -> np.ndarray:
    """The pair sweep's 8 float32 scalars for direction ``axis``, rounded
    as cmcfs_tpu's float32 arithmetic rounds them (adi3d.py:132-145):
    [v_vis/h^2, t_vis/h^2, 3/dt, 1/(2h), v_T, t_phi, 1/(2h1), 1/(2h2)],
    h1 < h2 the spacings of the two cross axes in axis order.  The line
    sweep takes the first 4 (adi3d.py:251-254), the stream sweep the
    first 5 (:410-411)."""
    dt = _F(dt)
    dxyz = (pa.dx, pa.dy, pa.dz)
    h = dxyz[axis]
    h1, h2 = (dxyz[ax] for ax in range(3) if ax != axis)
    one, two = _F(1.0), _F(2.0)
    return np.array([pa.v_vis / (h * h), pa.t_vis / (h * h), _F(3.0) / dt,
                     one / (two * h), pa.v_T, pa.t_phi, one / (two * h1),
                     one / (two * h2)], dtype=np.float32)


def resolve_backend(backend: str) -> str:
    """``auto`` means ``fused_nl``: the card's default, as the TPU's."""
    backend = "fused_nl" if backend == "auto" else backend
    if backend in BACKENDS:
        return backend
    raise KeyError(f"unknown backend {backend!r}")


def _step_pad(shape3: tuple, backend: str):
    """cmcfs_tpu's step-level tile padding decision (adi3d.py:716-743) on
    a single device: the (px, py, pz) pads to (8, 128, 128) multiples when
    they grow the grid by at most 25 %, else None; None for the
    row backends (scan, pallas, pcr), as cmcfs_tpu pads only its fused
    list."""
    if backend not in FUSED:
        return None
    tgt = tuple(-n % t for n, t in zip(shape3, _STEP_TILES))
    grow = np.prod([n + p for n, p in zip(shape3, tgt)]) / max(
        int(np.prod(shape3)), 1)
    return tgt if any(tgt) and grow <= 1.25 else None


def _nl_pair_active(n_sweep: int, backend: str, merge_ok_ax: bool,
                    dual_free: bool, num_local: int) -> bool:
    """Does this direction run the pair sweep (adi3d.py:459-479)?"""
    if backend not in PAIR_BACKENDS or num_local < 2:
        return False
    if not dual_free and num_local % 2 != 0:
        return False
    return merge_ok_ax and n_sweep <= MAX_SWEEP


def _dir_path(n_sweep: int, backend: str, merge_ok_ax: bool,
              dual_free: bool, num_local: int) -> str:
    """cmcfs_tpu's _dir_path (adi3d.py:482-507) on a single device."""
    if backend not in ("fused_full",) + PAIR_BACKENDS or n_sweep > MAX_SWEEP:
        return "fallback"
    if _nl_pair_active(n_sweep, backend, merge_ok_ax, dual_free, num_local):
        return "pair" if num_local % 2 == 0 else "pair+stream"
    return "stream" if merge_ok_ax and dual_free else "fallback"


def dispatch_report(shape3: tuple, duals: tuple, backend: str,
                    num_local: int,
                    merge_ok: tuple = (False, False, False)) -> dict:
    """Which implementation each direction runs, decided as cmcfs_tpu's
    dispatch_report decides it (adi3d.py:746-793) on a single device:
    {"backend", "pad", "pcr", "bf16", "dirs"}, dirs {"X"|"Y"|"Z": "pair"|
    "pair+stream"|"stream"|"fallback"}; ``pcr``: the pair directions
    reduce cyclically (``fused_pcr``, ``fused_pcr_bf16``); ``bf16``: the
    kernels' payloads are stored in bf16 (``fused_bf16``,
    ``fused_pcr_bf16``).  ``duals``: per axis, the grid keeps a dual pass
    B (``GridArrays3D.cls_b``)."""
    backend = resolve_backend(backend)
    pad = _step_pad(tuple(shape3), backend)
    pshape = (tuple(n + p for n, p in zip(shape3, pad)) if pad
              else tuple(shape3))
    dirs = {name: _dir_path(pshape[ax], backend, merge_ok[ax],
                            not duals[ax], num_local)
            for ax, name in _AXES}
    return dict(backend=backend, pad=pad, pcr=backend in PCR_BACKENDS,
                bf16=backend in BF16_BACKENDS, dirs=dirs)


def fallback_rhs(axis, rhs4, temp4, ga, pa, inv3dt):
    """The fused branch's right-hand sides (adi3d.py:213-249): (d4, d_bc4).
    d4: rhs*3/dt, - v_T dT/dh on the sweep velocity, + t_phi*diss on T,
    derivatives by ``stencil`` (which divides by 2h, unlike the pair and
    stream sweeps); d_bc4: the boundary rows' values, 0 where FREE, else
    the grid's values."""
    h = (pa.dx, pa.dy, pa.dz)[axis]
    d = rhs4 * inv3dt
    d[axis] = d[axis] - pa.v_T * stencil.d1(temp4[3], h, axis)
    d[3] = d[3] + pa.t_phi * _DISS[axis](temp4[0], temp4[1], temp4[2],
                                         pa.dx, pa.dy, pa.dz)
    free_v = ga.bc_vel == BCtype.FREE
    free_t = ga.bc_temp == BCtype.FREE
    d_bc = torch.where(torch.stack((free_v, free_v, free_v, free_t)), 0.0,
                       torch.stack((ga.val_u, ga.val_v, ga.val_w, ga.val_T)))
    return d, d_bc


def fold_d(d, d_bc, cls):
    """build_d_folded (adi3d.py:238-249): interior rows keep d, boundary
    rows take the BC values, identity rows 0."""
    return torch.where(cls == INTERIOR, d,
                       torch.where((cls == BC0) | (cls == BC1), d_bc, 0.0))


def row_coeffs(axis, adv, cls, ga, pa, scal, vi):
    """(a, b, c) of variable ``vi``'s materialized rows (solve_with_cls,
    adi3d.py:310-322; its ``_bc_rows_3d`` boundary rows, :194-205, are
    build_abc's 3D rows); advection divides by 2h, as cmcfs_tpu's rows
    do.  u, v and w share theirs."""
    h = (pa.dx, pa.dy, pa.dz)[axis]
    vis = scal[1] if vi == 3 else scal[0]
    free = (ga.bc_temp if vi == 3 else ga.bc_vel) == BCtype.FREE
    return build_abc(cls, free, adv / (_F(2.0) * h), vis,
                     scal[2] + _F(2.0) * vis)


def _solve_rows(axis, d4, adv, cls, ga, pa, scal, exact, backend):
    """solve_with_cls (adi3d.py:305-332), single device: u, v and w share
    their rows, so one solve takes the three of them (the k-form) and one
    T; one set of rows is alive at a time."""
    xs = [tridiag_solve(*row_coeffs(axis, adv, cls, ga, pa, scal, vi), d,
                        axis=axis, exact=exact, backend=backend)
          for vi, d in ((0, d4[:3]), (3, d4[3]))]
    return torch.cat((xs[0], xs[1][None]))


def _build_and_solve(axis, rhs4, temp4, ga, pa, scal, exact, backend):
    """_build_and_solve_3d (adi3d.py:208-384) on a single device: the fused
    branch (the line sweep; the bf16 backends round its folded d and upcast
    its x, solve_fused :291-302) or, for scan and pallas, the row path; x4
    for both line classes, stitched where pass B wins."""
    d, d_bc = fallback_rhs(axis, rhs4.float(), temp4, ga, pa, scal[2])
    adv = temp4[axis]
    if backend in BF16_BACKENDS:
        def solve(pk, cls):
            return line_sweep(adv, pk, fold_d(d, d_bc, cls).bfloat16(),
                              scal[:4], axis, exact).float()
    elif backend in FUSED:
        def solve(pk, cls):
            return line_sweep(adv, pk, fold_d(d, d_bc, cls), scal[:4], axis,
                              exact)
    else:
        def solve(pk, cls):
            return _solve_rows(axis, fold_d(d, d_bc, cls), adv, cls, ga, pa,
                               scal, exact, backend)
    x = solve(ga.pk_a[axis], ga.cls_a[axis])
    if ga.cls_b[axis] is not None:
        x_b = solve(ga.pk_b[axis], ga.cls_b[axis])
        x = torch.where(ga.take_b[axis], x_b, x)
    return x


def _stream_iteration(axis, rhs4, temp4, out4, ga, pa, scal, exact,
                      bf16=False):
    """_solve_stream_fused (adi3d.py:387-456): returns (temp4, out4).
    ``bf16``: rhs4 and out4 go in rounded (a no-op on bf16 tensors), tn
    comes back rounded and is upcast, out stays bf16."""
    forcing = pa.t_phi * _DISS[axis](temp4[0], temp4[1], temp4[2],
                                     pa.dx, pa.dy, pa.dz)
    pay = _payload(bf16)
    out4, tn4 = stream_sweep(temp4, ga.cls_a[axis], ga.bc_vel, ga.bc_temp,
                             pay(rhs4), pay(out4), forcing, scal[:5], axis,
                             exact)
    return tn4.float(), out4


def _payload(bf16):
    """A kernel's payload as the backend stores it: bf16 rounded to
    nearest even (the tensor itself if it is bf16), or the float32 tensor
    itself."""
    return torch.Tensor.bfloat16 if bf16 else (lambda t: t)


def _solve_direction(axis, path, rhs4, temp4, out4, ga, pa, scal,
                     num_local, exact, gmerge, backend):
    """SolveDirection (adi3d.py:1516-1566) on the chosen path; returns
    (temp4, out4)."""
    if path == "fallback":
        # UpdateSegment writes every segment cell incl. the BC endpoints
        # (AdiSolver3D.cpp:707-730); identity rows keep their values
        written = ga.cls_a[axis] != 0
        is_in = ga.types == NodeType.IN
        for _ in range(num_local):
            x = _build_and_solve(axis, rhs4, temp4, ga, pa, scal, exact,
                                 backend)
            out4 = torch.where(written, x, out4)
            temp4 = torch.where(is_in, (temp4 + out4) / 2.0, temp4)
        return temp4, out4
    n_left = num_local
    bf16 = backend in BF16_BACKENDS
    if path in ("pair", "pair+stream"):
        sweep = pcr_sweep if backend in PCR_BACKENDS else pair_sweep
        pay = _payload(bf16)
        rhs_p = pay(rhs4)
        pairs = num_local // 2
        for k in range(pairs):
            out4, temp4 = sweep(temp4, ga.cls_a[axis], ga.bc_vel, ga.bc_temp,
                                rhs_p, pay(out4), scal, axis, exact,
                                gmerge and k == pairs - 1,
                                ga.dual_flags[axis])
            temp4 = temp4.float()
        n_left = num_local % 2
    for _ in range(n_left):
        temp4, out4 = _stream_iteration(axis, rhs4, temp4, out4, ga, pa,
                                        scal, exact, bf16)
    return temp4, out4


def _step_paths(ga: GridArrays3D, backend: str, num_local: int,
               merge_ok: tuple) -> list:
    """The path of each axis (0, 1, 2) for this grid."""
    duals = tuple(c is not None for c in ga.cls_b)
    rep = dispatch_report(tuple(ga.types.shape), duals, backend, num_local,
                          merge_ok)
    return [rep["dirs"][name] for _, name in _AXES]


def _no_section(name):
    return contextlib.nullcontext()


def adi_timestep_3d(cur: State3D, nxt_prev: State3D, ga: GridArrays3D, dt,
                    num_global: int, num_local: int, pa: ParamsArgs3D,
                    backend: str = "auto", exact: bool = True,
                    compute_error: bool = True,
                    merge_ok: tuple = (False, False, False),
                    section=_no_section):
    """One reference TimeStep (AdiSolver3D.cpp:306-391).

    Returns (new_cur, err); ``err`` is a 0-d float32 tensor, or -1.0 when
    ``compute_error`` is False.  ``nxt_prev`` is the persistent next layer;
    only its BOUND/VALVE cells are re-seeded from ``cur``.  ``section(name)``
    gives a context for each part of the step, under the reference's event
    names (``adi_timestep_3d_profiled``)."""
    backend = resolve_backend(backend)
    paths = _step_paths(ga, backend, num_local, merge_ok)
    # the global MergeLayer folds into X's final pair (adi3d.py:1727-1745)
    gfold = paths[0] == "pair"
    scals = [_nl_scal(ax, pa, dt) for ax in range(3)]
    types = ga.types
    is_bv = (types == NodeType.BOUND) | (types == NodeType.VALVE)
    is_in = types == NodeType.IN
    with section("CopyLayer"):
        cur4 = torch.stack(tuple(cur))
        nxt4 = torch.where(is_bv, cur4, torch.stack(tuple(nxt_prev)))
    temp4 = cur4
    half4 = torch.zeros_like(cur4)

    def direction(axis, rhs4, temp4, out4, gmerge=False):
        with section("SolveSegments_" + "XYZ"[axis]):
            return _solve_direction(axis, paths[axis], rhs4, temp4, out4, ga,
                                    pa, scals[axis], num_local, exact, gmerge,
                                    backend)

    # the bf16 backends' Z rhs, rounded once a step for the kernels
    rhs_z = (cur4.bfloat16() if backend in BF16_BACKENDS
             and paths[2] != "fallback" else cur4)
    for _ in range(num_global):
        temp4, nxt4 = direction(2, rhs_z, temp4, nxt4)
        temp4, half4 = direction(1, nxt4, temp4, half4)
        temp4, nxt4 = direction(0, half4, temp4, nxt4, gmerge=gfold)
        with section("MergeLayer"):
            if not gfold:
                temp4 = torch.where(is_in, (temp4 + nxt4) / 2.0, temp4)
    nxt = State3D(*nxt4.float().unbind(0))
    with section("EvalDivError"):
        if compute_error:
            err = stencil.div_error_3d(nxt.u, nxt.v, nxt.w, types,
                                       pa.dx, pa.dy, pa.dz)
        else:
            err = torch.tensor(-1.0, dtype=torch.float32)
    return nxt, err


def adi_timestep_3d_profiled(cur: State3D, nxt_prev: State3D,
                             ga: GridArrays3D, dt, num_global: int,
                             num_local: int, pa: ParamsArgs3D, prof,
                             backend: str = "auto", exact: bool = True,
                             merge_ok: tuple = (False, False, False)):
    """``adi_timestep_3d`` with each part timed into ``prof`` (a
    ``utils.profiler.Profiler``) under the reference's event names
    (CopyLayer, SolveSegments_Z/Y/X, MergeLayer, EvalDivError:
    src/Common/Profiler.h:44-134, cmcfs_tpu's adi3d.py:1596-1654).  The
    same kernels run and the result is the same; where X's final pair
    folds the global merge (gmerge), MergeLayer times no work.  The
    profiler synchronizes the device around each section.  Returns
    (new_cur, err as a float)."""
    nxt, err = adi_timestep_3d(cur, nxt_prev, ga, dt, num_global, num_local,
                               pa, backend=backend, exact=exact,
                               merge_ok=merge_ok, section=prof.section)
    return nxt, float(err)
