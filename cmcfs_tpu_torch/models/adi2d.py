"""2D ADI time step (port of cmcfs_tpu/models/adi2d.py).

Numerics replicate src/FluidSolver2D/AdiSolver2D.cpp as the JAX package
does: per global iteration an X sweep (RHS from cur, writes half) and a Y
sweep (RHS from half, writes next), each ``num_local`` implicit local
iterations with the first-copy-then-average local merge, then the global
merge temp <- next (first iteration) or (temp + next)/2 on IN cells.  The
global loop runs while (it < num_global) or (div error > 0.1), at most
MAX_GLOBAL_ITERS + 2 times (TimeStep :291).

Each direction takes one of three paths, chosen by cmcfs_tpu's predicates
(``dispatch_report_2d``, adi2d.py:92-93, 126, 233-234):

* "stream" the 2D stream sweep (``ops/stream_sweep.stream_sweep_2d``):
           in-kernel RHS, solve and copy-then-merge; backends ``fused_full``
           and ``fused_nl`` where ``stream_ok_2d`` holds and the line fits
           ``_stream2d_fits``;
* "line"   the 2D line sweep (``ops/line_sweep.line_sweep_2d``) on an RHS
           built here, for the other fused backends and directions
           (``fused_bf16`` always: its folded d goes in rounded to bf16
           and its x comes back rounded and is upcast, adi2d.py:123-134);
* "rows"   materialized (a, b, c, d) rows solved by ``ops/tridiag``
           (backends ``scan`` and ``pallas``: the tridiag_rows kernel;
           ``pcr``: cyclic reduction in PyTorch ops, ``ops/pcr.py``, as
           cmcfs_tpu computes it in XLA ops).

The line and row paths divide (``cur/dt``, ``stencil.d1``); the stream
kernel multiplies by 1/dt and 1/(2h) and reads Dirichlet values from
temp, as each TPU counterpart does.  The global loop runs on the host and
reads the divergence error only once ``it >= num_global``: one device
sync per step in the usual case.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..core.types import BCtype, NodeType
from ..ops import stencil
from ..ops.line_sweep import line_sweep_2d
from ..ops.masks import BC0, BC1, INTERIOR
from ..ops.stream_sweep import stream_sweep_2d
from ..ops.sweep_common import build_abc
from ..ops.tridiag import tridiag_solve
from .common2d import GridArrays2D, State2D, clear_outer

ERR_THRESHOLD = 0.1        # reference AdiSolver2D.h:24
MAX_GLOBAL_ITERS = 100     # reference AdiSolver2D.h:25

_F = np.float32
# backends of the 2D step: the fused ones run the line sweep (and, where
# the stream predicates hold, the stream sweep for fused_full/fused_nl);
# scan and pallas solve materialized rows with the tridiag_rows kernel,
# pcr by cyclic reduction
FUSED = ("fused", "fused_dma", "fused_full", "fused_bf16", "fused_nl")
BACKENDS = FUSED + ("scan", "pallas", "pcr")


class ParamsArgs(NamedTuple):
    """Physical parameters, spacings and the base temperature, float32."""
    v_T: np.float32
    v_vis: np.float32
    t_vis: np.float32
    t_phi: np.float32
    dx: np.float32
    dy: np.float32
    start_T: np.float32


def make_params(params, dx, dy, start_T) -> ParamsArgs:
    """From a ``core.params.FluidParams``, the spacings and start_T."""
    return ParamsArgs(*(_F(x) for x in (params.v_T, params.v_vis,
                                        params.t_vis, params.t_phi, dx, dy,
                                        start_T)))


def resolve_backend(backend: str) -> str:
    """``auto`` means ``fused_dma``, the TPU's 2D default
    (solver2d.py:86-90), on every device."""
    backend = "fused_dma" if backend == "auto" else backend
    if backend in BACKENDS:
        return backend
    raise KeyError(f"unknown backend {backend!r}")


def stream_ok_2d(ga) -> tuple:
    """Per axis, the stream path's precondition (adi2d.py:151-165): BC rows
    sit on BOUND/VALVE cells (so temp carries the Dirichlet values) and
    interior rows coincide with NODE_IN.  ``ga``: a GridArrays2D or
    ``common2d.host_arrays``' dict; decided on the host."""
    get = ga.get if isinstance(ga, dict) else ga._asdict().get

    def host(name):
        a = get(name)
        return a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)

    types = host("types")
    is_in = types == NodeType.IN
    is_bv = (types == NodeType.BOUND) | (types == NodeType.VALVE)
    oks = []
    for name in ("cls_x", "cls_y"):
        c = host(name)
        bc = (c == BC0) | (c == BC1)
        oks.append(bool(is_bv[bc].all() and ((c == INTERIOR) == is_in).all()))
    return tuple(oks)


def _stream2d_fits(n_sweep: int) -> bool:
    """cmcfs_tpu's rule for the 2D stream path (adi2d.py:220-223):
    ``stream_vmem_need(ceil8(n)) < 100 MiB``, i.e. 18 slabs of
    ceil8(n) x 8 x 128 float32 (pallas_sweep_stream.py:388-394).  Kept as
    the dispatch rule so both packages take the same path; it holds to
    n = 1416 (1024 streams, 2048 does not)."""
    n = -(-n_sweep // 8) * 8
    return 18 * n * 8 * 128 * 4 < 100 * 2 ** 20


def _dir_path(n_sweep: int, backend: str, stream_ok_ax: bool) -> str:
    if backend in ("fused_full", "fused_nl") and stream_ok_ax \
            and _stream2d_fits(n_sweep):
        return "stream"
    return "line" if backend in FUSED else "rows"


def dispatch_report_2d(shape2: tuple, backend: str,
                       stream_ok: tuple = (False, False)) -> dict:
    """Which path each direction runs: {"X"|"Y": "stream"|"line"|"rows"},
    decided by the predicates cmcfs_tpu's adi_timestep_2d uses."""
    backend = resolve_backend(backend)
    return {name: _dir_path(shape2[ax], backend, stream_ok[ax])
            for ax, name in ((0, "X"), (1, "Y"))}


def _rhs(axis: int, cur: State2D, temp_local: State2D, pa: ParamsArgs, dt):
    """BuildMatrix's right-hand sides (adi2d.py:54-90): (d_u, d_v, d_T),
    per-element division as the reference (AdiSolver2D.cpp:137) and
    cmcfs_tpu round it, and the float32 scalars (h, 1/dt, v_vis/h^2,
    t_vis/h^2)."""
    h = pa.dx if axis == 0 else pa.dy
    dt = _F(dt)
    grad_T = stencil.d1(temp_local.T, h, axis)
    diss = (stencil.diss_x_2d if axis == 0 else stencil.diss_y_2d)(
        temp_local.u, temp_local.v, pa.dx, pa.dy)
    d_u = stencil.over(cur.u, dt)
    d_v = stencil.over(cur.v, dt)
    if axis == 0:
        d_u = d_u - pa.v_T * grad_T
    else:
        d_v = d_v - pa.v_T * grad_T
    d_T = stencil.over(cur.T, dt) + pa.t_phi * diss
    return (d_u, d_v, d_T), (h, _F(1.0) / dt, pa.v_vis / (h * h),
                             pa.t_vis / (h * h))


def _fold(cls, free, d_int, val):
    """d with the boundary rows' values folded in (AdiSolver2D.cpp:74-116):
    d_int on INTERIOR, 0 on FREE and ``val`` on NOSLIP BC rows, 0 on
    identity rows."""
    return torch.where(cls == INTERIOR, d_int,
                       torch.where((cls == BC0) | (cls == BC1),
                                   torch.where(free, 0.0, val), 0.0))


def line_args(axis: int, cur: State2D, temp_local: State2D, ga: GridArrays2D,
              dt, pa: ParamsArgs):
    """The fused branch's line-sweep operands (adi2d.py:92-121): (adv, pk,
    d3, scal), the boundary and identity values folded into d3."""
    (d_u, d_v, d_T), (h, inv_dt, v_vis_h2, t_vis_h2) = _rhs(
        axis, cur, temp_local, pa, dt)
    cls = ga.cls_x if axis == 0 else ga.cls_y
    free = ga.bct == BCtype.FREE
    d3 = torch.stack((_fold(cls, free, d_u, ga.bc_u),
                      _fold(cls, free, d_v, ga.bc_v),
                      _fold(cls, free, d_T, ga.bc_T)))
    scal = np.array([v_vis_h2, t_vis_h2, inv_dt, _F(1.0) / (_F(2.0) * h)],
                    dtype=_F)
    return (temp_local.u if axis == 0 else temp_local.v,
            ga.pk_x if axis == 0 else ga.pk_y, d3, scal)


def row_args(axis: int, cur: State2D, temp_local: State2D, ga: GridArrays2D,
             dt, pa: ParamsArgs):
    """The rows branch's materialized (a, b, c, d), each (3, nx, ny) for
    (u, v, T) (adi2d.py:75-84, 139-145); advection divides by 2h,
    correctly rounded on every device (``stencil.over``)."""
    (d_u, d_v, d_T), (h, inv_dt, v_vis_h2, t_vis_h2) = _rhs(
        axis, cur, temp_local, pa, dt)
    cls = ga.cls_x if axis == 0 else ga.cls_y
    free = ga.bct == BCtype.FREE
    adv_2h = stencil.over(temp_local.u if axis == 0 else temp_local.v,
                          _F(2.0) * h)
    rows = [build_abc(cls, free, adv_2h, vis, inv_dt + _F(2.0) * vis,
                      bc2d=True) + (_fold(cls, free, d_int, val),)
            for vis, d_int, val in ((v_vis_h2, d_u, ga.bc_u),
                                    (v_vis_h2, d_v, ga.bc_v),
                                    (t_vis_h2, d_T, ga.bc_T))]
    return tuple(torch.stack([r[i] for r in rows]) for i in range(4))


def _build_and_solve(axis: int, cur: State2D, temp_local: State2D,
                     ga: GridArrays2D, dt, pa: ParamsArgs, backend: str,
                     exact: bool) -> State2D:
    """One batched (u, v, T) solve along ``axis`` (adi2d.py:50-148)."""
    if backend == "fused_bf16":
        adv, pk, d3, scal = line_args(axis, cur, temp_local, ga, dt, pa)
        return State2D(*line_sweep_2d(adv, pk, d3.bfloat16(), scal, axis,
                                      exact).float())
    if backend in FUSED:
        return State2D(*line_sweep_2d(
            *line_args(axis, cur, temp_local, ga, dt, pa), axis, exact))
    x = tridiag_solve(*row_args(axis, cur, temp_local, ga, dt, pa),
                      axis=axis + 1, exact=exact, backend=backend)
    return State2D(*x)


def stream_args(axis: int, rhs: State2D, temp_local: State2D, out: State2D,
                ga: GridArrays2D, dt, pa: ParamsArgs):
    """The stream sweep's operands (adi2d.py:188-206): (temp3, cls, bct,
    rhs3, out3, forcing, scal); the forcing is t_phi * diss_axis(temp)."""
    h = pa.dx if axis == 0 else pa.dy
    diss = (stencil.diss_x_2d if axis == 0 else stencil.diss_y_2d)(
        temp_local.u, temp_local.v, pa.dx, pa.dy)
    scal = np.array([pa.v_vis / (h * h), pa.t_vis / (h * h),
                     _F(1.0) / _F(dt), _F(1.0) / (_F(2.0) * h), pa.v_T],
                    dtype=_F)
    return (torch.stack(tuple(temp_local)), ga.cls_x if axis == 0 else
            ga.cls_y, ga.bct, torch.stack(tuple(rhs)), torch.stack(tuple(out)),
            pa.t_phi * diss, scal)


def _solve_stream_2d(axis: int, rhs: State2D, temp_local: State2D,
                     out: State2D, ga: GridArrays2D, dt, pa: ParamsArgs,
                     exact: bool, first: bool):
    """One stream iteration (adi2d.py:180-217); returns (temp, out)."""
    o3, t3 = stream_sweep_2d(*stream_args(axis, rhs, temp_local, out, ga, dt,
                                          pa), axis, exact, first)
    return State2D(*t3), State2D(*o3)


def _solve_direction(axis: int, rhs: State2D, temp: State2D,
                     out_layer: State2D, ga: GridArrays2D, dt,
                     num_local: int, pa: ParamsArgs, backend: str,
                     exact: bool, stream_ok: tuple = (False, False)):
    """Reference SolveDirection (AdiSolver2D.cpp:203-226); returns
    (temp, out)."""
    if _dir_path(rhs.u.shape[axis], backend, stream_ok[axis]) == "stream":
        temp_local, out = temp, out_layer
        for it in range(num_local):
            temp_local, out = _solve_stream_2d(axis, rhs, temp_local, out,
                                               ga, dt, pa, exact,
                                               first=(it == 0))
        # the kernel writes only IN cells, so the trailing masking is done
        return temp_local, out

    is_in = ga.types == NodeType.IN
    temp_local = temp
    sol = None
    for it in range(num_local):
        sol = _build_and_solve(axis, rhs, temp_local, ga, dt, pa, backend,
                               exact)
        if it == 0:
            temp_local = State2D(*(torch.where(is_in, s, t)
                                   for t, s in zip(temp_local, sol)))
        else:
            temp_local = State2D(*(torch.where(is_in, (t + s) / 2.0, t)
                                   for t, s in zip(temp_local, sol)))
    temp_out = State2D(*(torch.where(is_in, tl, t)
                         for t, tl in zip(temp, temp_local)))
    next_out = State2D(*(torch.where(is_in, s, o)
                         for o, s in zip(out_layer, sol)))
    return temp_out, next_out


def adi_timestep_2d(cur: State2D, ga: GridArrays2D, dt, num_global: int,
                    num_local: int, pa: ParamsArgs, backend: str = "auto",
                    exact: bool = True, stream_ok: tuple = (False, False)):
    """One reference TimeStep (AdiSolver2D.cpp:279-323).

    Returns (new_cur, err, iters): ``err`` a 0-d float32 tensor, ``iters``
    the number of global iterations run.  The caller checks blow-up
    (reference exit(1) on err > 10*threshold or > 100 iterations)."""
    backend = resolve_backend(backend)
    is_in = ga.types == NodeType.IN
    temp = half = nxt = cur
    err = stencil.div_error_2d(cur.u, cur.v, ga.types, pa.dx, pa.dy)
    it = 0
    while it < MAX_GLOBAL_ITERS + 2:
        # the hybrid condition reads err only past num_global
        if it >= num_global and not float(err) > ERR_THRESHOLD:
            break
        temp, half = _solve_direction(0, cur, temp, half, ga, dt, num_local,
                                      pa, backend, exact, stream_ok)
        temp, nxt = _solve_direction(1, half, temp, nxt, ga, dt, num_local,
                                     pa, backend, exact, stream_ok)
        err = stencil.div_error_2d(nxt.u, nxt.v, ga.types, pa.dx, pa.dy)
        # copy on the first global iteration, average afterwards (:300-301)
        if it == 0:
            temp = State2D(*(torch.where(is_in, n, t)
                             for t, n in zip(temp, nxt)))
        else:
            temp = State2D(*(torch.where(is_in, (t + n) / 2.0, t)
                             for t, n in zip(temp, nxt)))
        it += 1
    return clear_outer(nxt, ga, pa.start_T), err, it
