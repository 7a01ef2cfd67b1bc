"""3D ADI time step on the pair sweep (port of cmcfs_tpu/models/adi3d.py).

Numerics replicate src/FluidSolver3D/AdiSolver3D.cpp as the JAX package
does: per global iteration a Z sweep (rhs cur -> next), a Y sweep (next ->
half) and an X sweep (half -> next), each ``num_local`` implicit local
iterations with the NODE_IN merge; the end-of-global MergeLayer folds into
the X direction's final pair (gmerge).

Only the path the 3D main path takes is ported: every direction on the
pair sweep (``ops/pair_sweep.py``), which needs an even ``num_local``,
interior rows equal to NODE_IN on each axis (``merge_ok``) and no FREE
dual endpoints.  Every other path raises ``NotImplementedError`` naming
its ROADMAP item; none falls through to another path.  The TPU layout
machinery (xmode, stacked, targeted, carried, step padding) is not
ported: on the TPU it is bitwise equal to the per-step path.

The step keeps the fields stacked (4, nx, ny, nz): it stacks ``cur`` and
``nxt_prev`` once, and the returned State3D's fields are views of one
stacked tensor.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from cmcfs_tpu.core.types import NodeType

from ..ops import stencil
from ..ops.pair_sweep import pair_sweep
from .common3d import GridArrays3D, State3D

ERR_THRESHOLD = 0.01       # reference AdiSolver3D.h:32

_F = np.float32
_AXES = ((0, "X"), (1, "Y"), (2, "Z"))
# the reason each non-pair path raises, by cmcfs_tpu's _dir_path name
_UNPORTED = {
    "pair+stream": "odd num_local needs the per-iteration stream kernel "
                   "for its trailing iteration (ROADMAP B4)",
    "stream": "num_local < 2 needs the per-iteration stream kernel "
              "(ROADMAP B4)",
    "fallback": "interior rows differ from NODE_IN on this axis (merge_ok "
                "false); the per-iteration row-build path is not ported "
                "(ROADMAP A4, B2)",
}


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
    """From a ``cmcfs_tpu.core.params.FluidParams`` and the grid spacings."""
    return ParamsArgs3D(*(_F(x) for x in (params.v_T, params.v_vis,
                                          params.t_vis, params.t_phi,
                                          dx, dy, dz)))


def _nl_scal(axis: int, pa: ParamsArgs3D, dt) -> np.ndarray:
    """The pair sweep's 8 float32 scalars for direction ``axis``, rounded
    as cmcfs_tpu's float32 arithmetic rounds them (adi3d.py:132-145):
    [v_vis/h^2, t_vis/h^2, 3/dt, 1/(2h), v_T, t_phi, 1/(2h1), 1/(2h2)],
    h1 < h2 the spacings of the two cross axes in axis order."""
    dt = _F(dt)
    dxyz = (pa.dx, pa.dy, pa.dz)
    h = dxyz[axis]
    h1, h2 = (dxyz[ax] for ax in range(3) if ax != axis)
    one, two = _F(1.0), _F(2.0)
    return np.array([pa.v_vis / (h * h), pa.t_vis / (h * h), _F(3.0) / dt,
                     one / (two * h), pa.v_T, pa.t_phi, one / (two * h1),
                     one / (two * h2)], dtype=np.float32)


def resolve_backend(backend: str) -> str:
    """``auto`` and ``fused_nl`` both mean the pair sweep."""
    if backend in ("auto", "fused_nl"):
        return "fused_nl"
    raise NotImplementedError(
        f"backend {backend!r} is not ported; the port runs the pair sweep "
        "(backend 'auto' or 'fused_nl') — see ROADMAP A4 and queue B")


def _dir_path(merge_ok_ax: bool, num_local: int) -> str:
    """cmcfs_tpu's _dir_path (adi3d.py:482-507) for backend fused_nl on a
    single device with dual-free lines; the port runs only "pair"."""
    if merge_ok_ax and num_local >= 2:
        return "pair" if num_local % 2 == 0 else "pair+stream"
    return "stream" if merge_ok_ax else "fallback"


def dispatch_report(backend: str, num_local: int,
                    merge_ok: tuple = (False, False, False)) -> dict:
    """Which implementation each direction runs: {"backend", "dirs"}, with
    dirs {"X"|"Y"|"Z": "pair"|"pair+stream"|"stream"|"fallback"}; anything
    but "pair" raises in ``adi_timestep_3d``."""
    return dict(backend=resolve_backend(backend),
                dirs={name: _dir_path(merge_ok[ax], num_local)
                      for ax, name in _AXES})


def _check_dispatch(backend, num_local, merge_ok) -> None:
    resolve_backend(backend)
    for ax, name in _AXES:
        path = _dir_path(merge_ok[ax], num_local)
        if path != "pair":
            raise NotImplementedError(
                f"direction {name} would take cmcfs_tpu's {path!r} path "
                f"(num_local={num_local}, merge_ok={merge_ok[ax]}): "
                f"{_UNPORTED[path]}")


def _solve_direction(axis, rhs4, temp4, out4, ga, scal, num_local, exact,
                     gmerge):
    """Pair branch of SolveDirection (adi3d.py:1516-1551): num_local/2
    chained pairs; the gmerge fold rides the final pair only."""
    pairs = num_local // 2
    for k in range(pairs):
        out4, temp4 = pair_sweep(temp4, ga.cls_a[axis], ga.bc_vel,
                                 ga.bc_temp, rhs4, out4, scal, axis, exact,
                                 gmerge and k == pairs - 1)
    return temp4, out4


def adi_timestep_3d(cur: State3D, nxt_prev: State3D, ga: GridArrays3D, dt,
                    num_global: int, num_local: int, pa: ParamsArgs3D,
                    backend: str = "auto", exact: bool = True,
                    compute_error: bool = True,
                    merge_ok: tuple = (False, False, False)):
    """One reference TimeStep (AdiSolver3D.cpp:306-391).

    Returns (new_cur, err); ``err`` is a 0-d float32 tensor, or -1.0 when
    ``compute_error`` is False.  ``nxt_prev`` is the persistent next layer;
    only its BOUND/VALVE cells are re-seeded from ``cur``."""
    _check_dispatch(backend, num_local, merge_ok)
    scals = [_nl_scal(ax, pa, dt) for ax in range(3)]
    types = ga.types
    is_bv = (types == NodeType.BOUND) | (types == NodeType.VALVE)
    cur4 = torch.stack(tuple(cur))
    nxt4 = torch.where(is_bv, cur4, torch.stack(tuple(nxt_prev)))
    temp4 = cur4
    half4 = torch.zeros_like(cur4)
    for _ in range(num_global):
        temp4, nxt4 = _solve_direction(2, cur4, temp4, nxt4, ga, scals[2],
                                       num_local, exact, False)
        temp4, half4 = _solve_direction(1, nxt4, temp4, half4, ga, scals[1],
                                        num_local, exact, False)
        temp4, nxt4 = _solve_direction(0, half4, temp4, nxt4, ga, scals[0],
                                       num_local, exact, True)
    nxt = State3D(*nxt4.unbind(0))
    if compute_error:
        err = stencil.div_error_3d(nxt.u, nxt.v, nxt.w, types,
                                   pa.dx, pa.dy, pa.dz)
    else:
        err = torch.tensor(-1.0, dtype=torch.float32)
    return nxt, err
