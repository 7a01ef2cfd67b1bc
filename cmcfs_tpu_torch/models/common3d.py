"""3D solver state and grid arrays as tensors on an explicit device.

Port of ``cmcfs_tpu/models/common3d.py``.  Layouts are the JAX package's:
each field (nx, ny, nz) float32, masks (nx, ny, nz) int8.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from cmcfs_tpu.core.types import BCtype, MISSING_VALUE, NodeType
from cmcfs_tpu.geom.grid3d import Grid3D
from cmcfs_tpu.ops import masks
from cmcfs_tpu.ops.masks import INTERIOR


class State3D(NamedTuple):
    u: torch.Tensor
    v: torch.Tensor
    w: torch.Tensor
    T: torch.Tensor


class GridArrays3D(NamedTuple):
    types: torch.Tensor     # (nx, ny, nz) int8
    bc_vel: torch.Tensor    # int8
    bc_temp: torch.Tensor   # int8
    val_u: torch.Tensor     # boundary values per variable, float32
    val_v: torch.Tensor
    val_w: torch.Tensor
    val_T: torch.Tensor
    cls_a: tuple            # per-axis line classes, int8


def _dual_free_classes(types, bcv, bct):
    """Per-axis line classes with inert duals elided (common3d.py:42-59):
    a dual cell whose velocity and temperature BCs are both Dirichlet gives
    pass B the same rows as pass A, so pass B is dropped.  Surviving FREE
    duals need the pair kernel's second elimination chain, not ported."""
    out = []
    for ax in range(3):
        lc = masks.line_class_3d(types, axis=ax)
        if lc.cls_b is not None:
            dual = lc.cls_a != lc.cls_b
            if ((bcv[dual] == BCtype.FREE).any()
                    or (bct[dual] == BCtype.FREE).any()):
                raise NotImplementedError(
                    f"axis {ax} has dual-endpoint cells with a FREE boundary "
                    "condition; the dual second chain of the pair sweep is "
                    "not ported (ROADMAP B1 step 3)")
        out.append(lc.cls_a)
    return out


def grid_arrays(grid: Grid3D, device) -> GridArrays3D:
    t = np.asarray(grid.types)
    bcv = np.asarray(grid.bc_vel)
    bct = np.asarray(grid.bc_temp)
    cls = _dual_free_classes(t, bcv, bct)

    def dev(a):
        return torch.tensor(np.asarray(a), device=device)

    return GridArrays3D(
        types=dev(t), bc_vel=dev(bcv), bc_temp=dev(bct),
        val_u=dev(grid.vel[..., 0]), val_v=dev(grid.vel[..., 1]),
        val_w=dev(grid.vel[..., 2]), val_T=dev(grid.T),
        cls_a=tuple(dev(c) for c in cls))


def merge_ok(ga: GridArrays3D) -> tuple:
    """Per axis: interior rows coincide exactly with NODE_IN cells, so the
    pair sweep may merge on its own line classes (solver3d.py:47-52)."""
    is_in = ga.types == NodeType.IN
    return tuple(bool(torch.equal(c == INTERIOR, is_in)) for c in ga.cls_a)


def init_state(grid: Grid3D, device) -> State3D:
    """CopyFromGrid for all cells (reference TimeLayer3D.h:734-781).  The
    four fields are views of one stacked (4, nx, ny, nz) buffer."""
    x4 = np.stack([grid.vel[..., 0], grid.vel[..., 1], grid.vel[..., 2],
                   grid.T]).astype(np.float32)
    return State3D(*torch.tensor(x4, device=device).unbind(0))


def update_boundaries(state: State3D, ga: GridArrays3D) -> State3D:
    """Impose grid values on BOUND/VALVE cells (AdiSolver3D.cpp:286-304)."""
    m = (ga.types == NodeType.BOUND) | (ga.types == NodeType.VALVE)
    return State3D(
        u=torch.where(m, ga.val_u, state.u),
        v=torch.where(m, ga.val_v, state.v),
        w=torch.where(m, ga.val_w, state.w),
        T=torch.where(m, ga.val_T, state.T),
    )


def get_layer(state: State3D, ga: GridArrays3D, outdimx: int, outdimy: int,
              outdimz: int):
    """Clear OUT cells to MISSING_VALUE + nearest downsample
    (Solver3D.cpp:21-25 + FilterToArrays, TimeLayer3D.h:819-924).  Returns
    numpy arrays on the host."""
    out = ga.types.cpu().numpy() == NodeType.OUT
    arrs = []
    for f in state:
        a = f.detach().cpu().numpy().copy()
        a[out] = MISSING_VALUE
        arrs.append(a)
    u, v, w, T = arrs
    nx, ny, nz = u.shape
    outdimx = outdimx or nx
    outdimy = outdimy or ny
    outdimz = outdimz or nz
    xi = (np.arange(outdimx) * nx) // outdimx
    yi = (np.arange(outdimy) * ny) // outdimy
    zi = (np.arange(outdimz) * nz) // outdimz
    sel = np.ix_(xi, yi, zi)
    return u[sel], v[sel], w[sel], T[sel].astype(np.float64)


def from_jax_numpy(state, ga, pa, device):
    """The JAX package's ``State3D``, ``GridArrays3D`` and ``ParamsArgs3D``
    (numpy arrays, or anything ``np.asarray`` takes) as the port's, so both
    packages compute on identical inputs.  Returns (state, ga, pa)."""
    from .adi3d import ParamsArgs3D
    if any(c is not None for c in ga.cls_b):
        raise NotImplementedError(
            "grid arrays carry a dual pass B; the dual second chain of the "
            "pair sweep is not ported (ROADMAP B1 step 3)")

    def dev(a):
        return torch.tensor(np.asarray(a), device=device)

    st = State3D(*(dev(f) for f in state))
    g = GridArrays3D(
        types=dev(ga.types), bc_vel=dev(ga.bc_vel), bc_temp=dev(ga.bc_temp),
        val_u=dev(ga.val_u), val_v=dev(ga.val_v), val_w=dev(ga.val_w),
        val_T=dev(ga.val_T), cls_a=tuple(dev(c) for c in ga.cls_a))
    p = ParamsArgs3D(*(np.float32(np.asarray(x)) for x in pa))
    return st, g, p
