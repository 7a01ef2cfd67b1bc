"""2D solver state and grid arrays as tensors on an explicit device.

Port of ``cmcfs_tpu/models/common2d.py``: the per-step mutations of the
reference (UpdateBoundaries / ClearOutterCells / GetLayer,
src/FluidSolver2D/Solver2D.cpp:21-85).  Layouts are the JAX package's:
each field (nx, ny) float32, masks (nx, ny) int8.  ``GridArrays2D`` also
carries the packed int8 masks per sweep axis that the line-sweep kernel
takes: cls + 4*bct + 8*bct, since the 2D solver passes the temperature BC
mask as both BC masks (adi2d.py:113-114).
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..core.types import NodeType
from ..geom.raster2d import Grid2D
from ..ops import masks
from ..ops.sweep_common import pack_masks


class State2D(NamedTuple):
    u: torch.Tensor
    v: torch.Tensor
    T: torch.Tensor


class GridArrays2D(NamedTuple):
    types: torch.Tensor   # (nx, ny) int8
    bct: torch.Tensor     # (nx, ny) int8 (BCtype)
    bc_u: torch.Tensor    # (nx, ny) float32
    bc_v: torch.Tensor
    bc_T: torch.Tensor
    cls_x: torch.Tensor   # line classes, sweep along axis 0
    cls_y: torch.Tensor   # sweep along axis 1
    pk_x: torch.Tensor    # packed masks of cls_x (pack_masks(cls, bct, bct))
    pk_y: torch.Tensor


def host_arrays(grid: Grid2D) -> dict:
    """The grid's arrays and line classes on the host (numpy)."""
    t = grid.cur_types
    return dict(types=t, bct=grid.cur_bct, bc_u=grid.cur_vel[..., 0],
                bc_v=grid.cur_vel[..., 1], bc_T=grid.cur_T,
                cls_x=masks.line_class_2d(t, axis=0),
                cls_y=masks.line_class_2d(t, axis=1))


def _arrays(dev, h: dict) -> GridArrays2D:
    """GridArrays2D from host arrays; ``dev`` moves one array."""
    g = {k: dev(v) for k, v in h.items()}
    return GridArrays2D(**g, pk_x=pack_masks(g["cls_x"], g["bct"], g["bct"]),
                        pk_y=pack_masks(g["cls_y"], g["bct"], g["bct"]))


def upload(host: dict, device) -> GridArrays2D:
    """``host_arrays`` output as GridArrays2D on ``device``."""
    return _arrays(lambda a: torch.tensor(np.ascontiguousarray(a),
                                          device=device), host)


def grid_arrays(grid: Grid2D, device) -> GridArrays2D:
    """Host rasterized grid -> device arrays incl. dense line classes."""
    return upload(host_arrays(grid), device)


def init_state(grid: Grid2D, device) -> State2D:
    """Initial layer from grid data (reference AdiSolver2D::Init, :37-49)."""
    x3 = np.stack([grid.cur_vel[..., 0], grid.cur_vel[..., 1],
                   grid.cur_T]).astype(np.float32)
    return State2D(*torch.tensor(x3, device=device).unbind(0))


def update_boundaries(state: State2D, ga: GridArrays2D) -> State2D:
    """Impose grid BC values on BOUND/VALVE cells (Solver2D.cpp:48-63)."""
    m = (ga.types == NodeType.BOUND) | (ga.types == NodeType.VALVE)
    return State2D(u=torch.where(m, ga.bc_u, state.u),
                   v=torch.where(m, ga.bc_v, state.v),
                   T=torch.where(m, ga.bc_T, state.T))


def clear_outer(state: State2D, ga: GridArrays2D, start_T) -> State2D:
    """Zero velocity / reset T on OUT cells (Solver2D.cpp:75-85)."""
    m = ga.types == NodeType.OUT
    return State2D(u=torch.where(m, 0.0, state.u),
                   v=torch.where(m, 0.0, state.v),
                   T=torch.where(m, float(start_T), state.T))


def get_layer(state: State2D, outdimx: int, outdimy: int):
    """Nearest-neighbour downsample (Solver2D.cpp:21-35); numpy arrays on
    the host, T as float64."""
    u, v, T = (f.detach().cpu().numpy() for f in state)
    dimx, dimy = u.shape
    outdimx = outdimx or dimx
    outdimy = outdimy or dimy
    xi = (np.arange(outdimx) * dimx) // outdimx
    yi = (np.arange(outdimy) * dimy) // outdimy
    sel = np.ix_(xi, yi)
    return u[sel], v[sel], T[sel].astype(np.float64)


def from_jax_numpy(state, ga, pa, device):
    """The JAX package's ``State2D``, ``GridArrays2D`` and ``ParamsArgs``
    (numpy arrays, or anything ``np.asarray`` takes) as the port's, so both
    packages compute on identical inputs.  Returns (state, ga, pa)."""
    from .adi2d import ParamsArgs

    def dev(a):
        return torch.tensor(np.asarray(a), device=device)

    st = State2D(*(dev(f) for f in state))
    g = _arrays(dev, {k: np.asarray(getattr(ga, k)) for k in
                      ("types", "bct", "bc_u", "bc_v", "bc_T", "cls_x",
                       "cls_y")})
    p = ParamsArgs(*(np.float32(np.asarray(x)) for x in pa))
    return st, g, p
