"""3D solver state and grid arrays as tensors on an explicit device.

Port of ``cmcfs_tpu/models/common3d.py``.  Layouts are the JAX package's:
each field (nx, ny, nz) float32, masks (nx, ny, nz) int8.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..core.types import BCtype, MISSING_VALUE, NodeType
from ..geom.grid3d import Grid3D
from ..ops import masks, stencil
from ..ops.masks import INTERIOR
from ..ops.sweep_common import pack_masks


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
    cls_a: tuple            # per-axis line classes (pass A), int8
    cls_b: tuple            # per-axis pass-B classes (None where no duals)
    take_b: tuple           # per-axis bool: the stitch takes pass B here
    pk_a: tuple             # per-axis packed masks of cls_a (pack_masks)
    pk_b: tuple             # ... of cls_b (None where no duals)
    dual_flags: tuple       # per-axis int8 dual | take << 1 (dual_flags)


def _line_classes(types, bcv, bct):
    """Per-axis (cls_a, cls_b, take_b) with inert duals elided
    (common3d.py:42-59): when every dual cell is Dirichlet for velocity AND
    temperature, both roles give the identical identity row, so pass B's
    solve equals pass A's and the pass is dropped."""
    out = []
    for ax in range(3):
        lc = masks.line_class_3d(types, axis=ax)
        cb, tb = lc.cls_b, lc.take_b
        if cb is not None:
            dual = lc.cls_a != cb
            if ((bcv[dual] != BCtype.FREE).all()
                    and (bct[dual] != BCtype.FREE).all()):
                cb = tb = None
        out.append((lc.cls_a, cb, tb))
    return out


def dual_flags(cls_a, cls_b, take_b):
    """The pair kernels' dual plane of one axis, int8 a cell: bit 0 the
    cell takes the BC0 start role in pass B (exactly where cls_b differs
    from cls_a, ops/masks.line_class_3d), bit 1 the stitch takes pass B
    there; None without duals.  The port's counterpart of cmcfs_tpu's
    ``sweep_common.pack_masks_dual`` flags (sweep_common.py:47-70), built
    once a grid: the byte a cell the dual chain reads beyond the dual-free
    pair."""
    if cls_b is None:
        return None
    return ((cls_a != cls_b).to(torch.int8)
            + 2 * take_b.to(torch.int8)).to(torch.int8)


def _assemble(types, bcv, bct, vals, cls_a, cls_b, take_b) -> GridArrays3D:
    """GridArrays3D of tensors on one device; an axis whose ``cls_a`` is
    None has no entries (a shard's arrays for the X direction alone)."""
    return GridArrays3D(
        types=types, bc_vel=bcv, bc_temp=bct, val_u=vals[0], val_v=vals[1],
        val_w=vals[2], val_T=vals[3], cls_a=cls_a, cls_b=cls_b,
        take_b=take_b,
        pk_a=tuple(None if c is None else pack_masks(c, bcv, bct)
                   for c in cls_a),
        pk_b=tuple(None if c is None else pack_masks(c, bcv, bct)
                   for c in cls_b),
        dual_flags=tuple(dual_flags(*abt)
                         for abt in zip(cls_a, cls_b, take_b)))


def _arrays(dev, types, bcv, bct, vals, classes) -> GridArrays3D:
    """Assemble GridArrays3D from host arrays; ``dev`` moves one array."""
    def opt(a):
        return None if a is None else dev(a)

    return _assemble(
        dev(types), dev(bcv), dev(bct), tuple(dev(v) for v in vals),
        tuple(dev(a) for a, _, _ in classes),
        tuple(opt(b) for _, b, _ in classes),
        tuple(None if tb is None else dev(np.asarray(tb, dtype=bool))
              for _, _, tb in classes))


class ShardedGrid(NamedTuple):
    """A grid's arrays split over a ``parallel.mesh.ShardingPlan``: ``x``
    one X slab's GridArrays3D a shard (its planes and a halo plane at both
    X ends), for the Y and Z directions and the step's elementwise work;
    ``y`` the X direction's arrays as Y slabs (X entries only), cut into
    ``y_cuts``; ``shape`` the shape the dispatch decides on (cmcfs_tpu's,
    X padded to a multiple of the shards, ``AdiSolver3D.set_plan``);
    ``duals`` per axis, the whole grid keeps a pass B; ``err_mask`` per
    shard, the cells of the divergence metric it owns; ``count`` their
    number over the grid; ``x0`` per shard, the grid's X index of its
    slab's plane 0 (the halo before its first owned plane), which the
    Stable scheme's red-black colouring reads."""
    x: tuple
    y: tuple
    y_cuts: tuple
    shape: tuple
    duals: tuple
    err_mask: tuple
    count: int
    x0: tuple


def shard_grid(types, bcv, bct, vals, plan, x_cuts, shape) -> ShardedGrid:
    """The arrays of a grid (host arrays; ``vals`` the boundary values of
    u, v, w and T) split over ``plan``, X into ``x_cuts``, Y into
    near-equal runs.  The line classes, the dual pass and the merge masks
    are built once on the whole grid, then sliced: X lines cross the
    shards, so classes built per slab would be wrong, and every shard
    keeps a pass B on an axis where the grid has one, with or without a
    dual in its slab.  The packed masks and dual planes are built per
    cell, so building them from the sliced classes equals slicing them.
    ``shape``: the dispatch's."""
    from ..parallel.mesh import even_cuts
    t, bcv, bct = (np.asarray(a) for a in (types, bcv, bct))
    classes = [(a, b, None if tb is None else np.asarray(tb, dtype=bool))
               for a, b, tb in _line_classes(t, bcv, bct)]
    y_cuts = even_cuts(t.shape[1], plan.n)

    def parts(dim, cuts, axes):
        def split(a):
            return None if a is None else plan.split(a, dim, cuts)

        ty, bv, bt = split(t), split(bcv), split(bct)
        vs = [split(np.asarray(v, dtype=np.float32)) for v in vals]
        ca, cb, tb = ([split(c[k]) if ax in axes and c[k] is not None
                       else None for ax, c in enumerate(classes)]
                      for k in range(3))

        def pick(lists, i):
            return tuple(None if p is None else p[i] for p in lists)

        return tuple(_assemble(ty[i], bv[i], bt[i], pick(vs, i),
                               pick(ca, i), pick(cb, i), pick(tb, i))
                     for i in range(plan.n))

    mask = t == NodeType.IN
    mask[-1, :, :] = False
    mask[:, -1, :] = False
    mask[:, :, -1] = False
    err_mask = plan.split(mask, 0, x_cuts)
    for m in err_mask:
        m[0] = False
        m[-1] = False
    return ShardedGrid(x=parts(0, x_cuts, (0, 1, 2)),
                       y=parts(1, y_cuts, (0,)), y_cuts=tuple(y_cuts),
                       shape=tuple(shape),
                       duals=tuple(b is not None for _, b, _ in classes),
                       err_mask=tuple(err_mask), count=int(mask.sum()),
                       x0=tuple(int(s) - 1 for s in
                                np.cumsum([0] + list(x_cuts[:-1]))))


def exchange_states(plan, states: list) -> None:
    """Fill the X halos of every field of a state held as one State3D a
    shard (``plan.exchange`` field by field, in place)."""
    for f in range(len(states[0])):
        plan.exchange([s[f] for s in states], -3)


def sharded_div_error(slabs: list, sg: ShardedGrid, plan, pa):
    """``stencil.div_error_3d`` of a state held as X slabs (the stacked
    (4, ...) fields a shard): the halos filled, each shard's owned cells
    summed, the sums added on the first shard's device and divided by the
    grid's count (the reduction of the reference's EvalDivError,
    TimeLayer3D.h:595-641).  It equals the single device's up to the
    order of the sums."""
    plan.exchange(slabs, -3)
    dev = plan.devices[0]
    sums = [stencil.div_error_sum_3d(n4[0], n4[1], n4[2], m, pa.dx, pa.dy,
                                     pa.dz).to(dev)
            for n4, m in zip(slabs, sg.err_mask)]
    return torch.stack(sums).sum() / max(sg.count, 1)


def is_bv(g: GridArrays3D) -> torch.Tensor:
    """The BOUND and VALVE cells, which a step re-seeds from ``cur``."""
    return (g.types == NodeType.BOUND) | (g.types == NodeType.VALVE)


def finish_step(nxts: list, ga, pa, compute_error: bool, plan=None):
    """A scheme step's (new_cur, err) from its next layer, one State3D a
    shard: on one device the State3D and ``stencil.div_error_3d``; under
    a plan (``ga`` the ShardedGrid) the stacked slabs and
    ``sharded_div_error``, after each device is synchronized once."""
    if plan is None:
        nxt = nxts[0]
        if not compute_error:
            return nxt, torch.tensor(-1.0, dtype=torch.float32)
        return nxt, stencil.div_error_3d(nxt.u, nxt.v, nxt.w, ga.types,
                                         pa.dx, pa.dy, pa.dz)
    slabs = [torch.stack(tuple(n)) for n in nxts]
    err = (sharded_div_error(slabs, ga, plan, pa) if compute_error
           else torch.tensor(-1.0, dtype=torch.float32))
    plan.synchronize()
    return slabs, err


def update_slabs(slabs: list, sg: ShardedGrid) -> list:
    """``update_boundaries`` of a state held as X slabs, each the stacked
    (4, ...) fields of a shard."""
    out = []
    for x4, g in zip(slabs, sg.x):
        m = is_bv(g)
        out.append(torch.stack([
            torch.where(m, v, f) for v, f in zip(
                (g.val_u, g.val_v, g.val_w, g.val_T), x4)]))
    return out


def grid_arrays(grid: Grid3D, device) -> GridArrays3D:
    t = np.asarray(grid.types)
    bcv = np.asarray(grid.bc_vel)
    bct = np.asarray(grid.bc_temp)

    def dev(a):
        return torch.tensor(np.asarray(a), device=device)

    return _arrays(dev, t, bcv, bct,
                   (grid.vel[..., 0], grid.vel[..., 1], grid.vel[..., 2],
                    grid.T), _line_classes(t, bcv, bct))


def merge_ok(ga: GridArrays3D) -> tuple:
    """Per axis: interior rows coincide exactly with NODE_IN cells, so the
    pair and stream sweeps may merge on their own line classes
    (solver3d.py:47-52)."""
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
    m = is_bv(ga)
    return State3D(
        u=torch.where(m, ga.val_u, state.u),
        v=torch.where(m, ga.val_v, state.v),
        w=torch.where(m, ga.val_w, state.w),
        T=torch.where(m, ga.val_T, state.T),
    )


def get_layer(state: State3D, types: torch.Tensor, outdimx: int, outdimy: int,
              outdimz: int):
    """Clear OUT cells (``types``: the grid's) to MISSING_VALUE + nearest
    downsample (Solver3D.cpp:21-25 + FilterToArrays, TimeLayer3D.h:819-924).
    Returns numpy arrays on the host."""
    out = types.cpu().numpy() == NodeType.OUT
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

    def dev(a):
        return torch.tensor(np.asarray(a), device=device)

    def host(a):
        return None if a is None else np.asarray(a)

    st = State3D(*(dev(f) for f in state))
    g = _arrays(dev, ga.types, ga.bc_vel, ga.bc_temp,
                (ga.val_u, ga.val_v, ga.val_w, ga.val_T),
                [(host(a), host(b), host(t))
                 for a, b, t in zip(ga.cls_a, ga.cls_b, ga.take_b)])
    p = ParamsArgs3D(*(np.float32(np.asarray(x)) for x in pa))
    return st, g, p
