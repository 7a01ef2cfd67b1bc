"""3D ADI time step (port of cmcfs_tpu/models/adi3d.py).

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

Under a ``plan`` (``parallel/mesh.py``) X splits over the plan's shards,
as cmcfs_tpu's mesh splits it, and the dispatch applies cmcfs_tpu's rules
for a mesh: X and Y pad to lcm(tile, N) in ``_step_pad``, X with an odd
num_local and X's stream path go to the fallback, ``pallas`` runs as
``scan``.  Each path runs its kernels once a shard.

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
import math
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
from ..parallel.pipeline import pipelined_tridiag_x_blocked
from .common3d import GridArrays3D, State3D, is_bv, sharded_div_error

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


def resolve_backend(backend: str, plan=None) -> str:
    """``auto`` means ``fused_nl``: the card's default, as the TPU's (under
    a plan too: cmcfs_tpu resolves it so on its target, the TPU).  Under
    a plan ``pallas`` runs as ``scan`` (cmcfs_tpu adi3d.py:1680-1682)."""
    backend = "fused_nl" if backend == "auto" else backend
    if plan is not None and backend == "pallas":
        backend = "scan"
    if backend in BACKENDS:
        return backend
    raise KeyError(f"unknown backend {backend!r}")


def _step_pad(shape3: tuple, backend: str, plan=None):
    """cmcfs_tpu's step-level tile padding decision (adi3d.py:716-743):
    the (px, py, pz) pads to (8, 128, 128) multiples when they grow the
    grid by at most 25 %, else None; None for the row backends (scan,
    pallas, pcr), as cmcfs_tpu pads only its fused list.  Under a plan of
    N shards X and Y pad to lcm(tile, N) multiples."""
    if backend not in FUSED:
        return None
    tiles = _STEP_TILES
    if plan is not None:
        tiles = (math.lcm(tiles[0], plan.n), math.lcm(tiles[1], plan.n),
                 tiles[2])
    tgt = tuple(-n % t for n, t in zip(shape3, tiles))
    grow = np.prod([n + p for n, p in zip(shape3, tgt)]) / max(
        int(np.prod(shape3)), 1)
    return tgt if any(tgt) and grow <= 1.25 else None


def _nl_pair_active(axis: int, n_sweep: int, backend: str,
                    merge_ok_ax: bool, dual_free: bool, num_local: int,
                    plan=None) -> bool:
    """Does this direction run the pair sweep (adi3d.py:459-479)?  Under a
    plan, X with an odd num_local does not: its trailing iteration would
    need the stream sweep, which cmcfs_tpu does not run on resharded X
    lines."""
    if backend not in PAIR_BACKENDS or num_local < 2:
        return False
    if plan is not None and axis == 0 and num_local % 2 != 0:
        return False
    if not dual_free and num_local % 2 != 0:
        return False
    return merge_ok_ax and n_sweep <= MAX_SWEEP


def _dir_path(axis: int, n_sweep: int, backend: str, merge_ok_ax: bool,
              dual_free: bool, num_local: int, plan=None) -> str:
    """cmcfs_tpu's _dir_path (adi3d.py:482-507); under a plan X never
    streams."""
    if backend not in ("fused_full",) + PAIR_BACKENDS or n_sweep > MAX_SWEEP:
        return "fallback"
    if _nl_pair_active(axis, n_sweep, backend, merge_ok_ax, dual_free,
                       num_local, plan):
        return "pair" if num_local % 2 == 0 else "pair+stream"
    if merge_ok_ax and dual_free and (plan is None or axis != 0):
        return "stream"
    return "fallback"


def dispatch_report(shape3: tuple, duals: tuple, backend: str,
                    num_local: int,
                    merge_ok: tuple = (False, False, False),
                    plan=None) -> dict:
    """Which implementation each direction runs, decided as cmcfs_tpu's
    dispatch_report decides it (adi3d.py:746-793):
    {"backend", "pad", "pcr", "bf16", "dirs"}, dirs {"X"|"Y"|"Z": "pair"|
    "pair+stream"|"stream"|"fallback"}; ``pcr``: the pair directions
    reduce cyclically (``fused_pcr``, ``fused_pcr_bf16``); ``bf16``: the
    kernels' payloads are stored in bf16 (``fused_bf16``,
    ``fused_pcr_bf16``).  ``duals``: per axis, the grid keeps a dual pass
    B (``GridArrays3D.cls_b``); ``plan``: the X split over devices
    (``parallel.mesh.ShardingPlan``), None on one device."""
    backend = resolve_backend(backend, plan)
    pad = _step_pad(tuple(shape3), backend, plan)
    pshape = (tuple(n + p for n, p in zip(shape3, pad)) if pad
              else tuple(shape3))
    dirs = {name: _dir_path(ax, pshape[ax], backend, merge_ok[ax],
                            not duals[ax], num_local, plan)
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
    build_abc's 3D rows); advection divides by 2h, correctly rounded on
    every device (``stencil.over``), as cmcfs_tpu's rows do.  u, v and w
    share theirs."""
    h = (pa.dx, pa.dy, pa.dz)[axis]
    vis = scal[1] if vi == 3 else scal[0]
    free = (ga.bc_temp if vi == 3 else ga.bc_vel) == BCtype.FREE
    return build_abc(cls, free, stencil.over(adv, _F(2.0) * h), vis,
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


def _wavefront_solve(plan, pa, scal, exact):
    """The X solve of a fallback X direction under a plan with ``nblockz``
    > 1: the Z-blocked wavefront (cmcfs_tpu adi3d.py:339-358, 373-378), a
    ``solve`` for ``_solve_direction``.  Each X slab builds the row path's
    rows (``fallback_rhs``, ``fold_d``, ``row_coeffs``: float32 for every
    backend, no bf16 cast) on its owned planes from ``temp``, whose halos
    the direction fills first; the pipeline (``parallel/pipeline.py``)
    solves the X lines across the shards, u, v and w on their shared rows
    and T, pass A and, where the grid has duals, pass B, stitched by
    ``take_b``.  A slab's halo planes of x are those of ``out``, so that
    the update leaves them as they were until the next exchange."""
    own = slice(1, -1)

    def solve(rhs, temp, out, gas):
        built = [fallback_rhs(0, r.float(), t, g, pa, scal[2])
                 for r, t, g in zip(rhs, temp, gas)]

        def solve_cls(cls_of):
            """x of every slab's owned planes on the classes ``cls_of(g)``."""
            rows = []
            for (d, d_bc), t, g in zip(built, temp, gas):
                cls = cls_of(g)
                dk = fold_d(d, d_bc, cls)[:, own]
                rows.append([tuple(m[own] for m in row_coeffs(
                    0, t[0], cls, g, pa, scal, vi)) + (dv,)
                    for vi, dv in ((0, dk[:3]), (3, dk[3:]))])
            return [torch.cat(xs) for xs in pipelined_tridiag_x_blocked(
                rows, plan, plan.nblockz, exact)]

        xs = solve_cls(lambda g: g.cls_a[0])
        if gas[0].cls_b[0] is not None:
            xs = [torch.where(g.take_b[0][own], xb, x) for x, xb, g in zip(
                xs, solve_cls(lambda g: g.cls_b[0]), gas)]
        return [torch.cat((o[:, :1].float(), x, o[:, -1:].float()), 1)
                for x, o in zip(xs, out)]

    return solve


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


def _solve_direction(axis, path, rhs, temp, out, gas, pa, scal, num_local,
                     exact, gmerge, backend, sync=None, solve=None):
    """SolveDirection (adi3d.py:1516-1566) on the chosen path.  ``rhs``,
    ``temp``, ``out`` and ``gas`` are lists, one entry a shard (one entry
    on a single device); returns the lists (temp, out).  ``sync(*lists)``
    fills the shards' halos of each list before a kernel call reads them
    (None on a single device): the three fields before each pair, whose
    halo lines each shard solves again so that the pair's second
    iteration reads exact neighbours (cmcfs_tpu adi3d.py:590-603), and
    ``temp``, which the stencils read across the split, before each
    iteration of the other paths.  ``solve(rhs, temp, out, gas)`` gives
    the fallback's x of every shard (None: ``_build_and_solve`` on each,
    its lines within the shard; the wavefront's lines cross the shards,
    ``_wavefront_solve``)."""
    temp, out = list(temp), list(out)
    shards = range(len(temp))
    if path == "fallback":
        # UpdateSegment writes every segment cell incl. the BC endpoints
        # (AdiSolver3D.cpp:707-730); identity rows keep their values
        written = [g.cls_a[axis] != 0 for g in gas]
        is_in = [g.types == NodeType.IN for g in gas]
        for _ in range(num_local):
            if sync:
                sync(temp)
            # one shard's x alive at a time where each solves its own
            xs = (solve(rhs, temp, out, gas) if solve else
                  (_build_and_solve(axis, rhs[i], temp[i], gas[i], pa, scal,
                                    exact, backend) for i in shards))
            for i, x in zip(shards, xs):
                out[i] = torch.where(written[i], x, out[i])
                temp[i] = torch.where(is_in[i], (temp[i] + out[i]) / 2.0,
                                      temp[i])
        return temp, out
    n_left = num_local
    bf16 = backend in BF16_BACKENDS
    if path in ("pair", "pair+stream"):
        sweep = pcr_sweep if backend in PCR_BACKENDS else pair_sweep
        pay = _payload(bf16)
        rhs_p = [pay(r) for r in rhs]
        pairs = num_local // 2
        for k in range(pairs):
            if sync:
                sync(temp, rhs_p, out)
            for i in shards:
                g = gas[i]
                out[i], tn = sweep(temp[i], g.cls_a[axis], g.bc_vel,
                                   g.bc_temp, rhs_p[i], pay(out[i]), scal,
                                   axis, exact, gmerge and k == pairs - 1,
                                   g.dual_flags[axis])
                temp[i] = tn.float()
        n_left = num_local % 2
    for _ in range(n_left):
        if sync:
            sync(temp)
        for i in shards:
            temp[i], out[i] = _stream_iteration(axis, rhs[i], temp[i],
                                                out[i], gas[i], pa, scal,
                                                exact, bf16)
    return temp, out


def _plan_sync(plan, dim):
    """A ``sync`` for ``_solve_direction``: fills the halos of each list
    of slabs along ``dim`` (``plan.exchange``)."""
    def sync(*fields):
        for f in fields:
            plan.exchange(f, dim)
    return sync


def x_direction(path, rhs4, temp4, out4, ga, pa, scal, num_local: int,
                exact: bool, gmerge: bool, backend: str, plan=None):
    """The X direction on ``path`` (lists of (4, ...) fields, one entry a
    shard; ``ga`` the GridArrays3D, or under a plan the ShardedGrid):
    returns the lists (temp, out).  On one device it runs as Y and Z do.
    Under a plan whose ``nblockz`` > 1 a fallback X stays on the X slabs
    and solves its lines across them through the wavefront
    (``_wavefront_solve``); otherwise the X lines, which cross the
    shards, are resharded so that Y splits (cmcfs_tpu adi3d.py:604-628),
    solved on the Y slabs and resharded back."""
    if plan is None:
        return _solve_direction(0, path, rhs4, temp4, out4, [ga], pa, scal,
                                num_local, exact, gmerge, backend)
    if path == "fallback" and plan.nblockz > 1:
        return _solve_direction(0, path, rhs4, temp4, out4, list(ga.x), pa,
                                scal, num_local, exact, gmerge, backend,
                                _plan_sync(plan, -3),
                                _wavefront_solve(plan, pa, scal, exact))
    x_cuts = [t.shape[-3] - 2 for t in temp4]
    ty, ry, oy = (plan.reshard(f, -3, -2, ga.y_cuts)
                  for f in (temp4, rhs4, out4))
    ty, oy = _solve_direction(0, path, ry, ty, oy, list(ga.y), pa, scal,
                              num_local, exact, gmerge, backend,
                              _plan_sync(plan, -2))
    return tuple(plan.reshard(f, -2, -3, x_cuts) for f in (ty, oy))


def _step_paths(ga, backend: str, num_local: int, merge_ok: tuple,
                plan=None) -> list:
    """The path of each axis (0, 1, 2) for this grid (a GridArrays3D, or
    under a plan its ShardedGrid)."""
    if plan is None:
        shape = tuple(ga.types.shape)
        duals = tuple(c is not None for c in ga.cls_b)
    else:
        shape, duals = ga.shape, ga.duals
    rep = dispatch_report(shape, duals, backend, num_local, merge_ok, plan)
    return [rep["dirs"][name] for _, name in _AXES]


def _no_section(name):
    return contextlib.nullcontext()


def adi_timestep_3d(cur, nxt_prev, ga, dt, num_global: int, num_local: int,
                    pa: ParamsArgs3D, backend: str = "auto",
                    exact: bool = True, compute_error: bool = True,
                    merge_ok: tuple = (False, False, False),
                    section=_no_section, plan=None):
    """One reference TimeStep (AdiSolver3D.cpp:306-391).

    Returns (new_cur, err); ``err`` is a 0-d float32 tensor, or -1.0 when
    ``compute_error`` is False.  ``nxt_prev`` is the persistent next layer;
    only its BOUND/VALVE cells are re-seeded from ``cur``.  ``section(name)``
    gives a context for each part of the step, under the reference's event
    names (``adi_timestep_3d_profiled``).

    ``plan`` (``parallel.mesh.ShardingPlan``) splits X over its shards:
    ``cur`` and ``nxt_prev`` are then the plan's X slabs of the stacked
    (4, nx, ny, nz) state, ``ga`` the grid's ``common3d.ShardedGrid``, and
    the new state comes back as such slabs (their halos not filled).  The
    Y and Z directions run on each slab, its halos filled from the
    neighbours before each kernel call (``_solve_direction``); X reshards
    the fields to Y slabs, runs on them and reshards back, or runs the
    wavefront on the X slabs (``x_direction``).  The halos
    wrap at the grid's ends as the single device's stencils do, so every
    owned cell reads what it reads on one device, and the new state
    equals the single device's bit for bit.  The error sums
    each shard's owned cells, then divides by the grid's count (the
    reduction of the reference's EvalDivError, TimeLayer3D.h:595-641): it
    equals the single device's up to the order of the sums.  The step
    synchronizes each device of the plan once, at its end."""
    backend = resolve_backend(backend, plan)
    paths = _step_paths(ga, backend, num_local, merge_ok, plan)
    # the global MergeLayer folds into X's final pair (adi3d.py:1727-1745)
    gfold = paths[0] == "pair"
    scals = [_nl_scal(ax, pa, dt) for ax in range(3)]
    if plan is None:
        gas, sync = [ga], None
    else:
        gas, sync = list(ga.x), _plan_sync(plan, -3)
    is_in = [g.types == NodeType.IN for g in gas]
    with section("CopyLayer"):
        if plan is None:
            cur4 = [torch.stack(tuple(cur))]
            nxt4 = [torch.stack(tuple(nxt_prev))]
        else:
            cur4, nxt4 = list(cur), list(nxt_prev)
        nxt4 = [torch.where(is_bv(g), c, n)
                for g, c, n in zip(gas, cur4, nxt4)]
    temp4 = cur4
    half4 = [torch.zeros_like(c) for c in cur4]

    def direction(axis, rhs4, temp4, out4):
        return _solve_direction(axis, paths[axis], rhs4, temp4, out4, gas,
                                pa, scals[axis], num_local, exact, False,
                                backend, sync)

    # the bf16 backends' Z rhs, rounded once a step for the kernels
    rhs_z = ([c.bfloat16() for c in cur4] if backend in BF16_BACKENDS
             and paths[2] != "fallback" else cur4)
    for _ in range(num_global):
        with section("SolveSegments_Z"):
            temp4, nxt4 = direction(2, rhs_z, temp4, nxt4)
        with section("SolveSegments_Y"):
            temp4, half4 = direction(1, nxt4, temp4, half4)
        with section("SolveSegments_X"):
            temp4, nxt4 = x_direction(paths[0], half4, temp4, nxt4, ga, pa,
                                      scals[0], num_local, exact, gfold,
                                      backend, plan)
        with section("MergeLayer"):
            if not gfold:
                temp4 = [torch.where(m, (t + n) / 2.0, t)
                         for m, t, n in zip(is_in, temp4, nxt4)]
    nxt4 = [n.float() for n in nxt4]
    with section("EvalDivError"):
        if not compute_error:
            err = torch.tensor(-1.0, dtype=torch.float32)
        elif plan is None:
            n4 = nxt4[0]
            err = stencil.div_error_3d(n4[0], n4[1], n4[2], ga.types,
                                       pa.dx, pa.dy, pa.dz)
        else:
            err = sharded_div_error(nxt4, ga, plan, pa)
    if plan is None:
        return State3D(*nxt4[0].unbind(0)), err
    plan.synchronize()
    return nxt4, err


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
