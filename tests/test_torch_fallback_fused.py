"""The dual-free fallback iteration in one launch
(``ops/line_sweep.fallback_iteration``, ``line_sweep.cuh``'s FallbackRows)
and its routing in ``models/adi3d._solve_direction``.

CPU (the plain version, ``fallback_iteration_ref``):

* it equals the composition the fallback ran before it, bit for bit:
  ``adi3d.fallback_rhs`` -> ``adi3d.fold_d`` -> ``line_sweep_ref`` ->
  UpdateSegment's and the NODE_IN merge's ``where``s, on every axis, in
  both ``exact`` modes, on three grids: the lid cavity (walls all round);
  the cavity with FREE velocity and FREE temperature walls and an IN run
  open to a face of the array (IN cells that are not interior rows, so
  ``merge_ok`` is False); and a duct open along X, whose Y and Z lines on
  the X faces have interior rows, so the cross-line derivatives wrap;
* the routing, on counters of the two paths: dual-free fallback axes of
  ``fused_nl`` and ``fused_dma`` (one device, and X split over two CPU
  shards) take the fused iteration; the baffle's dual X, ``fused_bf16``,
  ``scan`` and the wavefront X (``blocking``) keep the composition; and
  each step equals, bit for bit, the step whose fallback runs the
  composition everywhere (the code before the fused iteration);
* the wrapper's checks.

On the card (marked ``gpu``, skipped without a CUDA device; this half
imports no JAX): the launch against ``fallback_iteration_ref`` bit for bit
on the three grids and on ragged tiles, and at 383^3 on every axis in both
modes (the size whose lines send every direction to the fallback):

    python -m pytest -m gpu tests/test_torch_fallback_fused.py
"""
import numpy as np
import pytest
import torch

from cmcfs_tpu_torch.core.params import FluidParams
from cmcfs_tpu_torch.core.types import BCtype, NodeType
from cmcfs_tpu_torch.geom.baffle import free_baffled
from cmcfs_tpu_torch.geom.synthetic import lid_cavity_3d
from cmcfs_tpu_torch.models import adi3d
from cmcfs_tpu_torch.models.common3d import (grid_arrays, init_state,
                                             merge_ok, update_boundaries)
from cmcfs_tpu_torch.models.solver3d import AdiSolver3D
from cmcfs_tpu_torch.ops import line_sweep as ls
from cmcfs_tpu_torch.parallel.mesh import make_x_mesh

PARAMS = FluidParams.normalized(200.0, 0.72, 1.4)
DT = 0.01


def _free_open():
    """The lid cavity with a FREE-velocity wall (y = 1), a FREE-temperature
    wall (z = 1) and a hole in the high X wall that opens an IN run onto
    the array's last X plane (those IN cells are no interior rows)."""
    g = lid_cavity_3d(13, 11, 10)
    g.bc_vel[:, 1, :] = BCtype.FREE
    g.bc_temp[:, :, 1] = BCtype.FREE
    g.types[-2:, 4:7, 4:7] = NodeType.IN
    return g


def _duct():
    """A duct open along X: IN cells on both X faces of the array, so the
    Y and Z lines there have interior rows whose X neighbours wrap."""
    g = lid_cavity_3d(9, 12, 11)
    g.types[:, 1:-1, 1:-1] = NodeType.BOUND
    g.types[:, 2:-2, 2:-2] = NodeType.IN
    g.types[:, 2:-2, -2] = NodeType.VALVE
    return g


GRIDS = {"lid": lambda: lid_cavity_3d(12, 11, 10), "free_open": _free_open,
         "duct": _duct}


def _case(grid, device, seed):
    """(ga, pa, temp4, rhs4, out4): noisy fields, BOUND and VALVE cells at
    their grid values."""
    ga = grid_arrays(grid, device)
    pa = adi3d.make_params(PARAMS, grid.dx, grid.dy, grid.dz)
    base = torch.stack(tuple(update_boundaries(init_state(grid, device), ga)))
    rng = np.random.default_rng(seed)
    is_in = ga.types == NodeType.IN

    def noisy():
        n = torch.tensor(rng.standard_normal(tuple(base.shape)),
                         dtype=torch.float32, device=device)
        return torch.where(is_in, base + 0.1 * n, base)

    return ga, pa, noisy(), noisy(), noisy()


def _args(ga, pa, temp4, rhs4, out4, axis, exact):
    scal = adi3d._nl_scal(axis, pa, DT)
    return (temp4, rhs4, out4, ga.types, ga.pk_a[axis],
            (ga.val_u, ga.val_v, ga.val_w, ga.val_T), scal[:6],
            (pa.dx, pa.dy, pa.dz), axis, exact)


def _composition(ga, pa, temp4, rhs4, out4, axis, exact):
    """The fallback iteration as models/adi3d ran it before the fused
    launch (and still runs it on the paths that keep it)."""
    scal = adi3d._nl_scal(axis, pa, DT)
    d, d_bc = adi3d.fallback_rhs(axis, rhs4, temp4, ga, pa, scal[2])
    x = ls.line_sweep_ref(temp4[axis], ga.pk_a[axis],
                          adi3d.fold_d(d, d_bc, ga.cls_a[axis]), scal[:4],
                          axis, exact)
    out = torch.where(ga.cls_a[axis] != 0, x, out4)
    tn = torch.where(ga.types == NodeType.IN, (temp4 + out) / 2.0, temp4)
    return out, tn


def _bitwise(a, b):
    return a.dtype == b.dtype and torch.equal(a, b)


@pytest.mark.parametrize("grid", sorted(GRIDS))
@pytest.mark.parametrize("exact", [True, False])
@pytest.mark.parametrize("axis", [0, 1, 2])
def test_ref_equals_composition(axis, exact, grid):
    g = GRIDS[grid]()
    ga, pa, temp4, rhs4, out4 = _case(g, "cpu", seed=axis + 3 * exact)
    got = ls.fallback_iteration(*_args(ga, pa, temp4, rhs4, out4, axis,
                                       exact))
    want = _composition(ga, pa, temp4, rhs4, out4, axis, exact)
    assert all(_bitwise(a, b) for a, b in zip(got, want))
    # the iteration did real work: rows solved (the duct's X lines have
    # none: their runs reach both ends of the array) and IN cells merged
    assert torch.equal(got[0], out4) == (grid == "duct" and axis == 0)
    assert not torch.equal(got[1], temp4)


def test_grids_take_the_cases_they_are_named_for():
    """free_open has IN cells that are no interior rows and FREE rows of
    both kinds; the duct has interior rows on the array's X faces; no grid
    has a pass B."""
    ga = grid_arrays(_free_open(), "cpu")
    assert merge_ok(ga) == (False, True, True)
    assert bool((ga.bc_vel == BCtype.FREE).any())
    assert bool((ga.bc_temp == BCtype.FREE).any())
    gd = grid_arrays(_duct(), "cpu")
    for axis in (1, 2):
        assert bool((gd.cls_a[axis][0] == 3).any())
        assert bool((gd.cls_a[axis][-1] == 3).any())
    for grid in GRIDS.values():
        assert all(c is None for c in grid_arrays(grid(), "cpu").cls_b)


def _parent_solve_direction(orig):
    """``_solve_direction`` whose fallback runs the composition on every
    axis (the code before the fused iteration); other paths as ``orig``."""
    def solve_direction(axis, path, rhs, temp, out, gas, pa, scal, num_local,
                        exact, gmerge, backend, sync=None, solve=None):
        if path != "fallback" or solve is not None:
            return orig(axis, path, rhs, temp, out, gas, pa, scal, num_local,
                        exact, gmerge, backend, sync, solve)
        temp, out = list(temp), list(out)
        written = [g.cls_a[axis] != 0 for g in gas]
        is_in = [g.types == NodeType.IN for g in gas]
        for _ in range(num_local):
            if sync:
                sync(temp)
            for i, g in enumerate(gas):
                x = adi3d._build_and_solve(axis, rhs[i], temp[i], g, pa,
                                           scal, exact, backend)
                out[i] = torch.where(written[i], x, out[i])
                temp[i] = torch.where(is_in[i], (temp[i] + out[i]) / 2.0,
                                      temp[i])
        return temp, out

    return solve_direction


# grid, backend, shards, nblockz; then a step's (ng 2, nl 2) fused
# iterations by axis, one a shard, and the composition's right-hand sides
# (``fallback_rhs`` calls: one an iteration and shard, or X slab)
ROUTES = {
    "fused_nl": ("free_open", "fused_nl", 1, 0, (4, 4, 4), 0),
    "fused_dma": ("lid", "fused_dma", 1, 0, (4, 4, 4), 0),
    "fused_dma_2_shards": ("lid", "fused_dma", 2, 0, (8, 8, 8), 0),
    "baffle_dual_x": ("baffle", "fused_dma", 1, 0, (0, 4, 4), 4),
    "fused_bf16": ("free_open", "fused_bf16", 1, 0, (0, 0, 0), 12),
    "scan": ("lid", "scan", 1, 0, (0, 0, 0), 12),
    "wavefront_x": ("lid", "fused_dma", 2, 2, (0, 8, 8), 8),
}


def _step(grid, backend, shards, nblockz, monkeypatch, parent=False):
    """One step (ng 2, nl 2) from the grid's state with noise on its IN
    cells, every axis on the fallback (merge_ok all False); (the new
    state, the error, the fused iterations by axis, the composition's
    right-hand sides)."""
    fused, glue = [0, 0, 0], [0]
    fi, rhs = adi3d.fallback_iteration, adi3d.fallback_rhs

    def counted_fi(*args):
        fused[args[8]] += 1
        return fi(*args)

    def counted_rhs(*args):
        glue[0] += 1
        return rhs(*args)

    monkeypatch.setattr(adi3d, "fallback_iteration", counted_fi)
    monkeypatch.setattr(adi3d, "fallback_rhs", counted_rhs)
    if parent:
        monkeypatch.setattr(adi3d, "_solve_direction",
                            _parent_solve_direction(adi3d._solve_direction))
    s = AdiSolver3D(backend=backend, device="cpu")
    s.init(grid, PARAMS)
    s.merge_ok = (False, False, False)
    cur = torch.stack(tuple(s.cur))
    noise = torch.tensor(np.random.default_rng(5).standard_normal(
        tuple(cur.shape)), dtype=torch.float32)
    cur = torch.where(s.ga.types == NodeType.IN, cur + 0.001 * noise, cur)
    s.set_state(tuple(cur), tuple(cur))
    if shards > 1:
        s.set_plan(make_x_mesh(devices=["cpu"] * shards), nblockz=nblockz)
    s.time_step(DT, 2, 2)
    monkeypatch.undo()
    return (torch.stack(tuple(s.state()[0])), s.last_err, tuple(fused),
            glue[0])


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_routing_and_step_bitwise(route, monkeypatch):
    name, backend, shards, nblockz, want, want_glue = ROUTES[route]
    grid = {"baffle": lambda: free_baffled(16, 14, 12), **GRIDS}[name]()
    x, err, fused, glue = _step(grid, backend, shards, nblockz, monkeypatch)
    assert (fused, glue) == (want, want_glue)
    x_p, err_p, fused_p, glue_p = _step(grid, backend, shards, nblockz,
                                        monkeypatch, parent=True)
    assert fused_p == (0, 0, 0) and glue_p == 12 * shards
    assert _bitwise(x, x_p)
    assert err == err_p


def test_step_routes_by_its_own_inputs():
    """The fused path is chosen by backend, pass B and the wavefront
    alone: the dispatch still reports ``fallback``."""
    ga = grid_arrays(_free_open(), "cpu")
    rep = adi3d.dispatch_report(tuple(ga.types.shape),
                                (False, False, False), "fused_nl", 2)
    assert set(rep["dirs"].values()) == {"fallback"}


@pytest.mark.parametrize("bad, err", [
    ("dtype", TypeError), ("shape", ValueError), ("contiguous", ValueError),
    ("axis", ValueError), ("scal", ValueError), ("vals", ValueError)])
def test_wrapper_checks(bad, err):
    ga, pa, temp4, rhs4, out4 = _case(GRIDS["lid"](), "cpu", seed=9)
    args = list(_args(ga, pa, temp4, rhs4, out4, 0, True))
    if bad == "dtype":
        args[1] = rhs4.double()
    elif bad == "shape":
        args[2] = out4[:, 1:]
    elif bad == "contiguous":
        args[0] = temp4.transpose(2, 3).contiguous().transpose(2, 3)
    elif bad == "axis":
        args[8] = 3
    elif bad == "scal":
        args[6] = args[6][:4]
    else:
        args[5] = args[5][:3]
    with pytest.raises(err):
        ls.fallback_iteration(*args)


# ----------------------------------------------------------- on the card
def _on_card_bitwise(ga, pa, temp4, rhs4, out4, axis, exact):
    args = _args(ga, pa, temp4, rhs4, out4, axis, exact)
    before = ls.fused_launches.count
    got = ls.fallback_iteration(*args)
    assert ls.fused_launches.count == before + 1
    want = ls.fallback_iteration_ref(*args)
    torch.cuda.synchronize()
    assert all(_bitwise(a, b) for a, b in zip(got, want))


@pytest.mark.gpu
@pytest.mark.parametrize("grid", sorted(GRIDS))
@pytest.mark.parametrize("exact", [True, False])
@pytest.mark.parametrize("axis", [0, 1, 2])
def test_fused_launch_bitwise(axis, exact, grid):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    _on_card_bitwise(*_case(GRIDS[grid](), "cuda", seed=axis + 3 * exact),
                     axis, exact)


@pytest.mark.gpu
@pytest.mark.parametrize("exact", [True, False])
@pytest.mark.parametrize("shape", [(70, 9, 150), (5, 70, 100), (37, 6, 70),
                                   (3, 130, 5)])
def test_fused_launch_tile_edges_bitwise(shape, exact):
    """Ragged chunks and blocks on every axis: lines of 70-150 rows, 5 to
    150 lines along the block's axis (X/Y tile 128 x 2, Z 64 x 8)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    g = lid_cavity_3d(*shape)
    g.types[:, 2:-2, 2:-2] = NodeType.IN
    g.bc_temp[:, 1, :] = BCtype.FREE
    case = _case(g, "cuda", seed=sum(shape))
    for axis in range(3):
        _on_card_bitwise(*case, axis, exact)


@pytest.mark.gpu
@pytest.mark.parametrize("exact", [True, False])
@pytest.mark.parametrize("axis", [0, 1, 2])
def test_fused_launch_383_bitwise(axis, exact):
    """The size whose 383-cell lines send every direction to the fallback
    (the lid cavity, noisy)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    _on_card_bitwise(*_case(lid_cavity_3d(383, 383, 383), "cuda", seed=7),
                     axis, exact)
