"""The pair sweep's dual form (``ops/pair_sweep.pair_sweep`` with the dual
plane) against cmcfs_tpu on the FREE baffle (``tests/test_duals.py::
_free_baffled(16, 12, 12)``), on the CPU.

The baffle's FREE wall cells end one fluid run and start the next along X:
pass A gives them the BC1 role, pass B the BC0 role, and the solution takes
pass B inside the runs that start there.

* Against the ``scan`` path of ``adi3d._solve_direction_3d(0, ...)`` (the
  fallback's two-pass stitch), both ``exact`` modes, with and without the
  gmerge fold: 1e-6 absolute on fields of magnitude <= 1.2, as
  test_torch_pair_sweep.py (the pair sweep multiplies by 1/(2h) where the
  scan path divides, and XLA contracts FMAs).
* Against the Pallas pair kernel in interpret mode:
  test_torch_pair_sweep_dual_pallas.py.
* The dual plane (``models/common3d.dual_flags``) against
  ``sweep_common.decode_pk_dual`` of cmcfs_tpu's own packing, exactly.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from cmcfs_tpu.core.types import NodeType
from cmcfs_tpu.models import adi3d as jadi
from cmcfs_tpu.models import common3d as jc
from cmcfs_tpu.ops import sweep_common as jsc
from cmcfs_tpu_torch.geom.baffle import free_baffled
from cmcfs_tpu_torch.models import adi3d as tadi
from cmcfs_tpu_torch.models.common3d import (dual_flags, from_jax_numpy,
                                             grid_arrays, merge_ok)
from cmcfs_tpu_torch.ops import pair_sweep as ps

from test_duals import _free_baffled, _pa

ATOL = 1e-6
SHAPE = (16, 12, 12)


def baffle_case(seed=0):
    """(jax temp, rhs, out_prev, ga, pa) on the FREE baffle, seeded noise
    on IN cells, BOUND/VALVE cells at their grid values."""
    grid = _free_baffled(*SHAPE)
    ga = jc.grid_arrays(grid)
    cur = jc.init_state(grid)
    rng = np.random.default_rng(seed)
    is_in = np.asarray(ga.types) == NodeType.IN

    def noisy():
        return jc.State3D(*(jnp.asarray(np.where(
            is_in, np.asarray(f) + 0.1 * rng.standard_normal(f.shape),
            np.asarray(f)).astype(np.float32)) for f in cur))

    return noisy(), noisy(), noisy(), ga, _pa(grid)


def _stack(state):
    return torch.stack([torch.tensor(np.asarray(f)) for f in state])


def _port(temp, rhs, out, ga, pa, exact, gmerge):
    st, tga, tpa = from_jax_numpy(temp, ga, pa, "cpu")
    assert tga.dual_flags[0] is not None and merge_ok(tga)[0]
    before = (ps.launches.count, ps.dual_launches.count)
    got = ps.pair_sweep(torch.stack(tuple(st)), tga.cls_a[0], tga.bc_vel,
                        tga.bc_temp, _stack(rhs), _stack(out),
                        tadi._nl_scal(0, tpa, 0.01), 0, exact, gmerge,
                        tga.dual_flags[0])
    # CPU tensors: the plain version
    assert (ps.launches.count, ps.dual_launches.count) == before
    return got


def _close(got, want_o, want_t):
    o_t, t_t = got
    for k in range(4):
        np.testing.assert_allclose(o_t[k].numpy(), np.asarray(want_o[k]),
                                   rtol=0, atol=ATOL)
        np.testing.assert_allclose(t_t[k].numpy(), np.asarray(want_t[k]),
                                   rtol=0, atol=ATOL)


@pytest.mark.parametrize("gmerge", [False, True])
@pytest.mark.parametrize("exact", [True, False])
def test_dual_pair_sweep_matches_scan_stitch(exact, gmerge):
    temp, rhs, out, ga, pa = baffle_case()
    assert ga.cls_b[0] is not None
    t_j, o_j = jadi._solve_direction_3d(0, rhs, temp, out, ga,
                                        jnp.float32(0.01), 2, pa, "scan",
                                        exact)
    if gmerge:
        is_in = ga.types == NodeType.IN
        t_j = jc.State3D(*(jnp.where(is_in, (t + o) / 2.0, t)
                           for t, o in zip(t_j, o_j)))
    _close(_port(temp, rhs, out, ga, pa, exact, gmerge), o_j, t_j)


def test_dual_flags_match_decode_pk_dual():
    """The port's plane holds exactly the dual and take flags that
    cmcfs_tpu packs for its pair kernel (fused_sweep_nl: dual = cls_b !=
    cls_a), on every axis that keeps a pass B; the port's baffle geometry
    is cmcfs_tpu's test fixture."""
    grid = _free_baffled(*SHAPE)
    mine = free_baffled(*SHAPE)
    for name in ("types", "bc_vel", "bc_temp"):
        assert np.array_equal(getattr(mine, name), getattr(grid, name))
    jga = jc.grid_arrays(grid)
    tga = grid_arrays(mine, "cpu")
    kept = 0
    for ax in range(3):
        assert (tga.dual_flags[ax] is None) == (jga.cls_b[ax] is None)
        if jga.cls_b[ax] is None:
            continue
        kept += 1
        cls = jga.cls_a[ax]
        pk = jsc.pack_masks_dual(cls, jga.bc_vel, jga.bc_temp,
                                 (jga.cls_b[ax] != cls), jga.take_b[ax])
        c, bv, bt, dual, take = (np.asarray(x) for x in
                                 jsc.decode_pk_dual(pk))
        fl = tga.dual_flags[ax].numpy()
        assert fl.dtype == np.int8
        assert np.array_equal(fl & 1, dual.astype(np.int8))
        assert np.array_equal(fl >> 1, take.astype(np.int8))
        assert np.array_equal(c, np.asarray(cls))
        assert np.array_equal(dual_flags(tga.cls_a[ax], tga.cls_b[ax],
                                         tga.take_b[ax]), tga.dual_flags[ax])
    assert kept == 1 and (tga.dual_flags[0].numpy() & 1).any()


def test_dual_pair_sweep_no_fallback_off_cpu():
    """Tensors on a device other than the CPU never take the plain version:
    a device with no kernel raises, with duals as without."""
    temp, rhs, out, ga, pa = baffle_case()
    st, tga, tpa = from_jax_numpy(temp, ga, pa, "cpu")
    meta = [t.to("meta") for t in (torch.stack(tuple(st)), tga.cls_a[0],
                                   tga.bc_vel, tga.bc_temp, _stack(rhs),
                                   _stack(out), tga.dual_flags[0])]
    with pytest.raises(RuntimeError, match="no kernel"):
        ps.pair_sweep(*meta[:6], tadi._nl_scal(0, tpa, 0.01), 0, True, False,
                      meta[6])


def test_dual_pair_sweep_checks_flags():
    temp, rhs, out, ga, pa = baffle_case()
    st, tga, tpa = from_jax_numpy(temp, ga, pa, "cpu")
    args = (torch.stack(tuple(st)), tga.cls_a[0], tga.bc_vel, tga.bc_temp,
            _stack(rhs), _stack(out), tadi._nl_scal(0, tpa, 0.01), 0, True,
            False)
    for bad in (tga.dual_flags[0].to(torch.int32), tga.dual_flags[0][:-1]):
        with pytest.raises((TypeError, ValueError)):
            ps.pair_sweep(*args, bad)
