"""The port's 3D row path (backends ``scan`` and ``pallas``: materialized
rows, one set for u, v and w solved in one call of the tridiag_rows
k-form and one for T, ``solve_with_cls``, on the kernel's plain version
on the CPU) against cmcfs_tpu's same backend.

* ``scan``: three steps on the lid cavity at 16x14x12 (nl 2) and on the
  FREE baffle with a hole at 20x12x12 (dual endpoints on X lines, the
  ``cls_b``/``take_b`` stitch; nl 1), both ``exact`` modes, ng=2.
* ``pallas``: cmcfs_tpu's ``tridiag_pallas`` in interpret mode takes
  ~10 s a step here, so one step at ng=1 nl=1 on the lid cavity in the
  reciprocal mode (the one where ``pallas`` differs from ``scan``: row 0).
* ``dispatch_report`` for both backends: no step pad, every direction
  "fallback", as cmcfs_tpu decides (its pad list is the fused one).

Fields within 1e-5 * max|state| and the divergence error within 1e-4
relative, the bounds and reasons of test_torch_dispatch3d.py.
"""
import numpy as np
import jax.numpy as jnp
import pytest

from cmcfs_tpu.core.params import FluidParams
from cmcfs_tpu.core.types import BCtype, NodeType
from cmcfs_tpu.geom.synthetic import lid_cavity_3d
from cmcfs_tpu.models import adi3d as jadi
from cmcfs_tpu.models import common3d as jc
from cmcfs_tpu_torch.models import adi3d as tadi
from cmcfs_tpu_torch.models import common3d as tc
from cmcfs_tpu_torch.models.common3d import from_jax_numpy, merge_ok
from cmcfs_tpu_torch.models.solver3d import AdiSolver3D
from cmcfs_tpu_torch.ops import line_sweep as ls
from cmcfs_tpu_torch.ops import tridiag_rows as tr

REL = 1e-5


class _Duals:
    def __init__(self, duals):
        self.cls_b = tuple(object() if d else None for d in duals)


def _case(baffle):
    grid = lid_cavity_3d(20, 12, 12) if baffle else lid_cavity_3d(16, 14, 12)
    if baffle:
        bf = np.zeros(grid.types.shape, dtype=bool)
        bf[10, 2:-2, 2:-2] = True
        grid.types[bf] = NodeType.BOUND
        grid.types[10, 5:7, 2:-2] = NodeType.IN
        grid.bc_temp[bf] = BCtype.FREE
    p = FluidParams.normalized(200.0, 0.72, 1.4)
    pa = jadi.ParamsArgs3D(*(jnp.float32(x) for x in (
        p.v_T, p.v_vis, p.t_vis, p.t_phi, grid.dx, grid.dy, grid.dz)))
    return jc.grid_arrays(grid), jc.init_state(grid), pa


def _run_both(backend, baffle, ng, nl, exact, steps):
    from jax.experimental.pallas import tpu as pltpu
    ga, cur, pa = _case(baffle)
    dt = jnp.float32(0.01)
    st, tga, tpa = from_jax_numpy(cur, ga, pa, "cpu")
    assert (tga.cls_b[0] is not None) == baffle
    j_cur = j_nxt = cur
    t_cur = t_nxt = st
    counts = (ls.launches.count, tr.launches.count)
    for _ in range(steps):
        with pltpu.force_tpu_interpret_mode():
            j_new, j_err = jadi.adi_timestep_3d(
                jc.update_boundaries(j_cur, ga),
                jc.update_boundaries(j_nxt, ga), ga, dt, ng, nl, pa,
                backend=backend, exact=exact)
        j_nxt, j_cur = j_cur, j_new
        t_new, t_err = tadi.adi_timestep_3d(
            tc.update_boundaries(t_cur, tga), tc.update_boundaries(t_nxt, tga),
            tga, dt, ng, nl, tpa, backend=backend, exact=exact,
            merge_ok=merge_ok(tga))
        t_nxt, t_cur = t_cur, t_new
        assert abs(float(t_err) - float(j_err)) <= 1e-4 * float(j_err)
    assert (ls.launches.count, tr.launches.count) == counts   # plain, CPU
    j_cur = [np.asarray(j) for j in j_cur]
    bound = REL * max(float(np.abs(j).max()) for j in j_cur)
    for j, t in zip(j_cur, t_cur):
        np.testing.assert_allclose(t.numpy(), j, rtol=0, atol=bound)


@pytest.mark.parametrize("exact", [True, False])
@pytest.mark.parametrize("baffle, nl", [(False, 2), (True, 1)])
def test_scan_step_matches_jax(baffle, nl, exact):
    _run_both("scan", baffle, 2, nl, exact, steps=3)


def test_pallas_step_matches_jax():
    _run_both("pallas", False, 1, 1, False, steps=1)


@pytest.mark.parametrize("backend", ["scan", "pallas"])
@pytest.mark.parametrize("shape", [(250, 250, 250), (384, 384, 384),
                                   (256, 256, 256), (16, 14, 12)])
def test_dispatch_report_rows(shape, backend):
    for nl in (1, 2, 3):
        for duals in ((False,) * 3, (True, False, False)):
            want = jadi.dispatch_report(shape, _Duals(duals), backend, nl,
                                        (True, True, True))
            got = tadi.dispatch_report(shape, duals, backend, nl,
                                       (True, True, True))
            assert got["pad"] is None and want["pad"] is None
            assert got["dirs"] == want["dirs"] == {
                "X": "fallback", "Y": "fallback", "Z": "fallback"}
            assert got["backend"] == want["backend"] == backend


@pytest.mark.parametrize("backend", ["scan", "pallas"])
def test_solver_accepts_row_backends(backend):
    assert AdiSolver3D(backend=backend, device="cpu").backend == backend
