"""The row solve's k-form: k right-hand sides on one set of rows
(``ops/tridiag_rows.tridiag_rows`` with d shaped (k,) + rows), the form
the 3D row path uses for u, v and w.

* Its plain version equals k single plain solves bit for bit, both
  ``exact`` modes and both row-0 forms, on every axis.
* On the velocities' rows of a 3D lid cavity, each of u, v and w matches
  cmcfs_tpu's ``tridiag_solve(..., backend="scan")`` within 1e-6 *
  max(1, max|x|): the same Thomas recurrence, which XLA may contract into
  FMAs where the port rounds every product (PARITY.md 7).
* ``models/adi3d._solve_rows`` (two solves a direction: u, v, w and T)
  equals the per-variable solves it replaced, bit for bit.

Small shapes and no Pallas interpret mode: the file runs in seconds.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from cmcfs_tpu.ops import tridiag as jtd
from cmcfs_tpu_torch.core.params import FluidParams
from cmcfs_tpu_torch.geom.synthetic import lid_cavity_3d
from cmcfs_tpu_torch.models import adi3d
from cmcfs_tpu_torch.models.common3d import (grid_arrays, init_state,
                                             update_boundaries)
from cmcfs_tpu_torch.ops import tridiag as ttd
from cmcfs_tpu_torch.ops import tridiag_rows as tr

REL = 1e-6


def _random_rows(seed, shape, k):
    """Diagonally dominant rows with identity rows mixed in, and k
    right-hand sides."""
    rng = np.random.default_rng(seed)
    a = rng.uniform(-1, 1, shape)
    c = rng.uniform(-1, 1, shape)
    b = np.abs(a) + np.abs(c) + rng.uniform(1, 3, shape)
    ident = rng.random(shape) < 0.15
    a[ident], c[ident], b[ident] = 0, 0, 1
    d = rng.standard_normal((k,) + shape)
    return [torch.tensor(t, dtype=torch.float32) for t in (a, b, c, d)]


@pytest.mark.parametrize("recip_row0", [True, False])
@pytest.mark.parametrize("exact", [True, False])
@pytest.mark.parametrize("axis", [0, 1, 2])
@pytest.mark.parametrize("k", [2, 3])
def test_k_form_equals_single_solves(k, axis, exact, recip_row0):
    a, b, c, d = _random_rows(10 * k + axis, (9, 7, 6), k)
    x = tr.tridiag_rows(a, b, c, d, axis=axis, exact=exact,
                        recip_row0=recip_row0)
    assert x.shape == d.shape
    for v in range(k):
        want = tr.tridiag_rows_ref(a, b, c, d[v], axis=axis, exact=exact,
                                   recip_row0=recip_row0)
        assert torch.equal(x[v], want)


def _velocity_rows(axis):
    """The velocities' rows (a, b, c) of one direction of a lid cavity
    with a noisy state, and the right-hand sides of u, v and w."""
    grid = lid_cavity_3d(12, 10, 9)
    ga = grid_arrays(grid, "cpu")
    pa = adi3d.make_params(FluidParams.normalized(200.0, 0.72, 1.4),
                           grid.dx, grid.dy, grid.dz)
    temp4 = torch.stack(tuple(update_boundaries(init_state(grid, "cpu"),
                                                ga)))
    rng = np.random.default_rng(axis)
    temp4 = temp4 + 0.05 * torch.tensor(
        rng.standard_normal(tuple(temp4.shape)), dtype=torch.float32)
    scal = adi3d._nl_scal(axis, pa, 0.01)
    d, d_bc = adi3d.fallback_rhs(axis, temp4, temp4, ga, pa, scal[2])
    d4 = adi3d.fold_d(d, d_bc, ga.cls_a[axis])
    abc = adi3d.row_coeffs(axis, temp4[axis], ga.cls_a[axis], ga, pa, scal,
                           0)
    return (ga, pa, scal, temp4), abc, d4


@pytest.mark.parametrize("exact", [True, False])
@pytest.mark.parametrize("axis", [0, 1, 2])
def test_velocities_match_jax_scan(axis, exact):
    _, abc, d4 = _velocity_rows(axis)
    x = tr.tridiag_rows(*abc, d4[:3].contiguous(), axis=axis, exact=exact,
                        recip_row0=False)
    for v in range(3):
        want = np.asarray(jtd.tridiag_solve(
            *(jnp.asarray(t.numpy()) for t in (*abc, d4[v])), axis=axis,
            exact=exact, backend="scan"))
        bound = REL * max(1.0, float(np.abs(want).max()))
        np.testing.assert_allclose(x[v].numpy(), want, rtol=0, atol=bound)


@pytest.mark.parametrize("backend", ["scan", "pallas"])
@pytest.mark.parametrize("exact", [True, False])
@pytest.mark.parametrize("axis", [0, 1, 2])
def test_solve_rows_equals_per_variable_solves(axis, exact, backend):
    (ga, pa, scal, temp4), _, d4 = _velocity_rows(axis)
    cls = ga.cls_a[axis]
    x = adi3d._solve_rows(axis, d4, temp4[axis], cls, ga, pa, scal, exact,
                          backend)
    for vi in range(4):
        abc = adi3d.row_coeffs(axis, temp4[axis], cls, ga, pa, scal, vi)
        want = ttd.tridiag_solve(*abc, d4[vi], axis=axis, exact=exact,
                                 backend=backend)
        assert torch.equal(x[vi], want)
