"""Parallel cyclic reduction (``cmcfs_tpu_torch/ops/pcr.py``) and the row
backend ``pcr`` against cmcfs_tpu, on the CPU.

* ``pcr_solve`` against ``ops/tridiag._solve_leading_axis_pcr`` on random
  diagonally dominant rows with identity rows mixed in, n in {1, 2, 7, 40,
  64, 255} (powers of two and not), both ``exact`` modes; and
  ``tridiag_solve(backend="pcr")`` against cmcfs_tpu's on every axis of a
  3D batch, with k right-hand sides on shared rows.  Within 4 ulps of
  max(1, max|x|): the same operations in the same order, but XLA may
  contract a mul-add into an FMA where eager PyTorch rounds twice
  (measured bitwise here).
* The 2D step with backend ``pcr`` against cmcfs_tpu's
  (test_torch_slice2d.py's fixture and 3 steps, bound 1e-5 * max|state|:
  the right-hand sides divide by dt and 2h on both sides, so the steps
  differ by contracted FMAs only).  The 3D step: test_torch_pcr_rows3d.py.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from cmcfs_tpu.ops import tridiag as jtd
from cmcfs_tpu_torch.ops import tridiag as ttd
from cmcfs_tpu_torch.ops import tridiag_rows as tr
from cmcfs_tpu_torch.ops.pcr import pcr_solve

from test_torch_slice2d import run_both

ULPS = 4 * float(np.finfo(np.float32).eps)


def _rows(shape, seed):
    """Diagonally dominant rows with identity rows mixed in."""
    rng = np.random.default_rng(seed)
    a = rng.uniform(-1, 1, shape).astype(np.float32)
    c = rng.uniform(-1, 1, shape).astype(np.float32)
    b = (np.abs(a) + np.abs(c) + rng.uniform(1, 3, shape)).astype(np.float32)
    d = rng.standard_normal(shape).astype(np.float32)
    ident = rng.random(shape) < 0.15
    a[ident], c[ident], b[ident] = 0, 0, 1
    return a, b, c, d


def _close(got, want):
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=ULPS * max(1.0, float(np.abs(want).max())))


@pytest.mark.parametrize("exact", [True, False])
@pytest.mark.parametrize("n", [1, 2, 7, 40, 64, 255])
def test_pcr_solve_matches_jax(n, exact):
    rows = _rows((n, 33), seed=n + exact)
    want = jtd._solve_leading_axis_pcr(*(jnp.asarray(t) for t in rows),
                                       exact)
    _close(pcr_solve(*(torch.tensor(t) for t in rows), axis=0, exact=exact),
           want)


@pytest.mark.parametrize("exact", [True, False])
@pytest.mark.parametrize("axis", [0, 1, 2])
def test_tridiag_solve_pcr_matches_jax(axis, exact):
    """k = 3 right-hand sides on one set of rows, as the 3D row path solves
    u, v and w; no kernel is launched (cmcfs_tpu's ``pcr`` is XLA ops)."""
    a, b, c, d = _rows((13, 11, 9), seed=20 + axis)
    d3 = np.stack([d, 2 * d, d[::-1].copy()])
    before = tr.launches.count
    got = ttd.tridiag_solve(*(torch.tensor(t) for t in (a, b, c, d3)),
                            axis=axis, exact=exact, backend="pcr")
    assert tr.launches.count == before
    for k in range(3):
        want = jtd.tridiag_solve(*(jnp.asarray(t) for t in (a, b, c, d3[k])),
                                 axis=axis, exact=exact, backend="pcr")
        _close(got[k], want)


@pytest.mark.parametrize("exact", [True, False])
@pytest.mark.parametrize("num_local", [1, 2])
def test_pcr_backend_step_2d_matches_jax(num_local, exact):
    run_both("pcr", num_local, exact)
