"""The port's 2D ADI step against cmcfs_tpu's with backend ``pallas``:
materialized rows and the tridiag_rows solve, cmcfs_tpu's
``tridiag_pallas`` in interpret mode.  Three steps as in test_torch_slice2d.py (its fixture, bound and
reasons), at num_global 1 where a case says so: cmcfs_tpu's interpreter
takes about 5 s a step there, and the global loop, the same code on
every backend, runs at num_global 2 in test_torch_slice2d.py.
"""
import pytest

from test_torch_slice2d import run_both


@pytest.mark.parametrize("num_local, exact, num_global",
                         [(1, False, 1), (2, True, 2)])
def test_step_pallas_matches_jax(num_local, exact, num_global):
    run_both("pallas", num_local, exact, num_global)
