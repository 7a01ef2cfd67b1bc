"""The port's 2D ADI step against cmcfs_tpu's with backend ``pallas``: the
(num_local, exact) cases test_torch_slice2d_pallas.py leaves out, so the
backend runs at num_local 1 and 2 in both ``exact`` modes.  ``exact=False``
is where ``pallas`` differs from ``scan`` (its row 0 multiplies by the
reciprocal).  The fixture, bound and reasons of test_torch_slice2d.py;
cmcfs_tpu's ``tridiag_pallas`` in interpret mode (5-20 s a case), so these
cases live in a file of their own to keep each file under a minute.
"""
import pytest

from test_torch_slice2d import run_both


@pytest.mark.parametrize("num_local, exact, num_global",
                         [(1, True, 1), (2, False, 2)])
def test_step_pallas_matches_jax(num_local, exact, num_global):
    run_both("pallas", num_local, exact, num_global)
