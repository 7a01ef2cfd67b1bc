"""The port's 2D ADI step against cmcfs_tpu's with backend ``fused_full``
(the stream sweep on both axes): the (num_local, exact) cases
test_torch_slice2d_stream.py leaves out, so the stream path runs at
num_local 1 and 2 in both ``exact`` modes.  The fixture, bound and
reasons of test_torch_slice2d.py; cmcfs_tpu's ``fused_sweep_stream``
merge2d mode in interpret mode (10-25 s a case), so these cases live in a
file of their own to keep each file under a minute.
"""
import pytest

from test_torch_slice2d import run_both


@pytest.mark.parametrize("num_local, exact, num_global",
                         [(1, True, 1), (2, False, 1)])
def test_step_stream_matches_jax(num_local, exact, num_global):
    run_both("fused_full", num_local, exact, num_global)
