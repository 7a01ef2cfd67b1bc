"""The port's 2D ADI step against cmcfs_tpu's with backend ``fused_full``:
the stream sweep on both axes (the fixture is stream-ok), cmcfs_tpu's
``fused_sweep_stream`` merge2d mode in interpret mode.  Three steps as in test_torch_slice2d.py (its fixture, bound and
reasons), at num_global 1 where a case says so: cmcfs_tpu's interpreter
takes about 5 s a step there, and the global loop, the same code on
every backend, runs at num_global 2 in test_torch_slice2d.py.
"""
import pytest

from test_torch_slice2d import run_both


@pytest.mark.parametrize("num_local, exact, num_global",
                         [(1, False, 1), (2, True, 1)])
def test_step_stream_matches_jax(num_local, exact, num_global):
    run_both("fused_full", num_local, exact, num_global)
