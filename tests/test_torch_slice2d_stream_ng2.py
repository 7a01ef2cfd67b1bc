"""The port's 2D ADI step against cmcfs_tpu's with backend ``fused_full``
at num_global 2: the stream path across a global merge (copy on the first
global iteration, average on the second), at the bench's num_local 1 and
``exact=False``.  The fixture, bound and reasons of test_torch_slice2d.py;
cmcfs_tpu's ``fused_sweep_stream`` in interpret mode (about 25 s), in a
file of its own to keep each file under a minute.
"""
from test_torch_slice2d import run_both


def test_step_stream_across_global_merge_matches_jax():
    run_both("fused_full", 1, False, num_global=2)
