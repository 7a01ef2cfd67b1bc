"""The port's stream sweep against cmcfs_tpu's Pallas stream kernel on the
Z direction, through the 1<->2 swap as adi3d does it (``exact=False``):
the third case of test_torch_stream_sweep.py, in a file of its own to keep
each file's interpreted tracing under a minute.  Fixture and tolerance as
there (1e-6 absolute).
"""
from test_torch_stream_sweep import check_axis


def test_stream_sweep_matches_pallas_z():
    check_axis(2, False)
