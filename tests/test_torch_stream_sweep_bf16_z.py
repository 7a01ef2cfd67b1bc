"""test_torch_stream_sweep_bf16.py's comparison on the Z direction
(reciprocal), through the 1<->2 swap cmcfs_tpu's stream path makes: one
bf16 stream iteration of the port against
``adi3d._solve_stream_fused(..., bf16=True)``, within one bf16 ulp a cell;
measured: no cell differs.
"""
from test_torch_stream_sweep_bf16 import check_stream


def test_stream_sweep_bf16_matches_pallas_z():
    check_stream(2, False)
