"""The 2D ``fused_bf16`` step (the line sweep on a bf16 d, x upcast:
cmcfs_tpu's adi2d.py:123-134) against cmcfs_tpu's own ``fused_bf16`` step
on the CPU (its line kernel in interpret mode): three steps of
test_torch_slice2d.py's ``run_both`` on the 2D lid cavity at 48 x 40 with
a FREE outflow side, num_local 2, exact, normalized parameters.  Each
call agrees within one bf16 ulp a cell (test_torch_line_sweep_bf16.py)
and a flipped ulp feeds the next sweep, so the fields are held to
2^-8 * max(1, max|state|); measured: equal, cell for cell.
"""
from test_torch_slice2d import run_both


def test_step2d_fused_bf16_matches_jax():
    run_both("fused_bf16", 2, True, nx=48, ny=40, atol=2.0 ** -8)
