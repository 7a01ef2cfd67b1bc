"""The pair sweep's bf16 payload mode against cmcfs_tpu's on the Z
direction, reciprocal Thomas (X: test_torch_pair_sweep_bf16.py, Y:
test_torch_pair_sweep_bf16_y.py), against
``adi3d._solve_nl_fused(..., bf16=True)`` in interpret mode, within one
bf16 ulp a cell (tests/torch_bf16.py).  Measured: 1 cell of out of 34,560
one ulp apart, tn none.
"""
from cmcfs_tpu_torch.ops import pair_sweep as ps

from test_torch_pair_sweep_bf16 import check_pair


def test_pair_sweep_bf16_matches_pallas_pair_kernel_z():
    check_pair(ps.pair_sweep, ps.bf16_launches, 2, False, False)
